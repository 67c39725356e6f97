"""Mamba2 (SSD) block, zamba2's backbone.

Port of ``src/repro/models/mamba2.py``.  Chunked state-space-duality form:
the sequence is cut into chunks of Q tokens; within a chunk the recurrence
is dense masked products, and only the small per-chunk state recurrence
runs as a loop (the reference's ``lax.scan``; a `loops.scan` marked for
the dry run).  Decode is the O(1)
recurrent update on the state [B, H, P, N].

The reference writes the intra-chunk term as one three-operand einsum; here
it is ``cb (.) L`` followed by one batched product over (b, c, h), so the
largest transients are L and its exponent ([B, nc, Q, Q, H] f32), never a
``[B, nc, Q, Q, H, P]`` product.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, loops


class MambaCache(NamedTuple):
    state: torch.Tensor     # [B, H, P, N] f32 (stacked: [L, B, ...])
    conv: torch.Tensor      # [B, W-1, D_inner + 2N] rolling conv window

    @staticmethod
    def init(batch: int, cfg: ModelConfig, dtype, device=None,
             layers_: tuple = (), heads: int = 0) -> "MambaCache":
        """Zeros; `layers_` = (L,) stacks them per layer; `heads`: the
        heads (and their x channels) held (default all; a model shard's
        own on a mesh, beside every B/C channel)."""
        h, p, n = heads or cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        d_conv = h * p + 2 * n
        lead = tuple(layers_)
        return MambaCache(
            state=torch.zeros((*lead, batch, h, p, n), device=device),
            conv=torch.zeros((*lead, batch, cfg.ssm_conv_width - 1, d_conv),
                             dtype=dtype, device=device))


class Mamba(nn.Module):
    """The reference's `mamba_init` leaves: w_x [d, di], w_bc [d, 2N], w_z
    [d, di], w_dt [d, H], conv_x [W, di], conv_bc [W, 2N] (drawn by
    `lm.init_params`, the convs scaled by 0.1; held in ``cfg.dtype``),
    A_log (f32, at 0), D (at 1), dt_bias (at 0), norm [di] (at 1),
    out_proj [di, d]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, n, h = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                       cfg.ssm_heads)
        dt = layers.torch_dtype(cfg.dtype)
        w = cfg.ssm_conv_width
        for name, shape in (("w_x", (d, di)), ("w_bc", (d, 2 * n)),
                            ("w_z", (d, di)), ("w_dt", (d, h)),
                            ("conv_x", (w, di)), ("conv_bc", (w, 2 * n))):
            setattr(self, name, layers.param(
                torch.empty(shape, dtype=dt, device=device)))
        for name, value, size in (("A_log", 0.0, h), ("D", 1.0, h),
                                  ("dt_bias", 0.0, h), ("norm", 1.0, di)):
            setattr(self, name, layers.param(
                torch.full((size,), value, device=device)))
        self.out_proj = layers.param(
            torch.empty((di, d), dtype=dt, device=device))


def _split_proj(p: Mamba, x):
    dt_ = x.dtype
    return tuple(x @ w.to(dt_) for w in (p.w_x, p.w_bc, p.w_z, p.w_dt))


def _causal_conv(xbc, conv_w, carry=None):
    """Depthwise causal conv1d of width W; carry [B, W-1, C] for decode.
    Returns (silu(out), the last W-1 inputs)."""
    w = conv_w.shape[0]
    if carry is not None:
        xin = torch.cat([carry.to(xbc.dtype), xbc], dim=1)
    else:
        xin = F.pad(xbc, (0, 0, w - 1, 0))
    s = xbc.shape[1]
    out = sum(xin[:, i: i + s, :] * conv_w[i] for i in range(w))
    return layers.silu(out), xin[:, -(w - 1):, :]


def _ssd_chunked(xh, dt, a_log, b, c, chunk: int):
    """Chunked SSD scan.

    xh [B,S,H,P], dt [B,S,H] (softplus'd), b,c [B,S,N] -> y [B,S,H,P] f32,
    final state [B,H,P,N] f32.
    """
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"an SSD sequence of {s} tokens is not a whole "
                         f"number of {chunk}-token chunks")

    A = -torch.exp(a_log)                                  # [H]
    da = dt * A                                            # [B,S,H] (<= 0)
    xdt = xh * dt[..., None]                               # f32

    def r(t):  # [B,S,...] -> [B,nc,Q,...]
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    da_c, xdt_c, b_c, c_c = r(da), r(xdt), r(b.float()), r(c.float())
    cum = torch.cumsum(da_c, dim=2)                        # [B,nc,Q,H]
    total = cum[:, :, -1]                                  # [B,nc,H]

    # ---- intra-chunk (dense, causal-masked) ----
    # L[q,t] = exp(cum_q - cum_t) for q >= t.  The mask goes in before the
    # exponent: above the diagonal cum_q - cum_t > 0 grows with the chunk,
    # and exp's overflow there, masked after it as the reference masks it,
    # makes the backward 0 x inf = NaN (the same values forward)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,Q,Q,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    L = torch.exp(torch.where(causal[:, :, None], diff, float("-inf")))
    del diff
    cb = c_c @ b_c.transpose(-1, -2)                       # [B,nc,Q,Q]
    m = (cb[..., None] * L).permute(0, 1, 4, 2, 3)         # [B,nc,H,Q,Q]
    del L
    xdt_h = xdt_c.permute(0, 1, 3, 2, 4)                   # [B,nc,H,Q,P]
    y_intra = (m @ xdt_h).permute(0, 1, 3, 2, 4)           # [B,nc,Q,H,P]
    del m

    # ---- chunk summary states ----
    decay_to_end = torch.exp(total[:, :, None, :] - cum)   # [B,nc,Q,H]
    xd = (xdt_c * decay_to_end[..., None]).permute(0, 1, 3, 4, 2)
    s_chunk = xd @ b_c[:, :, None]                         # [B,nc,H,P,N]

    # ---- inter-chunk recurrence (a loop over nc) ----
    def step(ci, s_prev):
        return (s_prev * torch.exp(total[:, ci])[:, :, None, None]
                + s_chunk[:, ci]), s_prev

    s_prev, s_prevs = loops.scan(
        "mamba2.chunks", step,
        torch.zeros((bsz, h, p, n), device=xh.device), nc)
    s_prevs = torch.stack(s_prevs, dim=1)                  # [B,nc,H,P,N]

    # ---- inter-chunk contribution ----
    y_inter = (c_c[:, :, None] @ s_prevs.transpose(-1, -2))  # [B,nc,H,Q,P]
    y_inter = y_inter.permute(0, 1, 3, 2, 4) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, s_prev


def mamba_apply(p: Mamba, x, cfg: ModelConfig, *, mode: str,
                cache: Optional[MambaCache] = None, chunk: int = 256):
    """x [B,S,D] -> (y [B,S,D], cache').  train/prefill share a path
    (prefill returns the final state and conv window, train None); decode
    takes one token against `cache`."""
    yg, new_cache = mamba_gated(p, x, cfg, mode=mode, cache=cache,
                                chunk=chunk)
    return mamba_out(p, yg, cfg, x.dtype), new_cache


def mamba_gated(p: Mamba, x, cfg: ModelConfig, *, mode: str,
                cache: Optional[MambaCache] = None, chunk: int = 256):
    """The mixer up to its gated RMSNorm: (the SSD output times the silu
    gate, f32 [B,S,di], cache').  On a mesh `p` is a model shard's: w_x,
    w_z and w_dt by columns over its whole heads, conv_x/norm and
    A_log/D/dt_bias sliced to its channels and heads, w_bc and conv_bc
    whole (every shard computes all of B/C); the output is its slice of
    the channels and the cache its heads, its x channels and all B/C."""
    dt_ = x.dtype
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    di, h = p.w_x.shape[-1], p.w_dt.shape[-1]
    xs, bc, z, dt = _split_proj(p, x)
    dt = F.softplus(dt.float() + p.dt_bias)

    if mode in ("train", "prefill"):
        xs, carry_x = _causal_conv(xs, p.conv_x.to(dt_))
        bc, carry_bc = _causal_conv(bc, p.conv_bc.to(dt_))
        b, c = bc[..., :n], bc[..., n:]
        xh = xs.reshape(*xs.shape[:-1], h, hd)
        y, s_final = _ssd_chunked(xh, dt, p.A_log, b, c,
                                  min(chunk, xh.shape[1]))
        y = y + p.D.float()[:, None] * xh.float()
        new_cache = None
        if mode == "prefill":
            new_cache = MambaCache(state=s_final,
                                   conv=torch.cat([carry_x, carry_bc], -1))
    elif mode == "decode" and cache is not None:
        xs, carry_x = _causal_conv(xs, p.conv_x.to(dt_), cache.conv[..., :di])
        bc, carry_bc = _causal_conv(bc, p.conv_bc.to(dt_),
                                    cache.conv[..., di:])
        b, c = bc[:, 0, :n].float(), bc[:, 0, n:].float()
        xh = xs.reshape(*xs.shape[:-1], h, hd)             # [B,1,H,P]
        da = torch.exp(dt[:, 0] * -torch.exp(p.A_log))     # [B,H]
        xdt = (xh[:, 0] * dt[:, 0, :, None]).float()       # [B,H,P]
        s_new = (cache.state * da[:, :, None, None]
                 + xdt[..., None] * b[:, None, None, :])
        y = torch.einsum("bn,bhpn->bhp", c, s_new)
        y = (y + p.D[:, None] * xh[:, 0].float())[:, None]
        new_cache = MambaCache(state=s_new,
                               conv=torch.cat([carry_x, carry_bc], -1))
    else:
        raise ValueError(f"mode {mode!r} needs a cache to decode")
    y = y.reshape(*x.shape[:-1], di).to(dt_)
    # the gated product enters the norm unrounded (XLA fuses the two)
    g = F.silu(z.float()).to(dt_).float()
    return y.float() * g, new_cache


def mamba_out(p: Mamba, yg, cfg: ModelConfig, dtype, var=None):
    """The gated RMSNorm over `mamba_gated`'s output, then out_proj, in
    `dtype`.  `var`: the mean square over all of d_inner, where `yg` is a
    model shard's slice of the channels (the sum over 'model' of each
    slice's sum of squares, over d_inner); the result is then the shard's
    partial sum through its out_proj rows."""
    if var is None:
        y = layers.rms_norm(yg, p.norm, cfg.norm_eps, dtype=dtype)
    else:
        y = (yg * torch.rsqrt(var + cfg.norm_eps) * p.norm.float()).to(dtype)
    return y @ p.out_proj.to(dtype)
