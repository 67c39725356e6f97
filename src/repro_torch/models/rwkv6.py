"""RWKV6 "Finch" block: linear attention with data-dependent per-channel decay.

Port of ``src/repro/models/rwkv6.py``, with its approximations (static
per-channel token-shift mixes and a direct decay projection in place of
the ddlerp LoRA).  The recurrence is exact:

  S_t = diag(w_t) S_{t-1} + k_t^T v_t
  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Prefill, train and decode use the chunked GEMM form: per chunk of CHUNK
tokens, SUB-token blocks chained through the state, each a few dense
products with the separated decay exponents (all <= 1 except e^{-b_tau},
clipped at EXP_CLIP nats; RATE_CAP keeps the clip from binding).  The
reference's ``lax.scan`` over chunks, and the cascade of SUB blocks, are
`loops.scan` loops here (marked for the dry run).  The exact
unrolled recurrence (`_wkv_chunk`) is the correctness oracle.

The reference asserts that a chunk longer than SUB is a whole number of
SUB blocks; the chunk is ``min(CHUNK, max(8, S))``, so a sequence of
16 < S < 64 tokens with S % 16 != 0 is refused, here with a ValueError.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, loops

UNROLL = 8          # exact-path chunk (oracle)
CHUNK = 64          # GEMM-path outer chunk (state I/O boundary)
SUB = 16            # separated-GEMM sub-block inside a chunk
EXP_CLIP = 80.0     # nats; fp32 overflows at ~88.7
RATE_CAP = 5.0      # max decay nats/token: with SUB = 16 the separated
#                     exponent range is <= 75 nats < EXP_CLIP


class RWKVCache(NamedTuple):
    state: torch.Tensor     # [B, H, K, V] f32, f64 in a float64 model
    #                         (stacked: [L, B, ...])
    x_att: torch.Tensor     # [B, D] last token (time-mix shift)
    x_ffn: torch.Tensor     # [B, D] last token (channel-mix shift)

    @staticmethod
    def init(batch: int, cfg: ModelConfig, dtype, device=None,
             layers_: tuple = ()) -> "RWKVCache":
        """Zeros; `layers_` = (L,) stacks them per layer."""
        h = cfg.d_model // cfg.ssm_head_dim
        hd = cfg.ssm_head_dim
        lead = tuple(layers_)
        sdt = torch.float64 if dtype == torch.float64 else torch.float32
        return RWKVCache(
            state=torch.zeros((*lead, batch, h, hd, hd), dtype=sdt,
                              device=device),
            x_att=torch.zeros((*lead, batch, cfg.d_model), dtype=dtype,
                              device=device),
            x_ffn=torch.zeros((*lead, batch, cfg.d_model), dtype=dtype,
                              device=device))


class RWKV(nn.Module):
    """The reference's `rwkv_init` leaves: the token-shift mixes (f32, at
    0.5), wr/wk/wv/wg/ww/wo [d, d], w_bias (f32, at -2), the bonus u [H,
    hd] (f32, at 0), ln_x (f32, at 1); the channel mix cmix_r/cmix_k (at
    0.5), cwr [d, d], cwk [d, f], cwv [f, d].  Matrices are drawn by
    `lm.init_params` (ww scaled by 0.1) and held in ``cfg.dtype``; u is
    used in f32 and stays f32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.ssm_head_dim
        dt = layers.torch_dtype(cfg.dtype)

        def full(value, shape=(d,)):
            return layers.param(torch.full(shape, value, device=device))

        def mat(shape):
            return layers.param(torch.empty(shape, dtype=dt, device=device))

        for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
            setattr(self, name, full(0.5))
        for name in ("wr", "wk", "wv", "wg", "ww"):
            setattr(self, name, mat((d, d)))
        self.w_bias = full(-2.0)
        self.u = full(0.0, (d // hd, hd))
        self.ln_x = full(1.0)
        self.wo = mat((d, d))
        self.cmix_r = full(0.5)
        self.cmix_k = full(0.5)
        self.cwr = mat((d, d))
        self.cwk = mat((d, cfg.d_ff))
        self.cwv = mat((cfg.d_ff, d))


def _shift(x, x_prev):
    """token shift: the previous token in front, the last dropped."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _wkv_chunk(state, r, k, v, w, u):
    """The recurrence one step at a time (the exact oracle).

    state [B,H,K,V]; r,k,v [B,T,H,hd]; w [B,T,H,K] decay in (0,1).
    Returns (state', y [B,T,H,V]).
    """
    ys = []
    for t in range(r.shape[1]):
        kt, vt, rt, wt = k[:, t], v[:, t], r[:, t], w[:, t]   # [B,H,hd]
        kv = kt[..., :, None] * vt[..., None, :]              # outer product
        y = torch.einsum("bhk,bhkv->bhv", rt,
                         state + u[None, :, :, None] * kv)
        state = wt[..., None] * state + kv
        ys.append(y)
    return state, torch.stack(ys, dim=1)


def _wkv_sub_gemm(state, r, k, v, w, u):
    """Up to SUB recurrent steps as dense GEMMs.

    state [B,H,K,V]; r,k,v [B,Ls,H,hd]; w [B,Ls,H,K].  Exact for decays
    admitted by RATE_CAP (exponent range <= (SUB-1)*RATE_CAP < EXP_CLIP).
    """
    l = r.shape[1]
    # floor the per-token log-decay (1e-38 is subnormal in f32; past -45
    # nats a token is total forgetting anyway)
    lb = torch.clamp(torch.log(torch.clamp(w, min=1e-30)), min=-45.0)
    bc = torch.cumsum(lb, dim=1)                        # inclusive
    pre = bc - lb                                       # exclusive (b_{t-1})

    rt = r * torch.exp(pre)                             # factors <= 1
    kt = k * torch.exp(torch.clamp(-bc, max=EXP_CLIP))  # growing; clipped
    ks = k * torch.exp(bc[:, -1:] - bc)                 # decay-to-end <= 1

    # intra-block scores [B,H,Ls,Ls], strictly causal (tau < t)
    scores = torch.einsum("bthk,bshk->bhts", rt, kt)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.where(mask, scores, 0.0)
    y = torch.einsum("bhts,bshv->bthv", scores, v)
    # bonus diagonal: (r_t . (u (.) k_t)) v_t
    dcoef = (r * u * k).sum(-1)                         # [B,Ls,H]
    y = y + dcoef[..., None] * v
    # inter-block readout from the carried state
    y = y + torch.einsum("bthk,bhkv->bthv", rt, state)
    # state update: decay to the block's end + the decayed-key contraction
    state = (torch.exp(bc[:, -1])[..., None] * state
             + torch.einsum("bshk,bshv->bhkv", ks, v))
    return state, y


def _wkv_chunk_gemm(state, r, k, v, w, u):
    """A chunk as a cascade of SUB-token GEMM blocks chained exactly
    through the state (all factors <= 1)."""
    l = r.shape[1]
    if l <= SUB:
        return _wkv_sub_gemm(state, r, k, v, w, u)
    if l % SUB:
        raise ValueError(f"an RWKV chunk of {l} tokens is not a whole number "
                         f"of {SUB}-token blocks (a sequence of 16 < S < "
                         f"{CHUNK} tokens must be a multiple of {SUB})")
    def sub_block(i, state):
        sl = slice(i * SUB, (i + 1) * SUB)
        return _wkv_sub_gemm(state, r[:, sl], k[:, sl], v[:, sl], w[:, sl], u)

    state, ys = loops.scan("rwkv6.sub_blocks", sub_block, state, l // SUB)
    return state, torch.cat(ys, dim=1)


def time_mix(p: RWKV, x, cfg: ModelConfig, state, x_prev):
    """x [B,S,D]; state [B,H,K,V]; x_prev [B,D] -> (y, state', x_last)."""
    dt_ = x.dtype
    d, hd = cfg.d_model, cfg.ssm_head_dim
    h = d // hd
    b, s, _ = x.shape
    xs = _shift(x, x_prev)

    def proj(name, w):
        m = getattr(p, f"mix_{name}").to(dt_)
        return (x * m + xs * (1 - m)) @ w.to(dt_)

    r, k, v, g = (proj(n, getattr(p, f"w{n}")) for n in "rkvg")
    wln = proj("w", p.ww)
    # data-dependent decay (Finch): w = exp(-exp(ww + bias)) in (0, 1), the
    # per-token decay rate capped at RATE_CAP nats
    w = torch.exp(-torch.clamp(torch.exp(layers.upcast(wln) + p.w_bias),
                               max=RATE_CAP))

    def heads(t):
        return layers.upcast(t).reshape(b, s, h, hd)
    r_, k_, v_, w_ = heads(r), heads(k), heads(v), heads(w)

    clen = min(CHUNK, max(8, s))
    nc = -(-s // clen)
    pad = nc * clen - s
    if pad:
        r_, k_, v_ = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r_, k_, v_))
        w_ = F.pad(w_, (0, 0, 0, 0, 0, pad), value=1.0)
    def chunk(i, state):
        sl = slice(i * clen, (i + 1) * clen)
        return _wkv_chunk_gemm(state, r_[:, sl], k_[:, sl], v_[:, sl],
                               w_[:, sl], p.u)

    state, ys = loops.scan("rwkv6.chunks", chunk, state, nc)
    y = torch.cat(ys, dim=1)[:, :s]
    # GroupNorm over each head (RWKV6's ln_x)
    ln = p.ln_x.float().reshape(h, hd)
    ym = y - y.mean(-1, keepdim=True)
    var = (ym * ym).mean(-1, keepdim=True)
    y = ym * torch.rsqrt(var + cfg.norm_eps) * ln
    gh = F.silu(layers.upcast(g)).reshape(b, s, h, hd)
    y = (y * gh).to(dt_)
    out = y.reshape(b, s, d) @ p.wo.to(dt_)
    return out, state, x[:, -1, :]


def channel_mix(p: RWKV, x, cfg: ModelConfig, x_prev):
    dt_ = x.dtype
    xs = _shift(x, x_prev)
    mr, mk = p.cmix_r.to(dt_), p.cmix_k.to(dt_)
    xr = x * mr + xs * (1 - mr)
    xk = x * mk + xs * (1 - mk)
    r = layers.sigmoid(xr @ p.cwr.to(dt_))
    k = torch.square(torch.relu(xk @ p.cwk.to(dt_)))
    v = k @ p.cwv.to(dt_)
    return r * v, x[:, -1, :]


def rwkv_block_apply(p: RWKV, x, cfg: ModelConfig, *, mode: str,
                     cache: RWKVCache = None):
    """The time-mix sublayer on `cache`'s state and shift (the pre-norms
    and the channel mix are wired in `lm`).  Returns (y_att, cache with
    the new state and time-mix shift)."""
    if cache is None:
        cache = RWKVCache.init(x.shape[0], cfg, x.dtype, x.device)
    y_att, state, x_att = time_mix(p, x, cfg, cache.state, cache.x_att)
    return y_att, cache._replace(state=state, x_att=x_att)
