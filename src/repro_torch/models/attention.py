"""Attention: chunked (flash-style) prefill/train + KV-cached decode.

Port of ``src/repro/models/attention.py``.  Prefill/train never forms the
[S, S] score matrix: a loop over KV chunks carries online-softmax stats
(m, l, acc), with the reference's chunk size.  Supports GQA, sliding
windows (gemma2 local layers), logit softcapping, causal masking and
M-RoPE (qwen2-vl), and the enc-dec family's cross-attention over the
encoder's K/V.

The reference multiplies bf16 operands with ``preferred_element_type=f32``;
PyTorch's ``bf16 @ bf16`` returns bf16, so the score and P·V products here
take operands upcast to f32 (exact for bf16 values) and sum in f32, and
``p`` is rounded to the cache dtype first, as in the reference.

Decode writes the new token's K/V rows in place into the stacked caches
(the reference donates them).

Sharding: on a mesh each 'model' shard runs these functions on its own
q heads (``wq``/``wo`` cut over heads), and on its own kv heads when they
divide over the axis; otherwise it holds every kv head (its cache too)
and attends with the ones its q heads group onto (`local_kv_heads`).
`KVCache.shardit` places a whole cache by the same policy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, sharding

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, S_max, KVH, Dh] (stacked: [L, B, ...])
    v: torch.Tensor

    def shardit(self) -> "KVCache":
        """The cache placed on the current mesh (`sharding.Placed` K and V;
        itself without a mesh): kv heads over 'model' when they divide,
        the batch over the data axes when it divides.  Where the reference
        falls back to the sequence axis (kv heads that do not divide: over
        'model'; a batch that does not: over the data axes) the port
        replicates instead: a placement, not a different result."""
        mesh = sharding.current_mesh()
        if mesh is None:
            return self
        spec = kv_placement(mesh, self.k.shape)
        return KVCache(k=sharding.place(self.k, spec, mesh),
                       v=sharding.place(self.v, spec, mesh))


def kv_placement(mesh, shape) -> sharding.Placement:
    """`KVCache.shardit`'s placement of a cache [L?, B, S, KVH, Dh]."""
    off = len(shape) - 4
    return (None,) * off + sharding.placement(
        shape[off:], "batch", None, "model", None, mesh=mesh)


def local_kv_heads(heads: int, kv_heads: int, shard: int,
                   shards: int) -> slice:
    """The kv heads that model shard `shard` of `shards` attends with when
    it holds its block of the q heads and every kv head."""
    hl = heads // shards
    q0, g = shard * hl, heads // kv_heads
    if hl % g == 0:
        return slice(q0 // g, (q0 + hl) // g)
    if g % hl == 0:
        return slice(q0 // g, q0 // g + 1)
    raise ValueError(f"{hl} q heads a shard do not group onto kv heads "
                     f"({heads} over {kv_heads})")


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq [d, h, dh], wk/wv [d, kvh, dh], wo [h, dh, d]; q_norm/k_norm [dh]
    (f32, at ones) with qk_norm.  The reference's `attn_init`: the
    projections are drawn by `lm.init_params` (each normal/sqrt(shape[0]);
    wo's fan-in is its head axis, as in the reference)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, kvh, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        dt = layers.torch_dtype(cfg.dtype)
        for name, shape in (("wq", (d, h, dh)), ("wk", (d, kvh, dh)),
                            ("wv", (d, kvh, dh)), ("wo", (h, dh, d))):
            setattr(self, name, layers.param(
                torch.empty(shape, dtype=dt, device=device)))
        if cfg.qk_norm:
            self.q_norm = layers.param(torch.ones((dh,), device=device))
            self.k_norm = layers.param(torch.ones((dh,), device=device))


def _proj(x, w):
    """einsum("...d,dhk->...hk", x, w) in x's dtype."""
    d = w.shape[0]
    return (x @ w.to(x.dtype).reshape(d, -1)).unflatten(-1, w.shape[1:])


def _project_qkv(p: Attention, x, cfg: ModelConfig, positions,
                 mrope_pos=None):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = layers.rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.mrope_sections and mrope_pos is not None:
        q = layers.apply_mrope(q, mrope_pos, cfg.mrope_sections,
                               cfg.rope_theta)
        k = layers.apply_mrope(k, mrope_pos, cfg.mrope_sections,
                               cfg.rope_theta)
    elif positions is not None:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, o):
    """einsum("...hk,hkd->...d", o, wo) in o's dtype."""
    return o.flatten(-2) @ p.wo.to(o.dtype).reshape(-1, p.wo.shape[-1])


# ---------------------------------------------------------------------------
# chunked flash attention (prefill / train)
# ---------------------------------------------------------------------------

def _softcap(logits, cap: float):
    return cap * torch.tanh(logits / cap) if cap else logits


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, chunk: int = 1024) -> torch.Tensor:
    """q [B,Sq,H,Dh]; k,v [B,Sk,KVH,Dh] -> [B,Sq,H,Dh].

    Online softmax over KV chunks; GQA via head-group reshape.
    `window > 0` = sliding-window (local) attention over the last `window`
    keys.  The reference pads the keys to whole chunks and masks the pad
    (``kpos < sk``); the last chunk here simply stops at Sk.
    """
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"{h} query heads over {kvh} kv heads")
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh).float()
    scale = dh ** -0.5
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, sq, kvh, g), NEG_INF, device=q.device)
    l = torch.zeros((b, sq, kvh, g), device=q.device)
    acc = torch.zeros((b, sq, kvh, g, dh), device=q.device)
    for c0 in range(0, sk, chunk):
        kci, vci = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kpos = c0 + torch.arange(kci.shape[1], device=q.device)  # absolute
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kci.float()) * scale
        s = _softcap(s, softcap)
        delta = qpos[:, None] - kpos[None, :]
        mask = (delta >= 0) if causal else torch.ones_like(delta,
                                                          dtype=torch.bool)
        if window > 0:            # <= 0: global attention
            mask = mask & (delta < window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vci.dtype).float(), vci.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# cached decode attention (one new token)
# ---------------------------------------------------------------------------

def decode_attention(q, cache: KVCache, pos, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """q [B,1,H,Dh]; cache K/V [B,Smax,KVH,Dh]; pos int[B] = current index.

    Scores the single query against the whole (masked) cache.
    """
    b, _, h, dh = q.shape
    _, smax, kvh, _ = cache.k.shape
    g = h // kvh
    qg = q.reshape(b, kvh, g, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, cache.k.float()) * (dh ** -0.5)
    s = _softcap(s, softcap)
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, :] <= pos[:, None]                    # causal vs cache
    if window > 0:
        mask = mask & (kpos[None, :] > (pos[:, None] - window))
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(cache.v.dtype).float(),
                     cache.v.float())
    return o.reshape(b, 1, h, dh).to(q.dtype)


def cache_update(cache: KVCache, k_new, v_new, pos) -> KVCache:
    """Write k/v [B,1,KVH,Dh] at per-row positions pos int[B], in place."""
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    pos = pos.long()
    cache.k[rows, pos] = k_new[:, 0]
    cache.v[rows, pos] = v_new[:, 0]
    return cache


# ---------------------------------------------------------------------------
# block-level entry point
# ---------------------------------------------------------------------------

def _heads(t, sel: Optional[slice]):
    return t if sel is None else t[:, :, sel]


def self_attention(p: Attention, x, cfg: ModelConfig, *, mode: str,
                   positions=None, mrope_pos=None, cache: KVCache = None,
                   pos=None, window: int = 0, chunk: int = 1024,
                   causal: bool = True, kv_heads: Optional[slice] = None):
    """mode: 'train' | 'prefill' | 'decode'.  `mrope_pos` [B,S,3] (with
    ``cfg.mrope_sections``) rotates by M-RoPE in place of `positions`.
    `kv_heads`: the kv heads to attend with, of those `p` projects (a
    model shard that holds every kv head; `local_kv_heads`); the cache
    keeps them all.

    prefill returns (out, KVCache of the whole prompt); decode writes the
    new token into `cache` at per-row `pos` and returns (out, cache).
    """
    softcap = cfg.attn_logit_softcap
    q, k, v = _project_qkv(p, x, cfg, positions, mrope_pos)
    if mode in ("train", "prefill"):
        o = flash_attention(q, _heads(k, kv_heads), _heads(v, kv_heads),
                            causal=causal, window=window, softcap=softcap,
                            chunk=chunk)
        return _out_proj(p, o), (KVCache(k=k, v=v) if mode == "prefill"
                                 else None)
    if mode != "decode" or cache is None or pos is None:
        raise ValueError(f"mode {mode!r} needs a cache and pos to decode")
    cache = cache_update(cache, k, v, pos)
    o = decode_attention(q, KVCache(_heads(cache.k, kv_heads),
                                    _heads(cache.v, kv_heads)), pos,
                         window=window, softcap=softcap)
    return _out_proj(p, o), cache


def cross_attention(p: Attention, x, enc_kv: KVCache, cfg: ModelConfig,
                    enc_len=None, kv_heads: Optional[slice] = None):
    """Decoder cross-attention over the encoder's K/V [B, Sk, KVH, Dh] (no
    RoPE, no q/k norm, as in the reference); `enc_len` int[B] masks the
    keys at and past each row's length.  Scores and softmax in f32.
    `kv_heads`: the kv heads of `enc_kv` to attend with (a model shard
    that holds every kv head; `local_kv_heads`), as in `self_attention`."""
    if kv_heads is not None:
        enc_kv = KVCache(enc_kv.k[:, :, kv_heads], enc_kv.v[:, :, kv_heads])
    q = _proj(x, p.wq)
    b, sq, h, dh = q.shape
    kvh = enc_kv.k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, enc_kv.k.float()) * (dh ** -0.5)
    if enc_len is not None:
        kmask = (torch.arange(enc_kv.k.shape[1], device=x.device)[None, :]
                 < enc_len[:, None])
        s = torch.where(kmask[:, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", pr.to(enc_kv.v.dtype).float(),
                     enc_kv.v.float())
    return _out_proj(p, o.reshape(b, sq, h, dh).to(x.dtype))


def cross_kv(p: Attention, enc_out, cfg: ModelConfig) -> KVCache:
    """The encoder output's K/V [B, Sk, KVH, Dh] in its dtype."""
    return KVCache(k=_proj(enc_out, p.wk), v=_proj(enc_out, p.wv))
