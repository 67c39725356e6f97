"""The model stack: init / train-forward / prefill / decode, dense family.

Port of ``src/repro/models/lm.py``.  The reference scans one traced body
over stacked layer weights; here the layers are an ``nn.ModuleList`` run
by a plain loop, the per-layer sliding windows (gemma2's local/global
alternation) a list of ints.  The dense block carries every flag of the
dense archs: ``qk_norm``, ``parallel_block``, ``post_norm``, sliding
windows, both softcaps, ``emb_scale`` and ``tie_embeddings``.

The other families (MoE, VLM, SSM, hybrid, enc-dec) raise a ValueError
that names the slice which brings them.

Head padding: when num_heads doesn't divide the model axis (qwen2-vl: 28),
q-heads are padded up to the next multiple of 16, so parameter shapes
match the reference's leaf for leaf.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.attention import KVCache

TP = 16  # model-axis width the head padding targets

_LATER = {"moe": "the MoE + VLM serving slice",
          "vlm": "the MoE + VLM serving slice",
          "ssm": "the SSM + hybrid slice",
          "hybrid": "the SSM + hybrid slice",
          "encdec": "the enc-dec slice"}


def heads_padded(cfg: ModelConfig) -> int:
    h = cfg.num_heads
    return h if h % TP == 0 or h < TP else -(-h // TP) * TP


def _acfg(cfg: ModelConfig) -> ModelConfig:
    """Config with padded head count (used for attention param shapes)."""
    hp = heads_padded(cfg)
    return cfg if hp == cfg.num_heads else cfg.replace(num_heads=hp)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; it "
            f"comes with {_LATER.get(cfg.family, 'a later slice')} "
            "(ROADMAP.md §1)")


# ===========================================================================
# the dense block
# ===========================================================================

_NORMS = ("ln_attn", "ln_mlp", "ln_attn_post", "ln_mlp_post", "final_norm")


def _norm_scale(cfg: ModelConfig, device) -> nn.Parameter:
    """Dense-path norm scale: f32 zeros, applied as (1 + scale)."""
    return layers.param(torch.zeros((cfg.d_model,), device=device))


class DenseBlock(nn.Module):
    """One dense layer (`_dense_block_apply` of the reference)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln_attn = _norm_scale(cfg, device)
        self.attn = attn.Attention(_acfg(cfg), device=device)
        self.ln_mlp = _norm_scale(cfg, device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff,
                              layers.torch_dtype(cfg.dtype), device)
        if cfg.post_norm:
            self.ln_attn_post = _norm_scale(cfg, device)
            self.ln_mlp_post = _norm_scale(cfg, device)

    def forward(self, x, cfg: ModelConfig, *, mode: str, window: int,
                positions, cache: KVCache = None, pos=None):
        """window: this layer's sliding window (0 = global attention)."""
        def norm(t, w):
            return layers.rms_norm(t, w, cfg.norm_eps, gemma_style=True)

        h = norm(x, self.ln_attn)
        a_out, new_cache = attn.self_attention(
            self.attn, h, _acfg(cfg), mode=mode, positions=positions,
            cache=cache, pos=pos, window=window)
        if cfg.post_norm:
            a_out = norm(a_out, self.ln_attn_post)
        if cfg.parallel_block:
            return x + a_out + self.mlp(h, cfg.act), new_cache
        x = x + a_out
        m_out = self.mlp(norm(x, self.ln_mlp), cfg.act)
        if cfg.post_norm:
            m_out = norm(m_out, self.ln_mlp_post)
        return x + m_out, new_cache


def _layer_windows(cfg: ModelConfig, n: int) -> List[int]:
    """Per-layer sliding windows (gemma2: even layers local)."""
    if cfg.alt_local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(n)]
    return [cfg.sliding_window] * n


# ===========================================================================
# whole-model params
# ===========================================================================

class LM(nn.Module):
    """The reference's params pytree as modules: ``embed.table``,
    ``head.w`` (unless tied), ``final_norm`` and ``blocks.<l>.*`` (the
    reference stacks the blocks' leaves ``[L, ...]``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _require_dense(cfg)
        self.embed = layers.Embed(cfg, device)
        self.head = layers.Head(cfg, device)
        self.final_norm = _norm_scale(cfg, device)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, device) for _ in range(cfg.num_layers))


def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """A model on `gen`'s device with the reference's distributions, drawn
    from `gen` leaf by leaf: every matrix normal/sqrt(shape[0]) (the
    embedding table then x sqrt(d_model)), dense-path norms at zeros
    (applied as 1 + scale), q_norm/k_norm at ones.  Matrices are drawn in
    f32 and held in ``cfg.dtype``; norm scales stay f32."""
    model = LM(cfg, device=gen.device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _NORMS or leaf in ("q_norm", "k_norm"):
            continue                    # zeros / ones from the constructor
        w = layers.dense_init(gen, p.shape)
        if name == "embed.table":
            w.mul_(math.sqrt(float(cfg.d_model)))
        p.copy_(w)
        del w
    return model


# ===========================================================================
# the decoder stack
# ===========================================================================

def _embed_inputs(params: LM, cfg: ModelConfig, batch: Dict):
    return layers.embed_apply(params.embed, batch["tokens"], cfg)


def _run_stack(params: LM, x, cfg: ModelConfig, *, mode: str, caches=None,
               pos=None, s_max: int = 0):
    """The layers in order.  train: caches None; prefill: returns stacked
    caches ``[L, B, max(S, s_max), KVH, Dh]`` holding the prompt (zeros
    past it); decode: writes the token at `pos` into `caches` in place.
    Returns (x, caches, aux)."""
    _require_dense(cfg)
    b, s = x.shape[0], x.shape[1]
    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device).expand(b, s)
    else:
        positions = pos[:, None]
    if mode == "prefill":
        caches = init_caches(cfg, b, max(s, s_max), device=x.device)
    windows = _layer_windows(cfg, cfg.num_layers)
    for l, blk in enumerate(params.blocks):
        cache_l = (KVCache(caches.k[l], caches.v[l]) if mode == "decode"
                   else None)
        x, kv = blk(x, cfg, mode=mode, window=windows[l],
                    positions=positions, cache=cache_l, pos=pos)
        if mode == "prefill":
            caches.k[l, :, :s] = kv.k
            caches.v[l, :, :s] = kv.v
    return x, caches, torch.zeros((), device=x.device)


def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                device=None) -> KVCache:
    """Stacked per-layer caches ``[L, B, s_max, KVH, Dh]`` in ``cfg.dtype``
    (as the reference, which takes its dtype from the config)."""
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    dt = layers.torch_dtype(cfg.dtype)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def _train_caches(cfg: ModelConfig, x):
    """Train mode: the dense family needs no cache."""
    _require_dense(cfg)
    return None


def _final_logits(params: LM, cfg: ModelConfig, x):
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps, gemma_style=True)
    return layers.unembed_apply(params.embed, params.head, x, cfg)


# ===========================================================================
# public API
# ===========================================================================

@torch.no_grad()
def forward_train(params: LM, cfg: ModelConfig, batch):
    """-> (logits [B,S,Vp], aux_loss).  Forward only: the backward waits
    for the training slice."""
    x = _embed_inputs(params, cfg, batch)
    x, _, aux = _run_stack(params, x, cfg, mode="train",
                           caches=_train_caches(cfg, x))
    return _final_logits(params, cfg, x), aux


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, batch, s_max: int):
    """Run the prompt; returns (last_logits [B,Vp], caches, last_pos [B])."""
    x = _embed_inputs(params, cfg, batch)
    x, caches, _ = _run_stack(params, x, cfg, mode="prefill", s_max=s_max)
    caches = _grow_caches(caches, s_max)
    logits = _final_logits(params, cfg, x[:, -1:])
    last_pos = torch.full((x.shape[0],), batch["tokens"].shape[1] - 1,
                          dtype=torch.int32, device=x.device)
    return logits[:, 0], caches, last_pos


def _grow_caches(kv_stacked, s_max: int):
    """Pad prefill KV caches [L,B,S,..] up to decode capacity s_max (a
    no-op for the caches `_run_stack` makes, which already hold s_max)."""
    if kv_stacked is None:
        return None

    def grow(t):
        s = t.shape[2]
        if s >= s_max:
            return t
        out = t.new_zeros((*t.shape[:2], s_max, *t.shape[3:]))
        out[:, :, :s] = t
        return out

    return KVCache(k=grow(kv_stacked.k), v=grow(kv_stacked.v))


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, caches, pos):
    """One token: token int[B,1]; pos int[B] (index being written).  The
    token's K/V rows are written into `caches` in place.

    Returns (logits [B,Vp], caches)."""
    x = _embed_inputs(params, cfg, {"tokens": token})
    x, caches, _ = _run_stack(params, x, cfg, mode="decode", caches=caches,
                              pos=pos)
    return _final_logits(params, cfg, x)[:, 0], caches
