"""The model stack: init / train-forward / prefill / decode for every
family (dense, MoE, VLM, SSM, hybrid, enc-dec).

Port of ``src/repro/models/lm.py``.  The reference scans one traced body
over stacked layer weights; here the layers are an ``nn.ModuleList`` run
by a plain loop, the per-layer sliding windows (gemma2's local/global
alternation) a list of ints.  The dense block carries every flag of the
dense archs (``qk_norm``, ``parallel_block``, ``post_norm``, sliding
windows, both softcaps, ``emb_scale``, ``tie_embeddings``), the MoE layer
in place of the MLP (olmoe, deepseek-moe) and M-RoPE (qwen2-vl).  rwkv6
stacks RWKV blocks; zamba2 stacks mamba blocks in groups of
``shared_block_period``, each group followed by the one shared attention
block (a KV cache per group).  The enc-dec family (seamless) runs a
non-causal encoder over the source embeddings, then decoder blocks with
cross-attention over the encoder's K/V; its caches are ``{"self",
"cross"}``.

`forward_train` is differentiable.  With ``cfg.remat`` and grad enabled
each layer body runs under ``torch.utils.checkpoint`` (the reference's
per-layer ``jax.checkpoint``); `prefill` and `decode_step` run without
autograd and write their caches in place.  ``init_params(...,
master=True)`` holds the matrices in f32 for the trainer.

Head padding: when num_heads doesn't divide the model axis (qwen2-vl: 28),
q-heads are padded up to the next multiple of 16, so parameter shapes
match the reference's leaf for leaf.

Over a mesh: `prefill`, `decode_step` and `forward_train` take a model
placed by `specs.place_params` (`specs.ShardedLM`), every family.  One process
drives every shard, one after another (on several cards their launches
overlap).  The batch splits over the data axes where it divides; each
shard gathers a layer's FSDP pieces over 'data' once a call, then runs
Megatron-style tensor parallelism over 'model': the embedding by vocab
rows, column-parallel q/k/v and gate/up, row-parallel out/down, one
`sharding.all_sum` over 'model' a sub-block, the MoE experts over 'model'
(`moe.moe_apply_sharded`), logits by vocab columns.  qwen2-vl splices each
data block's vision embeddings and rotates by its M-RoPE positions.
rwkv6's time mix runs on each shard's whole heads (the WKV and its
GroupNorm head-local, wo by rows), its channel mix sums a row-parallel
value and gathers the receptance's product.  zamba2's mamba2 layers run
on each shard's heads with B/C whole, the gated RMSNorm's sum of squares
summed over 'model' first, out_proj by rows; its shared block is planned
on its own unstacked leaves.  seamless's encoder, decoder and
cross-attention each take their own plan.  Where a family's heads do not
divide over 'model' those matrices run whole on every shard.  The logits
come back as a `sharding.Placed` ([B, Vp], vocab over 'model'), the
caches as placed leaves (K/V by `attention.kv_placement`, the recurrent
states by heads, rwkv6's shifts whole, mamba2's conv window a
`sharding.Joined`), the positions whole.  `forward_train` returns every
position's logits placed ([B, S, Vp]) and writes no cache; with
``cfg.remat`` each layer runs under `_remat` across all shards, its FSDP
gathers inside, so the backward gathers again.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.models import attention as attn
from repro_torch.models import layers, mamba2, moe, rwkv6, sharding, specs
from repro_torch.models.attention import KVCache

TP = 16  # model-axis width the head padding targets

_ATTN = ("dense", "moe", "vlm")    # families of attention blocks
_FAMILIES = _ATTN + ("ssm", "hybrid", "encdec")


def heads_padded(cfg: ModelConfig) -> int:
    h = cfg.num_heads
    return h if h % TP == 0 or h < TP else -(-h // TP) * TP


def _acfg(cfg: ModelConfig) -> ModelConfig:
    """Config with padded head count (used for attention param shapes)."""
    hp = heads_padded(cfg)
    return cfg if hp == cfg.num_heads else cfg.replace(num_heads=hp)


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.dtype == "float64" and cfg.family != "ssm":
        raise ValueError(f"{cfg.name}: float64 runs the ssm family only "
                         "(the attention and SSD products compute in f32)")


def _require_decoder(cfg: ModelConfig) -> None:
    """The decoder-only stack, which the enc-dec family has not (the
    reference's `_run_stack` raises for it, so the RAG prefill refuses
    it)."""
    _check(cfg)
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the enc-dec family has no decoder-only stack, so "
            "the RAG prefill does not take it; "
            "repro_torch.serving.serve_step.generate serves it")


def _remat(cfg: ModelConfig, fn, *args, **kw):
    """``fn(*args, **kw)``; with ``cfg.remat`` and grad enabled its
    activations are recomputed in the backward instead of saved (the
    reference's per-layer ``jax.checkpoint``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


# ===========================================================================
# per-family single-layer blocks
# ===========================================================================

def _norm_scale(cfg: ModelConfig, device, value: float = 0.0) -> nn.Parameter:
    """A norm scale in f32: the dense path's zeros (applied as 1 + scale),
    the SSM blocks' ones."""
    return layers.param(torch.full((cfg.d_model,), value, device=device))


class DenseBlock(nn.Module):
    """One attention layer (`_dense_block_apply` of the reference); its
    MLP is the MoE layer in the moe family."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln_attn = _norm_scale(cfg, device)
        self.attn = attn.Attention(_acfg(cfg), device=device)
        self.ln_mlp = _norm_scale(cfg, device)
        self.mlp = (moe.MoE(cfg, device) if cfg.family == "moe" else
                    layers.MLP(cfg.d_model, cfg.d_ff,
                               layers.torch_dtype(cfg.dtype), device))
        if cfg.post_norm:
            self.ln_attn_post = _norm_scale(cfg, device)
            self.ln_mlp_post = _norm_scale(cfg, device)

    def forward(self, x, cfg: ModelConfig, *, mode: str, window: int,
                positions, mrope_pos=None, cache: KVCache = None, pos=None):
        """window: this layer's sliding window (0 = global attention).
        Returns (x, cache, aux): aux is the MoE layer's loss, else None."""
        def norm(t, w):
            return layers.rms_norm(t, w, cfg.norm_eps, gemma_style=True)

        h = norm(x, self.ln_attn)
        a_out, new_cache = attn.self_attention(
            self.attn, h, _acfg(cfg), mode=mode, positions=positions,
            mrope_pos=mrope_pos, cache=cache, pos=pos, window=window)
        if cfg.post_norm:
            a_out = norm(a_out, self.ln_attn_post)
        if cfg.parallel_block:
            return x + a_out + self.mlp(h, cfg.act), new_cache, None
        x, h2 = _add_norm(x, a_out, self.ln_mlp, cfg, gemma_style=True)
        aux = None
        if cfg.family == "moe":
            m_out, aux = moe.moe_apply(self.mlp, h2, cfg)
        else:
            m_out = self.mlp(h2, cfg.act)
        if cfg.post_norm:
            m_out = norm(m_out, self.ln_mlp_post)
        return x + m_out, new_cache, aux


class DecoderBlock(DenseBlock):
    """An enc-dec decoder layer (the reference's `_decode_stack` body):
    causal self-attention, cross-attention over the encoder's K/V behind
    ``ln_cross`` (f32 zeros, applied as 1 + scale; ``cross`` at the padded
    head count), then the MLP."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.ln_cross = _norm_scale(cfg, device)
        self.cross = attn.Attention(_acfg(cfg), device=device)

    def forward(self, x, cfg: ModelConfig, *, mode: str, positions,
                enc_out=None, cross: KVCache = None, cache: KVCache = None,
                pos=None):
        """`cross`: this layer's cached encoder K/V (decode), else made from
        `enc_out`.  Returns (x, the self-attention cache, the cross K/V)."""
        acfg = _acfg(cfg)
        h = layers.rms_norm(x, self.ln_attn, cfg.norm_eps, gemma_style=True)
        a_out, kv = attn.self_attention(self.attn, h, acfg, mode=mode,
                                        positions=positions, cache=cache,
                                        pos=pos)
        x, hc = _add_norm(x, a_out, self.ln_cross, cfg, gemma_style=True)
        if cross is None:
            cross = attn.cross_kv(self.cross, enc_out, acfg)
        x, h2 = _add_norm(x, attn.cross_attention(self.cross, hc, cross, acfg),
                          self.ln_mlp, cfg, gemma_style=True)
        return x + self.mlp(h2, cfg.act), kv, cross


def _encoder_layer(blk: DenseBlock, x, cfg: ModelConfig, positions):
    """An enc-dec encoder layer: non-causal self-attention, then the MLP."""
    h = layers.rms_norm(x, blk.ln_attn, cfg.norm_eps, gemma_style=True)
    a_out, _ = attn.self_attention(blk.attn, h, _acfg(cfg), mode="train",
                                   positions=positions, causal=False)
    x, h2 = _add_norm(x, a_out, blk.ln_mlp, cfg, gemma_style=True)
    return x + blk.mlp(h2, cfg.act)


def _add_norm(x, y, scale, cfg: ModelConfig, *, gemma_style: bool = False):
    """(x + y, rms_norm(x + y)): the norm takes the sum before it is
    rounded to x's dtype, as the reference's fused residual add and norm
    do on XLA."""
    s = layers.upcast(x) + y
    return s.to(x.dtype), layers.rms_norm(s, scale, cfg.norm_eps,
                                          gemma_style=gemma_style,
                                          dtype=x.dtype)


def _layer_windows(cfg: ModelConfig, n: int) -> List[int]:
    """Per-layer sliding windows (gemma2: even layers local)."""
    if cfg.alt_local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(n)]
    return [cfg.sliding_window] * n


class RWKVBlock(rwkv6.RWKV):
    """rwkv6's layer: time mix and channel mix behind RMS pre-norms (ln1,
    ln2: f32 ones)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.ln1 = _norm_scale(cfg, device, 1.0)
        self.ln2 = _norm_scale(cfg, device, 1.0)

    def forward(self, x, cfg: ModelConfig, cache: rwkv6.RWKVCache):
        h = layers.rms_norm(x, self.ln1, cfg.norm_eps)
        y, state, x_att = rwkv6.time_mix(self, h, cfg, cache.state,
                                         cache.x_att)
        x, h2 = _add_norm(x, y, self.ln2, cfg)
        y2, x_ffn = rwkv6.channel_mix(self, h2, cfg, cache.x_ffn)
        return x + y2, rwkv6.RWKVCache(state=state, x_att=x_att, x_ffn=x_ffn)


class MambaBlock(mamba2.Mamba):
    """zamba2's backbone layer: a mamba2 mixer behind an RMS pre-norm
    (ln: f32 ones), chunk 128 as the reference's."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.ln = _norm_scale(cfg, device, 1.0)

    def forward(self, x, cfg: ModelConfig, *, mode: str, cache=None):
        h = layers.rms_norm(x, self.ln, cfg.norm_eps)
        y, new_cache = mamba2.mamba_apply(self, h, cfg, mode=mode,
                                          cache=cache, chunk=128)
        return x + y, new_cache


class ZambaCaches(NamedTuple):
    mamba: mamba2.MambaCache   # stacked [L, ...]
    attn: KVCache              # stacked [L/P, ...] (per shared-block call)


# ===========================================================================
# whole-model params
# ===========================================================================

class LM(nn.Module):
    """The reference's params pytree as modules: ``embed.table``,
    ``head.w`` (unless tied), ``final_norm``, ``blocks.<l>.*`` (the
    reference stacks the blocks' leaves ``[L, ...]``), for the hybrid
    ``shared_attn.*``, and for the enc-dec family ``enc_blocks.<l>.*``,
    ``dec_blocks.<l>.*`` and ``enc_final_norm`` in place of ``blocks``.
    Calling the model runs `forward_train` (so ``torch.func.functional_call``
    can run it on other tensors)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check(cfg)
        self.embed = layers.Embed(cfg, device)
        self.head = layers.Head(cfg, device)
        self.final_norm = _norm_scale(cfg, device)
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(
                DenseBlock(cfg, device) for _ in range(cfg.num_enc_layers))
            self.dec_blocks = nn.ModuleList(
                DecoderBlock(cfg, device) for _ in range(cfg.num_dec_layers))
            self.enc_final_norm = _norm_scale(cfg, device)
            return
        block = {"ssm": RWKVBlock, "hybrid": MambaBlock}.get(cfg.family,
                                                            DenseBlock)
        self.blocks = nn.ModuleList(
            block(cfg, device) for _ in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared_attn = DenseBlock(cfg, device)

    def forward(self, cfg: ModelConfig, batch):
        return forward_train(self, cfg, batch)


# 2-D leaves with a constant init (rwkv6's bonus: f32 zeros), and drawn
# matrices the reference scales after the draw
_FIXED = {"u"}
_SCALED = {"ww": 0.1, "conv_x": 0.1, "conv_bc": 0.1}


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                master: bool = False) -> LM:
    """A model on `gen`'s device with the reference's distributions, drawn
    from `gen` leaf by leaf: every matrix normal/sqrt(shape[0]) (the
    embedding table then x sqrt(d_model); rwkv6's decay projection and
    mamba2's convs x 0.1); the vectors and rwkv6's bonus at the
    constructors' constants (dense norms zeros, applied as 1 + scale;
    q_norm/k_norm and the SSM norms ones; the token-shift mixes 0.5, ...).
    Matrices are drawn in f32 and held in ``cfg.dtype``, or in f32 with
    `master` (the trainer's master weights: the layers cast them to the
    activations' dtype at each use); vectors stay f32.  The same `gen`
    gives the same draws either way."""
    model = LM(cfg.replace(dtype="float32") if master else cfg,
               device=gen.device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 1 or leaf in _FIXED:
            continue                    # constants from the constructor
        w = layers.dense_init(gen, p.shape)
        if name == "embed.table":
            w.mul_(math.sqrt(float(cfg.d_model)))
        elif leaf in _SCALED:
            w.mul_(_SCALED[leaf])
        p.copy_(w)
        del w
    return model


# ===========================================================================
# the decoder stacks
# ===========================================================================

def _embed_inputs(params: LM, cfg: ModelConfig, batch: Dict):
    x = layers.embed_apply(params.embed, batch["tokens"], cfg)
    if cfg.family == "vlm" and "vis_embeds" in batch:
        x = _splice_vision(x, batch["vis_embeds"])
    return x


def _run_stack(params: LM, x, cfg: ModelConfig, *, mode: str, caches=None,
               pos=None, s_max: int = 0, mrope_pos=None):
    """The layers in order, for every decoder-only family.

    train: caches None (the SSM families start from zero states);
    prefill: returns the caches the prompt leaves (the attention caches
    ``[L, B, max(S, s_max), KVH, Dh]``, zeros past the prompt; the SSM
    states and shifts); decode: writes the token's K/V rows and the new
    states into `caches` in place.  Returns (x, caches, aux)."""
    _require_decoder(cfg)
    fam = cfg.family
    b, s = x.shape[0], x.shape[1]
    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device).expand(b, s)
    else:
        positions = pos[:, None]
    if mrope_pos is None and fam == "vlm":
        mrope_pos = positions[..., None].expand(*positions.shape, 3)
    aux = torch.zeros((), device=x.device)

    if fam in _ATTN:
        if mode == "prefill":
            caches = init_caches(cfg, b, max(s, s_max), device=x.device)
        windows = _layer_windows(cfg, cfg.num_layers)
        for l, blk in enumerate(params.blocks):
            cache_l = (KVCache(caches.k[l], caches.v[l]) if mode == "decode"
                       else None)
            x, kv, a = _remat(cfg, blk, x, cfg, mode=mode,
                              window=windows[l], positions=positions,
                              mrope_pos=mrope_pos, cache=cache_l, pos=pos)
            if a is not None:
                aux = aux + a
            if mode == "prefill":
                caches.k[l, :, :s] = kv.k
                caches.v[l, :, :s] = kv.v
        return x, caches, aux

    if fam == "ssm":
        if caches is None:
            caches = init_caches(cfg, b, 0, device=x.device)
        for l, blk in enumerate(params.blocks):
            x, new = _remat(cfg, blk, x, cfg, rwkv6.RWKVCache(
                caches.state[l], caches.x_att[l], caches.x_ffn[l]))
            if mode != "train":
                for stack, t in zip(caches, new):
                    stack[l] = t
        return x, (None if mode == "train" else caches), aux

    # hybrid: groups of `period` mamba layers, each followed by the shared
    # attention block (window 0, its own KV cache per group)
    period = cfg.shared_block_period
    if mode == "prefill":
        if caches is None:
            caches = _train_caches(cfg, x)
        caches = caches._replace(attn=_kv_caches(
            cfg, cfg.num_layers // period, b, max(s, s_max), x.device))
    for g in range(cfg.num_layers // period):
        for l in range(g * period, (g + 1) * period):
            mc = (mamba2.MambaCache(caches.mamba.state[l],
                                    caches.mamba.conv[l])
                  if mode == "decode" else None)
            x, new = _remat(cfg, params.blocks[l], x, cfg, mode=mode,
                            cache=mc)
            if mode != "train":
                caches.mamba.state[l] = new.state
                caches.mamba.conv[l] = new.conv
        ac = (KVCache(caches.attn.k[g], caches.attn.v[g]) if mode == "decode"
              else None)
        x, kv, _ = _remat(cfg, params.shared_attn, x, cfg, mode=mode,
                          window=0, positions=positions, cache=ac, pos=pos)
        if mode == "prefill":
            caches.attn.k[g, :, :s] = kv.k
            caches.attn.v[g, :, :s] = kv.v
    return x, (None if mode == "train" else caches), aux


def init_caches(cfg: ModelConfig, batch: int, s_max: int, device=None):
    """Stacked per-layer caches in ``cfg.dtype`` (as the reference, which
    takes the dtype from the config; SSM states f32): KV ``[L, B, s_max,
    KVH, Dh]``; rwkv6's `RWKVCache`; zamba2's `ZambaCaches` (a KV cache
    per shared-block call); the enc-dec family's ``{"self": [L_dec] KV,
    "cross": None}`` (the cross K/V come with the prefill)."""
    _check(cfg)
    dt = layers.torch_dtype(cfg.dtype)
    if cfg.family == "encdec":
        return {"self": _kv_caches(cfg, cfg.num_dec_layers, batch, s_max,
                                   device), "cross": None}
    if cfg.family in _ATTN:
        return _kv_caches(cfg, cfg.num_layers, batch, s_max, device)
    if cfg.family == "ssm":
        return rwkv6.RWKVCache.init(batch, cfg, dt, device,
                                    (cfg.num_layers,))
    return ZambaCaches(
        mamba=mamba2.MambaCache.init(batch, cfg, dt, device,
                                     (cfg.num_layers,)),
        attn=_kv_caches(cfg, cfg.num_layers // cfg.shared_block_period,
                        batch, s_max, device))


def _kv_caches(cfg: ModelConfig, n: int, batch: int, s_max: int,
               device, kv_heads: int = 0) -> KVCache:
    """Zero K/V [n, B, s_max, KVH, Dh] (`kv_heads`: a model shard's KVH)."""
    shape = (n, batch, s_max, kv_heads or cfg.num_kv_heads, cfg.head_dim)
    dt = layers.torch_dtype(cfg.dtype)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def _train_caches(cfg: ModelConfig, x):
    """Train mode: attention families need no cache; ssm/hybrid start from
    zero states."""
    _check(cfg)
    if cfg.family == "ssm":
        return init_caches(cfg, x.shape[0], 0, device=x.device)
    if cfg.family == "hybrid":
        return init_caches(cfg, x.shape[0], 0,
                           device=x.device)._replace(attn=None)
    return None


def _final_logits(params: LM, cfg: ModelConfig, x):
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps, gemma_style=True)
    return layers.unembed_apply(params.embed, params.head, x, cfg)


# ===========================================================================
# encoder-decoder (seamless)
# ===========================================================================

def _encode(params: LM, cfg: ModelConfig, src_emb):
    """The encoder over the source frame embeddings [B, Se, D]: non-causal
    self-attention layers, then ``enc_final_norm``."""
    x = src_emb.to(layers.torch_dtype(cfg.dtype))
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for blk in params.enc_blocks:
        x = _remat(cfg, _encoder_layer, blk, x, cfg, positions)
    return layers.rms_norm(x, params.enc_final_norm, cfg.norm_eps,
                           gemma_style=True)


def _decode_stack(params: LM, cfg: ModelConfig, x, enc_out, *, mode: str,
                  caches=None, pos=None, s_max: int = 0):
    """The decoder layers: self-attention, then cross-attention over
    `cross_kv(enc_out)` (train, prefill) or over the cached cross K/V
    (decode).  prefill returns ``{"self": KV [L_dec, B, max(S, s_max),
    KVH, Dh] (zeros past the prompt), "cross": KV [L_dec, B, Se, KVH,
    Dh]}``; decode writes the token's K/V rows into ``caches["self"]`` in
    place.  Returns (x, caches)."""
    b, s = x.shape[0], x.shape[1]
    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device).expand(b, s)
    else:
        positions = pos[:, None]
    if mode == "decode":
        sc, cc = caches["self"], caches["cross"]
        for l, blk in enumerate(params.dec_blocks):
            x, _, _ = blk(x, cfg, mode=mode, positions=positions,
                          cross=KVCache(cc.k[l], cc.v[l]),
                          cache=KVCache(sc.k[l], sc.v[l]), pos=pos)
        return x, caches
    if mode == "prefill":
        sc = _kv_caches(cfg, cfg.num_dec_layers, b, max(s, s_max), x.device)
        crosses = []
    for l, blk in enumerate(params.dec_blocks):
        x, kv, cross = _remat(cfg, blk, x, cfg, mode=mode,
                              positions=positions, enc_out=enc_out)
        if mode == "prefill":
            sc.k[l, :, :s] = kv.k
            sc.v[l, :, :s] = kv.v
            crosses.append(cross)
    if mode == "train":
        return x, None
    cc = KVCache(k=torch.stack([c.k for c in crosses]),
                 v=torch.stack([c.v for c in crosses]))
    return x, {"self": sc, "cross": cc}


# ===========================================================================
# over a mesh
# ===========================================================================

def mesh_of(params, cfg: ModelConfig) -> Optional[ShardMesh]:
    """The mesh a call runs on: a placed model's own (the active mesh, if
    any, must be it), else None.  A model on one device is refused under a
    mesh: `specs.place_params` places it."""
    mesh = sharding.current_mesh()
    if not isinstance(params, specs.ShardedLM):
        if mesh is not None:
            raise ValueError("a mesh is active and the model is on one "
                             "device; place it with "
                             "repro_torch.models.specs.place_params")
        return None
    if mesh is not None and mesh != params.mesh:
        raise ValueError("the model is placed on another mesh than the "
                         "active one")
    _check(cfg)
    return params.mesh


class MeshCall(NamedTuple):
    """One call's layout on the mesh, with the plan of one group of
    attention blocks (`_mesh_call`'s keys: the decoder-only stack's by
    default)."""
    mesh: ShardMesh
    batch: int              # the whole batch
    batch_entry: object     # the batch dim's placement (None: replicated)
    batch_split: bool       # the batch divides over the data axes
    attn_tp: bool           # q heads (and wo) cut over 'model'
    kv_heads: tuple         # per shard: the kv heads it attends with
    kv_local: int           # kv heads a shard holds
    mlp_tp: bool            # the dense MLP's hidden cut over 'model'
    ep: bool                # the MoE experts run expert-parallel
    shared_tp: bool         # deepseek's shared experts cut over 'model'
    emb: list               # per shard: the embedding table, gathered


def _mesh_call(sp: specs.ShardedLM, cfg: ModelConfig, b: int,
               attn_key: str = "blocks.attn.", mlp_key: str = "blocks.mlp.",
               emb: Optional[list] = None) -> MeshCall:
    """The layout of a call of batch `b`, planned for the attention leaves
    under `attn_key` and the MLP under `mlp_key` (zamba2's shared block,
    seamless's encoder, decoder and cross-attention have their own);
    `emb`: the gathered embedding, where an earlier plan has it."""
    mesh = sp.mesh
    sizes = sharding.axis_sizes(mesh)
    m = sizes.get("model", 1)
    dp = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    entry = sharding.placement((b,), "batch", mesh=mesh)[0]
    attn_tp = sp.tp_split(attn_key + "wq", 1)
    kv_split = sp.tp_split(attn_key + "wk", 1)
    kv_heads = [None] * mesh.size
    if attn_tp and not kv_split:
        kv_heads = [attn.local_kv_heads(heads_padded(cfg), cfg.num_kv_heads,
                                        _model_coord(mesh, i), m)
                    for i in range(mesh.size)]
    moe_fam = cfg.family == "moe"
    # the reference's shard_map branch: model > 1, b % dp == 0, E % model
    ep = moe_fam and m > 1 and b % dp == 0 and sp.tp_split(
        f"{mlp_key}wi", 0)
    shared = moe_fam and cfg.num_shared_experts > 0
    return MeshCall(
        mesh=mesh, batch=b, batch_entry=entry, batch_split=b % dp == 0,
        attn_tp=attn_tp, kv_heads=tuple(kv_heads),
        kv_local=cfg.num_kv_heads // (m if kv_split else 1),
        mlp_tp=not moe_fam and sp.tp_split(f"{mlp_key}wi", 1),
        ep=ep, shared_tp=ep and shared and sp.tp_split(
            f"{mlp_key}shared.wi", 1),
        emb=sp.gathered("embed.") if emb is None else emb)


def _model_width(mesh: ShardMesh) -> int:
    return sharding.axis_sizes(mesh).get("model", 1)


def _model_coord(mesh: ShardMesh, i: int) -> int:
    return sharding.coords(mesh, i).get("model", 0)


def _splice_vision(x, v):
    """The stub vision tower's patch embeddings `v` [B, Nv, D] in the
    first positions of `x` [B, S, D]."""
    v = v.to(x.dtype)
    if v.shape[1] > x.shape[1]:
        raise ValueError(f"{v.shape[1]} vision embeddings for "
                         f"{x.shape[1]} positions")
    return torch.cat([v, x[:, v.shape[1]:]], dim=1)


def _per_block(t, call: MeshCall) -> list:
    """A batch tensor [B, ...] as each shard's data block: a whole one
    cut, a placed one (the trainer's batches) taken as it is placed."""
    spec = (call.batch_entry,) + (None,) * (len(t.shape) - 1)
    if isinstance(t, sharding.Placed):
        if tuple(t.spec) + (None,) * (len(spec) - len(t.spec)) == spec:
            return list(t.parts)
        t = t.full()
    return list(sharding.place(t, spec, call.mesh).parts)


def embed_mesh(sp: specs.ShardedLM, cfg: ModelConfig, tokens,
               vis_embeds=None):
    """The tokens [B, S] embedded on the mesh: (per shard its data block's
    embeddings [B_l, S, D], the call's layout).  A vocab-cut table looks up
    its own rows and the sum over 'model' fills in the rest exactly.
    qwen2-vl's `vis_embeds` [B, Nv, D] take each block's first positions."""
    with sharding.scope("embed"):
        call = _mesh_call(sp, cfg, tokens.shape[0])
    mesh = sp.mesh
    parts = _per_block(tokens, call)
    split = sp.tp_split("embed.table", 0)
    rows = []
    for i, (e, t) in enumerate(zip(call.emb, parts)):
        v0 = (sharding.local_slices(sp.shapes["embed.table"],
                                    sp.tp["embed.table"], mesh, i)[0].start
              if split else None)
        rows.append(layers.embed_rows(e.table, t, v0))
    if split:
        with sharding.scope("embed"):
            rows = sharding.all_sum(rows, mesh, "model")
    xs = [layers.embed_finish(r, cfg) for r in rows]
    if cfg.family == "vlm" and vis_embeds is not None:
        xs = [_splice_vision(x, v)
              for x, v in zip(xs, _per_block(vis_embeds, call))]
    return xs, call


def _attn_mesh(ps, hs, cfg: ModelConfig, call: MeshCall, *, mode: str,
               window: int, positions, kvs, layer: int, pos, mrope_pos=None,
               causal: bool = True):
    """Self-attention on every shard (`ps` per shard the attention leaves,
    `hs` its normed activations), summed over 'model' where the heads are
    cut.  Prefill writes each shard's K/V into `kvs` (per shard a stacked
    KVCache) at `layer`; decode writes the token's rows there in place."""
    outs = []
    for i, (p, h) in enumerate(zip(ps, hs)):
        cache = (KVCache(kvs[i].k[layer], kvs[i].v[layer])
                 if mode == "decode" else None)
        o, kv = attn.self_attention(
            p, h, _acfg(cfg), mode=mode, positions=positions[i],
            mrope_pos=None if mrope_pos is None else mrope_pos[i],
            cache=cache, pos=None if pos is None else pos[i], window=window,
            causal=causal, kv_heads=call.kv_heads[i])
        if mode == "prefill":
            kvs[i].k[layer, :, :h.shape[1]] = kv.k
            kvs[i].v[layer, :, :h.shape[1]] = kv.v
        outs.append(o)
    return sharding.all_sum(outs, call.mesh, "model") if call.attn_tp \
        else outs


def _block_mesh(bl, xs, cfg: ModelConfig, call: MeshCall, *, mode: str,
                window: int, positions, kvs, layer: int, pos, mrope_pos=None,
                causal: bool = True):
    """One dense/MoE/VLM layer on every shard (also zamba2's shared block
    and seamless's encoder layers, non-causal in train mode): `bl` per
    shard the layer's leaves (FSDP gathered), `xs` per shard its data
    block's activations.  Prefill writes each shard's K/V into `kvs`;
    decode writes the token's rows there in place.  Returns (xs, aux)."""
    mesh = call.mesh

    def norm(t, w):
        return layers.rms_norm(t, w, cfg.norm_eps, gemma_style=True)

    def tp_sum(parts, cut: bool):
        return sharding.all_sum(parts, mesh, "model") if cut else parts

    hs = [norm(x, b.ln_attn) for x, b in zip(xs, bl)]
    outs = _attn_mesh([b.attn for b in bl], hs, cfg, call, mode=mode,
                      window=window, positions=positions, kvs=kvs,
                      layer=layer, pos=pos, mrope_pos=mrope_pos,
                      causal=causal)
    if cfg.post_norm:
        outs = [norm(o, b.ln_attn_post) for o, b in zip(outs, bl)]
    if cfg.parallel_block:
        ms = tp_sum([layers.mlp_apply(b.mlp, h, cfg.act)
                     for b, h in zip(bl, hs)], call.mlp_tp)
        return [x + a + m for x, a, m in zip(xs, outs, ms)], None
    pairs = [_add_norm(x, a, b.ln_mlp, cfg, gemma_style=True)
             for x, a, b in zip(xs, outs, bl)]
    xs, h2s = [p[0] for p in pairs], [p[1] for p in pairs]
    aux = None
    if cfg.family == "moe":
        ms, aux = moe.moe_apply_sharded(
            [b.mlp for b in bl], h2s, cfg, mesh, ep=call.ep,
            batch_split=call.batch_split, shared_tp=call.shared_tp)
    else:
        ms = tp_sum([layers.mlp_apply(b.mlp, h, cfg.act)
                     for b, h in zip(bl, h2s)], call.mlp_tp)
    if cfg.post_norm:
        ms = [norm(m, b.ln_mlp_post) for m, b in zip(ms, bl)]
    return [x + m for x, m in zip(xs, ms)], aux


def _run_stack_mesh(sp: specs.ShardedLM, xs, cfg: ModelConfig,
                    call: MeshCall, *, mode: str, kvs=None, pos=None,
                    s_max: int = 0, mrope_pos=None):
    """The layers in order on every shard, for every decoder-only family
    (prefill: the shards' caches made here, the attention caches
    ``[L, B_l, max(S, s_max), KVH_l, Dh]``; decode: `kvs`, per shard its
    cache tree, written in place, and `pos` per shard; `mrope_pos` per
    shard, qwen2-vl's, else the positions broadcast to 3).  Returns (xs,
    per shard its caches, aux)."""
    _require_decoder(cfg)
    s = xs[0].shape[1]
    if mode in ("train", "prefill"):
        positions = [torch.arange(s, device=x.device).expand(x.shape[0], s)
                     for x in xs]
    else:
        positions = [p[:, None] for p in pos]
    aux = torch.zeros((), device=sharding.home(call.mesh))
    if cfg.family == "ssm":
        xs, kvs = _rwkv_stack_mesh(sp, xs, cfg, call, mode=mode, caches=kvs)
        return xs, kvs, aux
    if cfg.family == "hybrid":
        xs, kvs = _zamba_stack_mesh(sp, xs, cfg, call, mode=mode, caches=kvs,
                                    positions=positions, pos=pos, s_max=s_max)
        return xs, kvs, aux
    if mrope_pos is None and cfg.family == "vlm":
        mrope_pos = [p[..., None].expand(*p.shape, 3) for p in positions]
    if mode == "prefill":
        kvs = [_kv_caches(cfg, cfg.num_layers, x.shape[0], max(s, s_max),
                          x.device, call.kv_local) for x in xs]
    whole = "mlp." if cfg.family == "moe" and not call.ep else None
    windows = _layer_windows(cfg, cfg.num_layers)
    for l in range(cfg.num_layers):
        def layer(*xs_, l=l):
            with sharding.scope(f"blocks.{l}"):
                bl = sp.gathered("blocks.", layer=l, whole=whole)
                return _block_mesh(bl, list(xs_), cfg, call, mode=mode,
                                   window=windows[l], positions=positions,
                                   kvs=kvs, layer=l, pos=pos,
                                   mrope_pos=mrope_pos)
        xs, a = _remat(cfg, layer, *xs)
        if a is not None:
            aux = aux + a
    return xs, kvs, aux


# rwkv6's time-mix matrices: cut over 'model' together (whole heads), or
# all used whole where the heads do not divide
_TIME_MIX = ("wr", "wk", "wv", "wg", "ww", "wo")


def _rwkv_stack_mesh(sp: specs.ShardedLM, xs, cfg: ModelConfig,
                     call: MeshCall, *, mode: str, caches):
    """rwkv6's layers on every shard.  The time mix runs on each shard's
    H/m whole heads (wr..ww by columns, the WKV and its GroupNorm
    head-local, wo by rows: one sum over 'model'); the channel mix's
    cwk/cwv give a partial value (one sum) and cwr each shard's slice of
    the receptance, whose product with the value is gathered over
    'model'.  The shifts see the whole hidden.  Train and prefill start
    from zero states; train writes no cache (each layer under `_remat`).
    Returns (xs, per shard its `RWKVCache` [L, ...]: state over its heads,
    shifts whole; train: None)."""
    mesh = call.mesh
    m = _model_width(mesh)
    heads = cfg.d_model // cfg.ssm_head_dim
    time_tp = sp.tp_split("blocks.wr", 1) and heads % m == 0
    r_tp = sp.tp_split("blocks.cwr", 1)
    k_tp = sp.tp_split("blocks.cwk", 1)
    hl = heads // m if time_tp else heads
    train = mode == "train"
    if train:
        zeros = [rwkv6.RWKVCache.init(x.shape[0], cfg, x.dtype, x.device,
                                      heads=hl) for x in xs]
    elif caches is None:
        caches = [rwkv6.RWKVCache.init(
            x.shape[0], cfg, x.dtype, x.device, (cfg.num_layers,),
            heads=hl) for x in xs]

    def layer(*xs_, l):
        with sharding.scope(f"blocks.{l}"):
            return rwkv_layer(*xs_, l=l)

    def rwkv_layer(*xs_, l):
        bl = sp.gathered("blocks.", layer=l,
                         whole=None if time_tp else _TIME_MIX)
        if time_tp:
            for i, b in enumerate(bl):
                _rwkv_heads(b, cfg, _model_coord(mesh, i), m)
        ins = zeros if train else [rwkv6.RWKVCache(
            c.state[l], c.x_att[l], c.x_ffn[l]) for c in caches]
        ys, news = [], []
        for b, x, c in zip(bl, xs_, ins):
            y, st, xa = rwkv6.time_mix(
                b, layers.rms_norm(x, b.ln1, cfg.norm_eps), cfg, c.state,
                c.x_att)
            ys.append(y)
            news.append((st, xa))
        if time_tp:
            ys = sharding.all_sum(ys, mesh, "model")
        pairs = [_add_norm(x, y, b.ln2, cfg)
                 for x, y, b in zip(xs_, ys, bl)]
        out = [p[0] for p in pairs]
        rs, vs = [], []
        for j, (b, (_, h2), c) in enumerate(zip(bl, pairs, ins)):
            r, v, xf = rwkv6.channel_parts(b, h2, c.x_ffn)
            rs.append(r)
            vs.append(v)
            news[j] = rwkv6.RWKVCache(*news[j], xf)
        if k_tp:
            vs = sharding.all_sum(vs, mesh, "model")
        if r_tp:
            n = rs[0].shape[-1]
            ys = sharding.all_gather(
                [r * v.narrow(-1, _model_coord(mesh, i) * n, n)
                 for i, (r, v) in enumerate(zip(rs, vs))], mesh,
                "model", -1)
        else:
            ys = [r * v for r, v in zip(rs, vs)]
        return [x + y for x, y in zip(out, ys)], news

    for l in range(cfg.num_layers):
        if train:
            xs = list(_remat(cfg, lambda *a, l=l: tuple(layer(*a, l=l)[0]),
                             *xs))
            continue
        xs, news = layer(*xs, l=l)
        for c, new in zip(caches, news):
            c.state[l], c.x_att[l], c.x_ffn[l] = new
    return xs, None if train else caches


def _rwkv_heads(b, cfg: ModelConfig, c: int, m: int) -> None:
    """A model shard's time mix: its w_bias, ln_x (channels) and u (heads)
    of the replicated whole leaves, in the namespace `b`."""
    n = cfg.d_model // m
    cols = slice(c * n, (c + 1) * n)
    heads = slice(c * n // cfg.ssm_head_dim, (c + 1) * n // cfg.ssm_head_dim)
    b.w_bias, b.ln_x, b.u = b.w_bias[cols], b.ln_x[cols], b.u[heads]


# mamba2's head-parallel matrices (w_x, w_z, w_dt by columns, out_proj by
# rows), or all used whole where the heads do not divide
_SSM_CUT = ("w_x", "w_z", "w_dt", "out_proj")


def _zamba_stack_mesh(sp: specs.ShardedLM, xs, cfg: ModelConfig,
                      call: MeshCall, *, mode: str, caches, positions, pos,
                      s_max: int):
    """zamba2's groups on every shard: each mamba2 layer on the shard's
    H/m whole heads (w_bc whole, so every shard computes all of B/C), its
    gated RMSNorm over the whole of d_inner (each shard's sum of squares
    summed over 'model' first), out_proj by rows (one sum); then the
    shared attention block (`_block_mesh`, planned on its own leaves: its
    MLP is unstacked, so column/row-parallel) with each group's KV cache.
    Train writes no cache; each mamba layer and each shared-block call
    runs under `_remat`, gathering its leaves inside.  Returns (xs, per
    shard its `ZambaCaches`: mamba state over its heads, conv window [L,
    B_l, W-1, di_l + 2N] (its x channels, then every B/C channel), the
    shared block's K/V; train: None)."""
    mesh = call.mesh
    m = _model_width(mesh)
    ssm_tp = sp.tp_split("blocks.w_dt", 1) and sp.tp_split("blocks.w_x", 1)
    period = cfg.shared_block_period
    n_groups = cfg.num_layers // period
    train = mode == "train"
    shared = _mesh_call(sp, cfg, call.batch, "shared_attn.attn.",
                        "shared_attn.mlp.", emb=call.emb)
    if mode == "prefill":
        s = xs[0].shape[1]
        caches = [ZambaCaches(
            mamba=mamba2.MambaCache.init(
                x.shape[0], cfg, x.dtype, x.device, (cfg.num_layers,),
                heads=cfg.ssm_heads // m if ssm_tp else cfg.ssm_heads),
            attn=_kv_caches(cfg, n_groups, x.shape[0], max(s, s_max),
                            x.device, shared.kv_local)) for x in xs]
    # serving gathers the shared block once a call; train regathers it in
    # each (recomputed) call
    sbl = None if train else sp.gathered("shared_attn.")

    def mamba_layer(*xs_, l):
        with sharding.scope(f"blocks.{l}"):
            return mamba_body(*xs_, l=l)

    def mamba_body(*xs_, l):
        bl = sp.gathered("blocks.", layer=l,
                         whole=None if ssm_tp else _SSM_CUT)
        if ssm_tp:
            for i, b in enumerate(bl):
                _mamba_heads(b, cfg, _model_coord(mesh, i), m)
        ygs, news = [], []
        for i, (b, x) in enumerate(zip(bl, xs_)):
            mc = (mamba2.MambaCache(caches[i].mamba.state[l],
                                    caches[i].mamba.conv[l])
                  if mode == "decode" else None)
            yg, new = mamba2.mamba_gated(
                b, layers.rms_norm(x, b.ln, cfg.norm_eps), cfg,
                mode=mode, cache=mc, chunk=128)
            ygs.append(yg)
            news.append(new)
        var = [None] * len(ygs)
        if ssm_tp:
            var = [q / cfg.ssm_d_inner for q in sharding.all_sum(
                [(y * y).sum(-1, keepdim=True) for y in ygs], mesh,
                "model")]
        outs = [mamba2.mamba_out(b, y, cfg, x.dtype, v)
                for b, y, x, v in zip(bl, ygs, xs_, var)]
        if ssm_tp:
            outs = sharding.all_sum(outs, mesh, "model")
        return [x + o for x, o in zip(xs_, outs)], news

    def shared_block(*xs_, g):
        with sharding.scope("shared_attn"):
            out, _ = _block_mesh(
                sbl if sbl is not None else sp.gathered("shared_attn."),
                list(xs_), cfg, shared, mode=mode, window=0,
                positions=positions,
                kvs=None if train else [c.attn for c in caches], layer=g,
                pos=pos)
        return tuple(out)

    for g in range(n_groups):
        for l in range(g * period, (g + 1) * period):
            if train:
                xs = list(_remat(cfg, lambda *a, l=l: tuple(
                    mamba_layer(*a, l=l)[0]), *xs))
                continue
            xs, news = mamba_layer(*xs, l=l)
            for c, new in zip(caches, news):
                c.mamba.state[l], c.mamba.conv[l] = new
        xs = list(_remat(cfg, shared_block, *xs, g=g))
    return xs, None if train else caches


def _mamba_heads(b, cfg: ModelConfig, c: int, m: int) -> None:
    """A model shard's mixer: its conv_x and norm (channels) and A_log, D,
    dt_bias (heads) of the replicated whole leaves, in the namespace `b`."""
    n, h = cfg.ssm_d_inner // m, cfg.ssm_heads // m
    cols, heads = slice(c * n, (c + 1) * n), slice(c * h, (c + 1) * h)
    b.conv_x, b.norm = b.conv_x[:, cols], b.norm[cols]
    b.A_log, b.D, b.dt_bias = b.A_log[heads], b.D[heads], b.dt_bias[heads]


def _encode_mesh(sp: specs.ShardedLM, cfg: ModelConfig, call: MeshCall,
                 src_emb):
    """The encoder on every shard over its data block of the source
    frames [B, Se, D] (`_block_mesh` non-causal, planned on the encoder's
    leaves; each layer under `_remat`), then ``enc_final_norm``."""
    enc = _mesh_call(sp, cfg, call.batch, "enc_blocks.attn.",
                     "enc_blocks.mlp.", emb=call.emb)
    xs = [x.to(layers.torch_dtype(cfg.dtype))
          for x in _per_block(src_emb, call)]
    s = xs[0].shape[1]
    positions = [torch.arange(s, device=x.device).expand(x.shape[0], s)
                 for x in xs]

    def layer(*xs_, l):
        with sharding.scope(f"enc_blocks.{l}"):
            out, _ = _block_mesh(sp.gathered("enc_blocks.", layer=l),
                                 list(xs_), cfg, enc, mode="train", window=0,
                                 positions=positions, kvs=None, layer=l,
                                 pos=None, causal=False)
        return tuple(out)

    for l in range(cfg.num_enc_layers):
        xs = list(_remat(cfg, layer, *xs, l=l))
    return [layers.rms_norm(x, f, cfg.norm_eps, gemma_style=True)
            for x, f in zip(xs, sp.leaf("enc_final_norm"))]


def _decode_stack_mesh(sp: specs.ShardedLM, xs, cfg: ModelConfig,
                       call: MeshCall, *, mode: str, caches=None,
                       enc_outs=None, pos=None, s_max: int = 0):
    """seamless's decoder layers on every shard: self-attention, then
    cross-attention (its own plan: q heads and wo cut like the self
    attention's, the kv heads cut or attended by `local_kv_heads`) over the
    encoder's K/V, then the MLP.  Prefill makes each shard's ``{"self":
    KV [L_dec, B_l, max(S, s_max), KVH_l, Dh], "cross": KV [L_dec, B_l,
    Se, KVH_l, Dh]}`` from `enc_outs`; decode writes the token's rows
    into ``caches[i]["self"]``; train keeps no cache (each layer under
    `_remat`, its cross K/V made from `enc_outs`).  Returns (xs, per shard
    its caches; train: None)."""
    dec = _mesh_call(sp, cfg, call.batch, "dec_blocks.attn.",
                     "dec_blocks.mlp.", emb=call.emb)
    cross = _mesh_call(sp, cfg, call.batch, "dec_blocks.cross.",
                       "dec_blocks.mlp.", emb=call.emb)
    mesh, acfg = call.mesh, _acfg(cfg)
    s = xs[0].shape[1]
    if mode in ("train", "prefill"):
        positions = [torch.arange(s, device=x.device).expand(x.shape[0], s)
                     for x in xs]
    else:
        positions = [p[:, None] for p in pos]
    if mode == "prefill":
        caches = [{"self": _kv_caches(cfg, cfg.num_dec_layers, x.shape[0],
                                      max(s, s_max), x.device, dec.kv_local),
                   "cross": _kv_caches(cfg, cfg.num_dec_layers, x.shape[0],
                                       e.shape[1], x.device, cross.kv_local)}
                  for x, e in zip(xs, enc_outs)]

    def tp_sum(parts, cut: bool):
        return sharding.all_sum(parts, mesh, "model") if cut else parts

    def layer(*xs_, l):
        with sharding.scope(f"dec_blocks.{l}"):
            return dec_layer(*xs_, l=l)

    def dec_layer(*xs_, l):
        bl = sp.gathered("dec_blocks.", layer=l)
        hs = [layers.rms_norm(x, b.ln_attn, cfg.norm_eps, gemma_style=True)
              for x, b in zip(xs_, bl)]
        outs = _attn_mesh([b.attn for b in bl], hs, cfg, dec, mode=mode,
                          window=0, positions=positions,
                          kvs=None if mode == "train" else
                          [c["self"] for c in caches], layer=l, pos=pos)
        pairs = [_add_norm(x, a, b.ln_cross, cfg, gemma_style=True)
                 for x, a, b in zip(xs_, outs, bl)]
        cos = []
        for i, (b, (_, hc)) in enumerate(zip(bl, pairs)):
            if mode == "train":
                kv = attn.cross_kv(b.cross, enc_outs[i], acfg)
            else:
                cc = caches[i]["cross"]
                if mode == "prefill":
                    kv = attn.cross_kv(b.cross, enc_outs[i], acfg)
                    cc.k[l], cc.v[l] = kv.k, kv.v
                kv = KVCache(cc.k[l], cc.v[l])
            cos.append(attn.cross_attention(b.cross, hc, kv, acfg,
                                            kv_heads=cross.kv_heads[i]))
        pairs = [_add_norm(x, co, b.ln_mlp, cfg, gemma_style=True)
                 for (x, _), co, b in zip(pairs, tp_sum(cos, cross.attn_tp),
                                          bl)]
        ms = tp_sum([layers.mlp_apply(b.mlp, h2, cfg.act)
                     for b, (_, h2) in zip(bl, pairs)], dec.mlp_tp)
        return tuple(x + mo for (x, _), mo in zip(pairs, ms))

    for l in range(cfg.num_dec_layers):
        xs = list(_remat(cfg, layer, *xs, l=l))
    return xs, None if mode == "train" else caches


def _placed(parts, spec, call: MeshCall, shape) -> sharding.Placed:
    """The shards' pieces as a `Placed` of `shape`, checked against it."""
    if sharding.local_shape(shape, spec, call.mesh) != tuple(parts[0].shape):
        raise AssertionError(f"cache pieces {tuple(parts[0].shape)} do not "
                             f"match the placement {spec} of {shape}")
    return sharding.Placed(tuple(parts), tuple(spec), call.mesh, shape)


def _placed_caches(cfg: ModelConfig, call: MeshCall, local, s_kv: int):
    """Per shard cache trees (`local`) as one tree of placed leaves: the
    K/V by `attention.kv_placement`, the recurrent states over 'model'
    where the shards hold their own heads, the batch over the data axes
    where it divides (rwkv6's shifts, every B/C column of mamba2's conv
    window and the states of uncut heads replicated over 'model')."""
    b, be = call.batch, call.batch_entry
    kv = (cfg.num_kv_heads, cfg.head_dim)

    def kvp(parts, n, s):
        shape = (n, b, s) + kv
        return KVCache(*(_placed([getattr(c, f) for c in parts],
                                 attn.kv_placement(call.mesh, shape), call,
                                 shape) for f in ("k", "v")))

    def heads_cut(local_heads: int, heads: int):
        return "model" if local_heads != heads else None

    if cfg.family in _ATTN:
        return kvp(local, cfg.num_layers, s_kv)
    if cfg.family == "encdec":
        se = local[0]["cross"].k.shape[2]
        return {"self": kvp([c["self"] for c in local], cfg.num_dec_layers,
                            s_kv),
                "cross": kvp([c["cross"] for c in local], cfg.num_dec_layers,
                             se)}
    n = cfg.num_layers
    if cfg.family == "ssm":
        h, hd = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
        st = [c.state for c in local]
        return rwkv6.RWKVCache(
            state=_placed(st, (None, be, heads_cut(st[0].shape[2], h)), call,
                          (n, b, h, hd, hd)),
            **{f: _placed([getattr(c, f) for c in local], (None, be), call,
                          (n, b, cfg.d_model)) for f in ("x_att", "x_ffn")})
    h, di, n2 = cfg.ssm_heads, cfg.ssm_d_inner, 2 * cfg.ssm_state
    st = [c.mamba.state for c in local]
    cut = heads_cut(st[0].shape[2], h)
    conv = sharding.join(
        [c.mamba.conv for c in local], [(None, be, None, cut), (None, be)],
        (di, n2), call.mesh, (n, b, cfg.ssm_conv_width - 1, di + n2), dim=3)
    return ZambaCaches(
        mamba=mamba2.MambaCache(
            state=_placed(st, (None, be, cut), call,
                          (n, b, h, cfg.ssm_head_dim, cfg.ssm_state)),
            conv=conv),
        attn=kvp([c.attn for c in local], n // cfg.shared_block_period,
                 s_kv))


def _logits_mesh(sp: specs.ShardedLM, cfg: ModelConfig, xs,
                 call: MeshCall, last: bool = True) -> sharding.Placed:
    """The last position's logits, a `sharding.Placed` [B, Vp] (with
    `last` False every position's, [B, S, Vp]): the batch as the call
    placed it, the vocab over 'model' where the head (or the tied table)
    is cut so."""
    with sharding.scope("head"):
        fn = sp.leaf("final_norm")
        heads = sp.gathered("head.")
    parts = []
    for x, f, e, h in zip(xs, fn, call.emb, heads):
        y = layers.unembed_apply(e, h, layers.rms_norm(
            x[:, -1:] if last else x, f, cfg.norm_eps, gemma_style=True),
            cfg)
        parts.append(y[:, 0] if last else y)
    cut = (sp.tp_split("embed.table", 0) if cfg.tie_embeddings
           else sp.tp_split("head.w", 1))
    lead = (call.batch,) if last else (call.batch, xs[0].shape[1])
    return sharding.Placed(tuple(parts), (call.batch_entry,) + (None,) * (
        len(lead) - 1) + ("model" if cut else None,), call.mesh,
        lead + (cfg.vocab_padded,))


def _forward_train_mesh(sp: specs.ShardedLM, cfg: ModelConfig, batch):
    """`forward_train` on a placed model: (the placed logits [B, S, Vp],
    the aux loss on shard 0's device).  No cache is allocated or written;
    each layer runs under `_remat` across every shard, its FSDP gathers
    inside, so the backward gathers again."""
    xs, call = embed_mesh(sp, cfg, batch["tokens"], batch.get("vis_embeds"))
    aux = torch.zeros((), device=sharding.home(sp.mesh))
    if cfg.family == "encdec":
        enc = _encode_mesh(sp, cfg, call, batch["src_emb"])
        xs, _ = _decode_stack_mesh(sp, xs, cfg, call, mode="train",
                                   enc_outs=enc)
    else:
        mrope_pos = batch.get("mrope_pos")
        if mrope_pos is not None:
            mrope_pos = _per_block(mrope_pos, call)
        xs, _, aux = _run_stack_mesh(sp, xs, cfg, call, mode="train",
                                     mrope_pos=mrope_pos)
    return _logits_mesh(sp, cfg, xs, call, last=False), aux


def _last_pos(call: MeshCall, s: int) -> torch.Tensor:
    return torch.full((call.batch,), s - 1, dtype=torch.int32,
                      device=sharding.home(call.mesh))


def prefill_embedded_mesh(sp: specs.ShardedLM, cfg: ModelConfig, xs,
                          call: MeshCall, s_max: int, mrope_pos=None):
    """Prefill on the mesh from embeddings `xs` (`embed_mesh`'s, or the
    RAG prefill's with the memory prefix), for every decoder-only family;
    `mrope_pos` [B, S, 3] whole (qwen2-vl's, else the positions): (logits,
    placed caches, last_pos)."""
    if mrope_pos is not None:
        mrope_pos = _per_block(mrope_pos, call)
    xs, local, _ = _run_stack_mesh(sp, xs, cfg, call, mode="prefill",
                                   s_max=s_max, mrope_pos=mrope_pos)
    s = xs[0].shape[1]
    return (_logits_mesh(sp, cfg, xs, call),
            _placed_caches(cfg, call, local, max(s, s_max)),
            _last_pos(call, s))


def _prefill_mesh(sp: specs.ShardedLM, cfg: ModelConfig, batch,
                  s_max: int):
    xs, call = embed_mesh(sp, cfg, batch["tokens"], batch.get("vis_embeds"))
    if cfg.family != "encdec":
        return prefill_embedded_mesh(sp, cfg, xs, call, s_max,
                                     batch.get("mrope_pos"))
    enc = _encode_mesh(sp, cfg, call, batch["src_emb"])
    xs, local = _decode_stack_mesh(sp, xs, cfg, call, mode="prefill",
                                   enc_outs=enc, s_max=s_max)
    del enc
    s = xs[0].shape[1]
    return (_logits_mesh(sp, cfg, xs, call),
            _placed_caches(cfg, call, local, max(s, s_max)),
            _last_pos(call, s))


def _decode_mesh(sp: specs.ShardedLM, cfg: ModelConfig, token, caches,
                 pos):
    xs, call = embed_mesh(sp, cfg, token)
    for _, t in specs.cache_leaves(caches):
        if not isinstance(t, (sharding.Placed, sharding.Joined)) or \
                t.mesh != sp.mesh:
            raise ValueError("decode on a mesh takes the placed caches "
                             "its prefill returned")
    local = [sharding.local_tree(caches, i) for i in range(sp.mesh.size)]
    pos = _per_block(pos, call)
    if cfg.family == "encdec":
        xs, _ = _decode_stack_mesh(sp, xs, cfg, call, mode="decode",
                                   caches=local, pos=pos)
    else:
        xs, _, _ = _run_stack_mesh(sp, xs, cfg, call, mode="decode",
                                   kvs=local, pos=pos)
    return _logits_mesh(sp, cfg, xs, call), caches


# ===========================================================================
# public API
# ===========================================================================

def forward_train(params: LM, cfg: ModelConfig, batch):
    """-> (logits [B,S,Vp], aux_loss), differentiable (the enc-dec family
    takes ``src_emb`` beside its target ``tokens``; its aux is 0).  Callers
    that only read it and hold parameters that require grad run it under
    ``torch.no_grad()``.  Over a mesh (a placed model) the logits are a
    `sharding.Placed` [B, S, Vp] (the batch over the data axes, the vocab
    over 'model' where the head is cut so), which `train_step.loss_fn`
    reads as it is placed."""
    if mesh_of(params, cfg) is not None:
        return _forward_train_mesh(params, cfg, batch)
    x = _embed_inputs(params, cfg, batch)
    if cfg.family == "encdec":
        x, _ = _decode_stack(params, cfg, x,
                             _encode(params, cfg, batch["src_emb"]),
                             mode="train")
        return _final_logits(params, cfg, x), torch.zeros((), device=x.device)
    x, _, aux = _run_stack(params, x, cfg, mode="train",
                           caches=_train_caches(cfg, x),
                           mrope_pos=batch.get("mrope_pos"))
    return _final_logits(params, cfg, x), aux


def _prefill_caches(cfg: ModelConfig, caches, s_max: int):
    """Grow the attention caches a prefill left to decode capacity."""
    if cfg.family in _ATTN:
        return _grow_caches(caches, s_max)
    if cfg.family == "hybrid":
        return caches._replace(attn=_grow_caches(caches.attn, s_max))
    return caches


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, batch, s_max: int):
    """Run the prompt; returns (last_logits [B,Vp], caches, last_pos [B]).
    Over a mesh (a placed model): the logits and caches are placed
    (`sharding.Placed`, mamba2's conv window a `sharding.Joined`),
    last_pos is whole on shard 0's device."""
    if mesh_of(params, cfg) is not None:
        return _prefill_mesh(params, cfg, batch, s_max)
    x = _embed_inputs(params, cfg, batch)
    if cfg.family == "encdec":
        x, caches = _decode_stack(params, cfg, x,
                                  _encode(params, cfg, batch["src_emb"]),
                                  mode="prefill", s_max=s_max)
    else:
        x, caches, _ = _run_stack(params, x, cfg, mode="prefill",
                                  caches=_train_caches(cfg, x), s_max=s_max,
                                  mrope_pos=batch.get("mrope_pos"))
        caches = _prefill_caches(cfg, caches, s_max)
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
    token's K/V rows and the SSM states are written into `caches` in place
    (the enc-dec family's cross K/V are read only).

    Returns (logits [B,Vp], caches); over a mesh the logits are placed and
    `caches` are the placed ones prefill returned, written in place."""
    if mesh_of(params, cfg) is not None:
        return _decode_mesh(params, cfg, token, caches, pos)
    x = _embed_inputs(params, cfg, {"tokens": token})
    if cfg.family == "encdec":
        x, caches = _decode_stack(params, cfg, x, None, mode="decode",
                                  caches=caches, pos=pos)
    else:
        x, caches, _ = _run_stack(params, x, cfg, mode="decode",
                                  caches=caches, pos=pos)
    return _final_logits(params, cfg, x)[:, 0], caches
