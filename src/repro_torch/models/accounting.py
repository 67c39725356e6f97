"""Analytic parameter / FLOP accounting (roofline cross-checks; a copy of
``src/repro/models/accounting.py``).

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per the spec; attention
S^2 terms are reported separately by the roofline module.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _attn_params(cfg: ModelConfig, heads: int) -> int:
    d, dh, kvh = cfg.d_model, cfg.head_dim, cfg.num_kv_heads
    return d * heads * dh + 2 * d * kvh * dh + heads * dh * d


def _mlp_params(d: int, f: int) -> int:
    return 3 * d * f


def _mamba_params(cfg: ModelConfig) -> int:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    d_xbc = di + 2 * n
    in_proj = d * (d_xbc + di + h)
    conv = cfg.ssm_conv_width * d_xbc
    return in_proj + conv + 3 * h + di + di * d


def _rwkv_params(cfg: ModelConfig) -> int:
    d, f = cfg.d_model, cfg.d_ff
    time_mix = 6 * d * d + 7 * d + (d // cfg.ssm_head_dim) * cfg.ssm_head_dim
    channel_mix = d * d + 2 * d * f + 2 * d
    return time_mix + channel_mix


def layer_params(cfg: ModelConfig) -> int:
    """Parameters of one repeated layer (excluding shared/embedding)."""
    from repro_torch.models.lm import heads_padded
    h = heads_padded(cfg)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return _attn_params(cfg, h) + _mlp_params(cfg.d_model, cfg.d_ff)
    if fam == "moe":
        routed = cfg.num_experts * _mlp_params(cfg.d_model, cfg.d_ff_expert)
        shared = (_mlp_params(cfg.d_model,
                              cfg.num_shared_experts * cfg.d_ff_expert)
                  if cfg.num_shared_experts else 0)
        router = cfg.d_model * cfg.num_experts
        return _attn_params(cfg, h) + routed + shared + router
    if fam == "ssm":
        return _rwkv_params(cfg)
    if fam == "hybrid":
        return _mamba_params(cfg)
    if fam == "encdec":
        # one encoder layer; decoder layers add cross-attn (handled in total)
        return _attn_params(cfg, h) + _mlp_params(cfg.d_model, cfg.d_ff)
    raise ValueError(fam)


def moe_active_layer_params(cfg: ModelConfig) -> int:
    act = cfg.moe_top_k * _mlp_params(cfg.d_model, cfg.d_ff_expert)
    shared = (_mlp_params(cfg.d_model, cfg.num_shared_experts * cfg.d_ff_expert)
              if cfg.num_shared_experts else 0)
    from repro_torch.models.lm import heads_padded
    return _attn_params(cfg, heads_padded(cfg)) + act + shared + \
        cfg.d_model * cfg.num_experts


def param_count(cfg: ModelConfig) -> int:
    emb = cfg.vocab_padded * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_padded * cfg.d_model
    fam = cfg.family
    if fam == "encdec":
        from repro_torch.models.lm import heads_padded
        h = heads_padded(cfg)
        enc = cfg.num_enc_layers * layer_params(cfg)
        dec = cfg.num_dec_layers * (layer_params(cfg) + _attn_params(cfg, h))
        return emb + head + enc + dec
    if fam == "hybrid":
        from repro_torch.models.lm import heads_padded
        shared_blk = _attn_params(cfg, heads_padded(cfg)) + \
            _mlp_params(cfg.d_model, cfg.d_ff)
        return emb + head + cfg.num_layers * layer_params(cfg) + shared_blk
    return emb + head + cfg.num_layers * layer_params(cfg)


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (= param_count except MoE routing)."""
    if cfg.family != "moe":
        return param_count(cfg)
    emb = cfg.vocab_padded * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_padded * cfg.d_model
    return emb + head + cfg.num_layers * moe_active_layer_params(cfg)


# norm scales the analytic count leaves out: the blocks' pre/post norms,
# the q/k norms and the final norms (the SSM mixers' own vectors count)
_UNCOUNTED = {"ln1", "ln2", "ln", "ln_attn", "ln_mlp", "ln_attn_post",
              "ln_mlp_post", "ln_cross", "q_norm", "k_norm", "final_norm",
              "enc_final_norm"}


def counted_params(model) -> int:
    """The parameters of a port model (`repro_torch.models.lm.LM`) that
    `param_count` counts: all but the norm scales it ignores."""
    return sum(p.numel() for name, p in model.named_parameters()
               if name.rsplit(".", 1)[-1] not in _UNCOUNTED)
