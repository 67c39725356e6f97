"""The 10 assigned architectures, exact configs from the public pool (a
copy of ``src/repro/configs/archs.py``).

Each also exposes `reduced()` — a tiny same-family config for CPU smoke tests.
`registry.get_arch` looks them up by name (the reference's ten-line
per-arch modules `configs/<id>.py` have no counterpart here yet).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

OLMOE_1B_7B = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    num_experts=64, num_shared_experts=0, moe_top_k=8, d_ff_expert=1024,
    qk_norm=True, rope_theta=10_000.0,
    source="arXiv:2409.02060; hf",
)

DEEPSEEK_MOE_16B = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    num_experts=64, num_shared_experts=2, moe_top_k=6, d_ff_expert=1408,
    rope_theta=10_000.0,
    source="arXiv:2401.06066; hf (2 shared + 64 routed, fine-grained)",
)

# --------------------------------------------------------------------------
# Dense
# --------------------------------------------------------------------------

STABLELM_12B = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=160,
    d_ff=13824, vocab_size=100352,
    parallel_block=True, qk_norm=True, rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-12b; hf",
)

GEMMA2_27B = ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    sliding_window=4096, alt_local_global=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    act="gelu", emb_scale=True, tie_embeddings=True, post_norm=True,
    source="arXiv:2408.00118; hf",
)

GEMMA2_9B = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    sliding_window=4096, alt_local_global=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    act="gelu", emb_scale=True, tie_embeddings=True, post_norm=True,
    source="arXiv:2408.00118; hf",
)

GRANITE_3_2B = ModelConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155,
    rope_theta=10_000.0, tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)

# --------------------------------------------------------------------------
# Encoder-decoder (audio frontend stubbed)
# --------------------------------------------------------------------------

SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=48, num_enc_layers=24, num_dec_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    act="gelu", norm_eps=1e-5,
    source="arXiv:2308.11596; hf (enc-dec; speech frontend stubbed)",
)

# --------------------------------------------------------------------------
# Hybrid / SSM
# --------------------------------------------------------------------------

ZAMBA2_2_7B = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, shared_block_period=6,
    scan_period=6,
    source="arXiv:2411.15242; hf (Mamba2 backbone + shared attn block)",
)

RWKV6_1_6B = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=0, head_dim=64,
    d_ff=7168, vocab_size=65536,
    ssm_state=64, ssm_head_dim=64,
    source="arXiv:2404.05892; unverified (Finch, data-dependent decay)",
)

# --------------------------------------------------------------------------
# VLM (vision tower stubbed)
# --------------------------------------------------------------------------

QWEN2_VL_7B = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    mrope_sections=(16, 24, 24),   # head_dim/2 = 64 = 16+24+24
    rope_theta=1_000_000.0,
    source="arXiv:2409.12191; hf (M-RoPE; vision tower stubbed)",
)

ALL_ARCHS = {
    c.name: c for c in (
        OLMOE_1B_7B, DEEPSEEK_MOE_16B, STABLELM_12B, GEMMA2_27B, GEMMA2_9B,
        GRANITE_3_2B, SEAMLESS_M4T_LARGE_V2, ZAMBA2_2_7B, RWKV6_1_6B,
        QWEN2_VL_7B,
    )
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one scan period kept)."""
    kw = dict(
        num_layers=2 * max(cfg.scan_period, 1) if cfg.family != "hybrid" else 2 * cfg.scan_period,
        d_model=128,
        num_heads=4, num_kv_heads=min(max(cfg.num_kv_heads, 1), 2) if cfg.num_kv_heads else 0,
        head_dim=32, d_ff=256, vocab_size=512,
        remat=False,
    )
    if cfg.family == "moe":
        kw.update(num_experts=4, moe_top_k=2, d_ff_expert=64,
                  num_shared_experts=cfg.num_shared_experts)
    if cfg.family == "encdec":
        kw.update(num_layers=4, num_enc_layers=2, num_dec_layers=2)
    if cfg.family in ("hybrid", "ssm"):
        kw.update(ssm_state=16, ssm_head_dim=16, d_model=128)
    if cfg.family == "hybrid":
        kw.update(shared_block_period=cfg.scan_period, num_heads=4, num_kv_heads=4)
    if cfg.family == "vlm":
        kw.update(mrope_sections=(4, 6, 6), head_dim=32)
    if cfg.family == "ssm":
        kw.update(num_heads=8, num_kv_heads=0)
    return cfg.replace(**kw)
