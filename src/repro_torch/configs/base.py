"""Config dataclasses for models, shapes, training, the memory engine and
the roofline's hardware (copies of ``ModelConfig``, ``ShapeConfig``/
``SHAPES``, ``TrainConfig``, ``EngineConfig`` and ``HardwareConfig`` from
``src/repro/configs/base.py``, the port's own, so that it imports no JAX;
``HardwareConfig`` holds one H100's figures, `H100`).

Frozen dataclasses with the reference's fields, defaults, properties and
checks, so both packages describe a model or an engine with the same key.
``EngineConfig.interpret``, ``ModelConfig.scan_period`` and
``TrainConfig.remat_policy`` are kept for field parity: the port runs no
interpreter and scans no layers, and as in the reference only the dry run
reads the remat policy (``ModelConfig.remat`` switches the per-layer
recompute).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture. `family` selects the block wiring."""

    name: str
    family: str                      # dense | moe | encdec | hybrid | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0             # per-expert hidden (fine-grained MoE)
    capacity_factor: float = 1.25

    # --- attention details ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # gemma2: 4096
    alt_local_global: bool = False   # gemma2: even layers local, odd global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False
    parallel_block: bool = False     # stablelm-2: attn & mlp in parallel
    post_norm: bool = False          # gemma2: sandwich (pre+post) norms

    # --- SSM / hybrid ---
    ssm_state: int = 0               # mamba2 N / rwkv head size
    ssm_expand: int = 2              # mamba2 d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    shared_block_period: int = 0     # zamba2: shared attn block every P mamba blocks

    # --- encoder-decoder ---
    num_enc_layers: int = 0
    num_dec_layers: int = 0

    # --- VLM ---
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl: (t, h, w) head_dim halves

    # --- misc ---
    act: str = "silu"                # silu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    emb_scale: bool = False          # gemma: scale embeddings by sqrt(d_model)
    scan_period: int = 1             # layers folded into one scan step
    remat: bool = True
    dtype: str = "bfloat16"
    source: str = ""                 # provenance note

    # ------------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if a 500k-token KV/state is tractable (long_500k eligibility)."""
        return self.family in ("ssm", "hybrid")

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the embedding table shards over 16 and tiles over 128."""
        return _round_up(self.vocab_size, 2048)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def n_periods(self) -> int:
        assert self.num_layers % max(self.scan_period, 1) == 0
        return self.num_layers // max(self.scan_period, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline cross-check)."""
        from repro_torch.models import accounting
        return accounting.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import accounting
        return accounting.active_param_count(self)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    grad_accum: int = 1
    grad_compression: str = "none"   # none | bf16 | int8
    remat_policy: str = "block"      # none | block | full
    seed: int = 0


# ---------------------------------------------------------------------------
# Memory engine (the paper's contribution)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EngineConfig:
    """AME agentic-memory engine configuration.

    The `aligned` / `fused_conversion` / `pipelined` flags select between the
    paper-faithful optimized path and deliberately-degraded baselines used in
    the ablation benchmarks (paper Fig. 8 / Fig. 9).
    """

    dim: int = 1024                  # embedding dim (BGE-large = 1024)
    n_clusters: int = 1024           # multiple of 128 when aligned
    list_capacity: int = 512         # slots per IVF list, multiple of 8
    nprobe: int = 32
    k: int = 16
    metric: str = "ip"               # ip | l2
    store_dtype: str = "float32"     # scan-store dtype policy: float32 | int8
    compute_dtype: str = "bfloat16"  # tensor-core operand dtype
    rescore_k: int = 128             # int8 policy: coarse survivors rescored
                                     # exactly in f32 (clamped to >= k)

    # ablation switches (paper Fig. 8 ladder)
    aligned: bool = True             # tile-aligned cluster count / padding
    fused_conversion: bool = True    # fp32->bf16 inside the kernel (vs pre-copy)
    use_kernel: bool = True          # Hopper kernels vs plain PyTorch versions
    interpret: bool = True           # field parity with the reference; unused

    # scheduler
    window: int = 8                  # windowed batch submission size
    kmeans_iters: int = 10

    # distributed
    shard_db: bool = False           # shard lists over the mesh data axes

    # index policy & recall-adaptive routing
    index_policy: str = "ivf"        # ivf | flat | hnsw | auto (size-based)
    target_recall: float = 0.0       # > 0 enables the recall probe + tuner
    hnsw_m: int = 16                 # HNSW graph degree (policy "hnsw"/"auto")
    hnsw_ef: int = 96                # HNSW search beam width (tuner-owned)

    def __post_init__(self):
        if self.index_policy not in ("ivf", "flat", "hnsw", "auto"):
            raise ValueError(
                f"EngineConfig.index_policy {self.index_policy!r} is not "
                "supported; use 'ivf', 'flat', 'hnsw', or 'auto'")
        if self.shard_db and self.index_policy in ("hnsw", "flat"):
            raise ValueError(
                "EngineConfig.shard_db serves queries via the per-shard "
                "fused scan + hierarchical merge; index_policy must be "
                f"'ivf' or 'auto' (got {self.index_policy!r})")
        if not 0.0 <= self.target_recall <= 1.0:
            raise ValueError("EngineConfig.target_recall must be in [0, 1] "
                             f"(got {self.target_recall})")
        if self.hnsw_m < 2:
            raise ValueError(f"EngineConfig.hnsw_m must be >= 2 (got {self.hnsw_m})")
        if self.hnsw_ef < 1:
            raise ValueError(f"EngineConfig.hnsw_ef must be >= 1 (got {self.hnsw_ef})")
        if self.store_dtype not in ("float32", "int8"):
            raise ValueError(
                f"EngineConfig.store_dtype {self.store_dtype!r} is not "
                "supported; use 'float32' (exact row store) or 'int8' "
                "(quantized coarse-scan store + exact f32 rescore)")
        if self.rescore_k < 1:
            raise ValueError("EngineConfig.rescore_k must be >= 1 "
                             f"(got {self.rescore_k})")
        if self.aligned:
            assert self.n_clusters % 128 == 0, "aligned engine: n_clusters % 128"
            assert self.dim % 128 == 0, "aligned engine: dim % 128"
            assert self.list_capacity % 8 == 0, "aligned engine: list_capacity % 8"

    @property
    def capacity(self) -> int:
        return self.n_clusters * self.list_capacity

    @property
    def quantized(self) -> bool:
        """True when the scan store is int8 (coarse scan + f32 rescore)."""
        return self.store_dtype == "int8"


# ---------------------------------------------------------------------------
# Roofline hardware model (one NVIDIA H100)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareConfig:
    """The reference's fields, with the figures of one H100 SXM5 80GB
    (NVIDIA's data sheet, dense rates at the 700 W limit).  The reference's
    default is a TPU; the port has no TPU figure, so its default is the
    H100 (`H100`)."""

    name: str = "h100_sxm5_80gb"
    peak_flops_bf16: float = 989e12      # dense bf16 tensor-core FLOP/s
    hbm_bandwidth: float = 3.35e12       # HBM3 bytes/s
    ici_bandwidth: float = 450e9         # NVLink bytes/s, one direction
    dcn_bandwidth: float = 0.0           # no link between hosts: one card
    hbm_bytes: float = 80e9              # device memory
    # the on-chip scratch a kernel tiles into: a block's shared memory
    # (232,448 bytes of the SM's 256 KB)
    vmem_bytes: float = 232_448
    # the matrix unit's tile: one warpgroup's wgmma, 64 rows x up to 256
    mxu_tile: Tuple[int, int] = (64, 256)


H100 = HardwareConfig()
