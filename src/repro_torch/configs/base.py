"""Memory-engine configuration (copy of ``EngineConfig`` from
``src/repro/configs/base.py``, the port's own, so that it imports no JAX).

A frozen dataclass with the reference's fields, defaults and checks, so both
packages describe an engine with the same key.  ``interpret`` is kept for
field parity and has no meaning in the port.
"""
from __future__ import annotations

from dataclasses import dataclass


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
