"""Engine configs mirroring the paper's evaluation setup (HotpotQA, BGE-large
d=1024); copy of ``src/repro/configs/ame_paper.py``.

The paper builds corpora of 10k / 100k / 1M vectors.  `PAPER_*` are the
tile-aligned AME configurations.
"""
import math

from repro_torch.configs.base import EngineConfig


def _cfg(n_vectors: int, **kw) -> EngineConfig:
    # sqrt(N) clusters rounded to a multiple of 128, paper-style
    c = max(128, int(round(math.sqrt(n_vectors) / 128.0)) * 128)
    cap = ((int(1.5 * n_vectors / c) + 7) // 8) * 8
    return EngineConfig(dim=1024, n_clusters=c, list_capacity=max(cap, 64), **kw)


PAPER_10K = _cfg(10_000, nprobe=16)
PAPER_100K = _cfg(100_000, nprobe=32)
PAPER_1M = _cfg(1_000_000, nprobe=64)

# Paper-faithful *unoptimized* ladder (Fig. 8: E -> A) is expressed via flags:
#   E  HVX-only, no TCM        -> use_kernel=False (plain PyTorch, no tiling)
#   D  +SMT                    -> folded into E
#   C  TCM via memcpy          -> fused_conversion=False (materialized bf16 copy)
#   B  TCM via DMA             -> use_kernel=True, fused_conversion=False
#   A  +execute-transfer overlap-> use_kernel=True, fused_conversion=True (full AME)
ABLATION_LADDER = {
    "E_jnp_unfused": dict(use_kernel=False, fused_conversion=False, aligned=True),
    "C_precopy_jnp": dict(use_kernel=False, fused_conversion=True, aligned=True),
    "B_kernel_precvt": dict(use_kernel=True, fused_conversion=False, aligned=True),
    "A_full_ame": dict(use_kernel=True, fused_conversion=True, aligned=True),
}
