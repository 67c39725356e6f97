"""k-means for IVF build/rebuild, GEMM-native end to end; port of
``src/repro/core/kmeans.py``.

Assignment = the `kmeans_assign` kernel; centroid update = the `segsum_gemm`
segmented sum.  Random draws come from a `torch.Generator`; a caller that
needs the reference's draws (the parity tests) passes them in through
`seed_idx` and `reseed_idx`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.kernels import ops


def _gumbel_topk(gen: torch.Generator, valid: torch.Tensor,
                 c: int) -> torch.Tensor:
    """c distinct valid row indices, uniformly drawn (Gumbel top-k)."""
    u = torch.rand(valid.shape, generator=gen, device=valid.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    g = g + torch.where(valid, 0.0, -1e30)
    return torch.topk(g, c).indices


def kmeans(gen: torch.Generator, x: torch.Tensor, valid: torch.Tensor,
           cfg: EngineConfig, n_clusters: Optional[int] = None,
           iters: Optional[int] = None, *,
           seed_idx: Optional[torch.Tensor] = None,
           reseed_idx: Optional[Sequence[torch.Tensor]] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means over the valid rows of x f32[M, D].

    Returns (centroids f32[C, D], assignments i32[M]; -1 for invalid rows).
    Empty clusters are re-seeded from random valid rows each iteration.
    `seed_idx` i64[C] replaces the initial draw and `reseed_idx[i]` i64[C]
    the re-seed draw of iteration i.
    """
    c = n_clusters or cfg.n_clusters
    iters = iters or cfg.kmeans_iters
    if seed_idx is None:
        seed_idx = _gumbel_topk(gen, valid, c)
    centroids = x[seed_idx.to(x.device)]
    for i in range(iters):
        idx, _ = ops.kmeans_assign(
            x, centroids, use_kernel=cfg.use_kernel,
            fused_conversion=cfg.fused_conversion)
        idx = torch.where(valid, idx, -1).to(torch.int32)
        sums, counts = ops.segsum_gemm(x, idx, n_clusters=c,
                                       use_kernel=cfg.use_kernel)
        new = sums / counts.clamp_min(1.0)[:, None]
        rs = (reseed_idx[i] if reseed_idx is not None
              else _gumbel_topk(gen, valid, c))
        new = torch.where((counts > 0)[:, None], new, x[rs.to(x.device)])
        if cfg.metric == "ip":
            # spherical k-means: normalized centroids rank by inner product
            new = new / torch.linalg.norm(new, dim=1,
                                          keepdim=True).clamp_min(1e-6)
        centroids = new.contiguous()
    final_idx, _ = ops.kmeans_assign(
        x, centroids, use_kernel=cfg.use_kernel,
        fused_conversion=cfg.fused_conversion)
    return centroids, torch.where(valid, final_idx, -1).to(torch.int32)
