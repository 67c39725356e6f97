"""Streaming k-means assignment: wrapper of ``csrc/kmeans_assign.cu``.

Port of ``src/repro/kernels/kmeans_assign.py::kmeans_assign`` (the Pallas
TPU kernel).  A CPU tensor takes the plain version
(`ref.kmeans_assign_ref`); a CUDA tensor launches the kernel, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = build.LaunchCounter()
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  fused_conversion: bool = True):
    """(idx i32[M], dist f32[M]): nearest centroid of each row of x f32[M, D]
    under ||c||^2 - 2 x.c (the rank-invariant ||x||^2 dropped), lowest index
    on a tie.  The products are bf16(x) . bf16(c) with f32 accumulation;
    `fused_conversion=False` (an ablation rung) multiplies in f32."""
    if x.device.type == "cpu":
        return ref.kmeans_assign_ref(x, centroids,
                                     fused_conversion=fused_conversion)
    if x.device.type != "cuda":
        raise TypeError(f"kmeans_assign runs on cpu or cuda, not {x.device}")
    m, d = x.shape
    c = centroids.shape[0]
    if centroids.shape != (c, d) or c == 0 or d == 0:
        raise ValueError(f"shapes x{tuple(x.shape)} centroids"
                         f"{tuple(centroids.shape)} do not match")
    for name, t in (("x", x), ("centroids", centroids)):
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"kmeans_assign: {name} must be a contiguous "
                             f"float32 tensor on {x.device}")
    idx = torch.empty((m,), dtype=torch.int32, device=x.device)
    dist = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return idx, dist
    cnorm = (centroids ** 2).sum(1)
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0
               and centroids.data_ptr() % 16 == 0)
    fn = build.entry("kmeans_assign", "kmeans_assign_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), centroids.data_ptr(), cnorm.data_ptr(),
                 idx.data_ptr(), dist.data_ptr(), m, c, d, vec4,
                 int(not fused_conversion),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("kmeans_assign", err)
    launches.add()
    return idx, dist
