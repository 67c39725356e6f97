"""Deterministic segmented sum: wrapper of ``csrc/segsum_gemm.cu``.

Port of ``src/repro/kernels/segsum_gemm.py::segsum_gemm`` (the Pallas TPU
kernel, a one-hot GEMM).  Like that kernel it sums bf16-rounded rows in f32,
so its plain version is `ref.segsum_gemm_ref` over bf16-rounded rows.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spans import span
from repro_torch.kernels import build, ref

launches = build.LaunchCounter()
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P)


def segsum_gemm_plain(x, assign, *, n_clusters):
    """The kernel's arithmetic in plain PyTorch: bf16-rounded rows."""
    return ref.segsum_gemm_ref(ref.round_bf16(x), assign,
                               n_clusters=n_clusters)


def segsum_gemm(x: torch.Tensor, assign: torch.Tensor, *, n_clusters: int):
    """(sums f32[C, D], counts f32[C]): per-cluster sums of bf16(x) rows in
    f32 and exact row counts; rows with assign outside [0, C) are ignored.
    On the card the rows of a cluster are summed in row order, so one input
    always gives bit-identical sums."""
    if x.device.type == "cpu":
        return segsum_gemm_plain(x, assign, n_clusters=n_clusters)
    if x.device.type != "cuda":
        raise TypeError(f"segsum_gemm runs on cpu or cuda, not {x.device}")
    m, d = x.shape
    c = int(n_clusters)
    if assign.shape != (m,) or c <= 0 or d == 0:
        raise ValueError(f"shapes x{tuple(x.shape)} assign"
                         f"{tuple(assign.shape)} n_clusters={c} do not match")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("segsum_gemm: x must be a contiguous float32 tensor")
    if assign.device != x.device or assign.dtype != torch.int32:
        raise ValueError(f"segsum_gemm: assign must be int32 on {x.device}")
    # stable grouping of the valid rows by cluster: cluster c owns
    # order[starts[c] : starts[c] + counts[c]], in row order
    key = torch.where((assign >= 0) & (assign < c), assign,
                      torch.full_like(assign, c)).long()
    order = torch.argsort(key, stable=True).to(torch.int32)
    cnt = torch.bincount(key, minlength=c + 1)[:c]
    starts = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    cnt = cnt.to(torch.int32)
    sums = torch.empty((c, d), dtype=torch.float32, device=x.device)
    counts = torch.empty((c,), dtype=torch.float32, device=x.device)
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    fn = build.entry("segsum_gemm", "segsum_gemm_launch", _ARGTYPES)
    with span("ame.kernel.segsum_gemm"), torch.cuda.device(x.device):
        err = fn(x.data_ptr(), order.data_ptr(), starts.data_ptr(),
                 cnt.data_ptr(), sums.data_ptr(), counts.data_ptr(), c, d,
                 vec4, torch.cuda.current_stream().cuda_stream)
    build.check_launch("segsum_gemm", err)
    launches.add()
    return sums, counts
