"""Quantized coarse scan: wrapper of the Hopper kernel ``csrc/scan_scores_q8.cu``.

Port of ``src/repro/kernels/scan_scores.py::scan_scores_q8`` (the Pallas TPU
kernel).  The per-query scalars travel as two f32[B] vectors (``sq``,
``corr``); the reference's [B, 128] sideband was a TPU layout.  A CPU tensor
takes the plain version (`ref.scan_scores_q8_plain`); a CUDA tensor launches
the kernel, or raises.  The kernel has two variants, ``stream`` and
``generic``; `variant_for` picks one from shapes and alignment (see
`scan_stream`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref, scan_stream

launches = build.LaunchCounter()
launches_by_variant = {v: build.LaunchCounter() for v in scan_stream.VARIANTS}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def variant_for(b: int, n: int, d: int, *ptrs: int) -> str:
    """``stream`` or ``generic`` for B = b query code rows over n code rows
    of depth d, given the base addresses of qc and codes."""
    return scan_stream.choose(b, n, d, 1, ptrs)


def scan_scores_q8(qc: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
                   scales: torch.Tensor, zeros: torch.Tensor, sq: torch.Tensor,
                   corr: torch.Tensor, db_norms: torch.Tensor | None = None, *,
                   metric: str = "ip",
                   _variant: str | None = None) -> torch.Tensor:
    """Approximate scores f32[B, N] of int8 queries qc[B, D] (scales sq[B],
    corrections corr[B] = sq * sum(qc) over the real D) against the affine
    int8 rows codes[N, D] (per-row scales/zeros f32[N]).

    ip: (qc . codes_n * sq) * scale_n + corr * zero_n, with an exact integer
    accumulator; l2: db_norms - 2 x that (db_norms, the dequantized rows'
    norms, is required).  Slots with ids < 0 score -inf (ip) or +inf (l2).
    """
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be 'ip' or 'l2', got {metric!r}")
    if qc.device.type == "cpu":
        return ref.scan_scores_q8_plain(qc, codes, ids, scales, zeros, sq,
                                        corr, db_norms, metric=metric)
    if qc.device.type != "cuda":
        raise TypeError(f"scan_scores_q8 runs on cpu or cuda, not {qc.device}")
    b, d = qc.shape
    n = codes.shape[0]
    if codes.shape != (n, d):
        raise ValueError(f"shapes qc{tuple(qc.shape)} codes"
                         f"{tuple(codes.shape)} do not match")
    if metric == "l2" and db_norms is None:
        raise ValueError("the q8 l2 scan needs the dequantized row norms")
    for name, t, dt, shape in (
            ("qc", qc, torch.int8, (b, d)), ("codes", codes, torch.int8, (n, d)),
            ("ids", ids, torch.int32, (n,)),
            ("scales", scales, torch.float32, (n,)),
            ("zeros", zeros, torch.float32, (n,)),
            ("sq", sq, torch.float32, (b,)), ("corr", corr, torch.float32, (b,)),
            ("db_norms", db_norms, torch.float32, (n,))):
        if t is None:
            continue
        if (t.device != qc.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"scan_scores_q8: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {qc.device}")
    out = torch.empty((b, n), dtype=torch.float32, device=qc.device)
    if out.numel() == 0:
        return out
    vec16 = int(d % 16 == 0 and qc.data_ptr() % 16 == 0
                and codes.data_ptr() % 16 == 0)
    variant = scan_stream.check_forced(
        "scan_scores_q8", _variant,
        variant_for(b, n, d, qc.data_ptr(), codes.data_ptr()))
    fn = build.entry("scan_scores_q8", "scan_scores_q8_launch", _ARGTYPES)
    with torch.cuda.device(qc.device):
        err = fn(qc.data_ptr(), codes.data_ptr(), ids.data_ptr(),
                 scales.data_ptr(), zeros.data_ptr(),
                 None if db_norms is None else db_norms.data_ptr(),
                 sq.data_ptr(), corr.data_ptr(), out.data_ptr(), b, n, d,
                 int(metric == "l2"), vec16, int(variant == "stream"),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("scan_scores_q8", err)
    launches.add()
    launches_by_variant[variant].add()
    return out
