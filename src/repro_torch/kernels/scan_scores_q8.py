"""Quantized coarse scan: wrapper of the Hopper kernel ``csrc/scan_scores_q8.cu``.

Port of ``src/repro/kernels/scan_scores.py::scan_scores_q8`` (the Pallas TPU
kernel).  The per-query scalars travel as two f32[B] vectors (``sq``,
``corr``); the reference's [B, 128] sideband was a TPU layout.  A CPU tensor
takes the plain version (`ref.scan_scores_q8_plain`); a CUDA tensor launches
the kernel, or raises.  The kernel has two variants, ``stream`` and
``generic``; `variant_for` picks one from shapes and alignment (see
`scan_stream`).  A leading lane axis on every operand scans G
same-shaped collections in one launch; a 2-D call is a G = 1 launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spans import span
from repro_torch.kernels import build, ref, scan_stream

launches = build.LaunchCounter()
launches_by_variant = {v: build.LaunchCounter() for v in scan_stream.VARIANTS}
launches_by_lanes = scan_stream.lane_counters()
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _P)


def variant_for(b: int, n: int, d: int, *ptrs: int) -> str:
    """``stream`` or ``generic`` for B = b query code rows over n code rows
    of depth d (per lane), given the base addresses of qc and codes."""
    return scan_stream.choose(b, n, d, 1, ptrs)


def scan_scores_q8(qc: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
                   scales: torch.Tensor, zeros: torch.Tensor, sq: torch.Tensor,
                   corr: torch.Tensor, db_norms: torch.Tensor | None = None, *,
                   metric: str = "ip",
                   _variant: str | None = None) -> torch.Tensor:
    """Approximate scores f32[B, N] of int8 queries qc[B, D] (scales sq[B],
    corrections corr[B] = sq * sum(qc) over the real D) against the affine
    int8 rows codes[N, D] (per-row scales/zeros f32[N]); with a leading
    lane axis on every operand (qc [G, B, D], codes [G, N, D], ids, scales,
    zeros, db_norms [G, N], sq, corr [G, B]) f32[G, B, N] in one launch,
    lane g scanning only its own rows.

    ip: (qc . codes_n * sq) * scale_n + corr * zero_n, with an exact integer
    accumulator; l2: db_norms - 2 x that (db_norms, the dequantized rows'
    norms, is required).  Slots with ids < 0 score -inf (ip) or +inf (l2).
    """
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be 'ip' or 'l2', got {metric!r}")
    if qc.dim() not in (2, 3):
        raise ValueError(f"qc must be [B, D] or [G, B, D], got "
                         f"{tuple(qc.shape)}")
    if qc.device.type == "cpu":
        plain = ref.scan_scores_q8_lanes_plain if qc.dim() == 3 else \
            ref.scan_scores_q8_plain
        return plain(qc, codes, ids, scales, zeros, sq, corr, db_norms,
                     metric=metric)
    if qc.device.type != "cuda":
        raise TypeError(f"scan_scores_q8 runs on cpu or cuda, not {qc.device}")
    lane = qc.shape[:-2]                       # () or (G,)
    g, b, d = (qc.shape if lane else (1, *qc.shape))
    n = codes.shape[-2]
    if codes.shape != (*lane, n, d):
        raise ValueError(f"shapes qc{tuple(qc.shape)} codes"
                         f"{tuple(codes.shape)} do not match")
    if metric == "l2" and db_norms is None:
        raise ValueError("the q8 l2 scan needs the dequantized row norms")
    for name, t, dt, shape in (
            ("qc", qc, torch.int8, (*lane, b, d)),
            ("codes", codes, torch.int8, (*lane, n, d)),
            ("ids", ids, torch.int32, (*lane, n)),
            ("scales", scales, torch.float32, (*lane, n)),
            ("zeros", zeros, torch.float32, (*lane, n)),
            ("sq", sq, torch.float32, (*lane, b)),
            ("corr", corr, torch.float32, (*lane, b)),
            ("db_norms", db_norms, torch.float32, (*lane, n))):
        if t is None:
            continue
        if (t.device != qc.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"scan_scores_q8: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {qc.device}")
    scan_stream.check_lanes("scan_scores_q8", g)
    out = torch.empty((*lane, b, n), dtype=torch.float32, device=qc.device)
    if out.numel() == 0:
        return out
    # d % 16 == 0 keeps every lane's base as aligned as the first lane's
    vec16 = int(d % 16 == 0 and qc.data_ptr() % 16 == 0
                and codes.data_ptr() % 16 == 0)
    variant = scan_stream.check_forced(
        "scan_scores_q8", _variant,
        variant_for(b, n, d, qc.data_ptr(), codes.data_ptr()))
    fn = build.entry("scan_scores_q8", "scan_scores_q8_launch", _ARGTYPES)
    with span("ame.kernel.scan_scores_q8"), torch.cuda.device(qc.device):
        err = fn(qc.data_ptr(), codes.data_ptr(), ids.data_ptr(),
                 scales.data_ptr(), zeros.data_ptr(),
                 None if db_norms is None else db_norms.data_ptr(),
                 sq.data_ptr(), corr.data_ptr(), out.data_ptr(), g, b, n, d,
                 int(metric == "l2"), vec16, int(variant == "stream"),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("scan_scores_q8", err)
    launches.add()
    launches_by_variant[variant].add()
    launches_by_lanes[scan_stream.lane_key(g)].add()
    return out
