"""Fused similarity scan: wrapper of the Hopper kernel ``csrc/scan_scores.cu``.

Port of ``src/repro/kernels/scan_scores.py::scan_scores`` (the Pallas TPU
kernel).  A CPU tensor takes the plain version (`ref.scan_scores_ref`); a
CUDA tensor launches the kernel, or raises.  The kernel has two variants,
``stream`` and ``generic``; `variant_for` picks one from shapes and alignment
(see `scan_stream`).  A leading lane axis on every operand scans G
same-shaped collections in one launch (a cross-collection fused query);
a 2-D call is a G = 1 launch of the same kernel.
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
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)


def variant_for(b: int, n: int, d: int, *ptrs: int) -> str:
    """``stream`` or ``generic`` for B = b queries over n rows of depth d
    (per lane), given the base addresses of q and db."""
    return scan_stream.choose(b, n, d, 4, ptrs)


def scan_scores(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                db_norms: torch.Tensor | None = None, *,
                metric: str = "ip", _variant: str | None = None) -> torch.Tensor:
    """Scores f32[B, N] of queries q f32[B, D] against rows db f32[N, D],
    or, with a leading lane axis, f32[G, B, N] of q f32[G, B, D] against
    db f32[G, N, D] (ids, db_norms [G, N]): lane g scans only its own rows,
    in one launch.

    ip: bf16(q) . bf16(db)^T with f32 accumulation; l2: db_norms - 2 x that
    (db_norms defaults to the rows' norms).  Slots with ids < 0 score -inf
    (ip) or +inf (l2).  `_variant` forces a kernel variant (for the card
    tests and ``chip_smoke.py``; the main path never passes it).
    """
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be 'ip' or 'l2', got {metric!r}")
    if q.dim() not in (2, 3):
        raise ValueError(f"q must be [B, D] or [G, B, D], got {tuple(q.shape)}")
    if q.device.type == "cpu":
        plain = ref.scan_scores_lanes_ref if q.dim() == 3 else \
            ref.scan_scores_ref
        return plain(q, db, ids, db_norms, metric=metric)
    if q.device.type != "cuda":
        raise TypeError(f"scan_scores runs on cpu or cuda, not {q.device}")
    lanes = q.dim() == 3
    g, b, d = q.shape if lanes else (1, *q.shape)
    n = db.shape[-2]
    if db.shape != ((g, n, d) if lanes else (n, d)) or \
            ids.shape != db.shape[:-1]:
        raise ValueError(f"shapes q{tuple(q.shape)} db{tuple(db.shape)} "
                         f"ids{tuple(ids.shape)} do not match")
    if metric == "l2" and db_norms is None:
        db_norms = (ref.round_bf16(db) ** 2).sum(-1)
    for name, t, dt in (("q", q, torch.float32), ("db", db, torch.float32),
                        ("ids", ids, torch.int32),
                        ("db_norms", db_norms, torch.float32)):
        if t is None:
            continue
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"scan_scores: {name} must be a contiguous "
                             f"{dt} tensor on {q.device}")
    if db_norms is not None and db_norms.shape != ids.shape:
        raise ValueError(f"db_norms{tuple(db_norms.shape)} != "
                         f"{tuple(ids.shape)}")
    scan_stream.check_lanes("scan_scores", g)
    out = torch.empty((*q.shape[:-1], n), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    # d % 4 == 0 keeps every lane's base as aligned as the first lane's
    vec4 = int(d % 4 == 0 and q.data_ptr() % 16 == 0
               and db.data_ptr() % 16 == 0)
    variant = scan_stream.check_forced(
        "scan_scores", _variant,
        variant_for(b, n, d, q.data_ptr(), db.data_ptr()))
    fn = build.entry("scan_scores", "scan_scores_launch", _ARGTYPES)
    with span("ame.kernel.scan_scores"), torch.cuda.device(q.device):
        err = fn(q.data_ptr(), db.data_ptr(), ids.data_ptr(),
                 None if db_norms is None else db_norms.data_ptr(),
                 out.data_ptr(), g, b, n, d, int(metric == "l2"), vec4,
                 int(variant == "stream"),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("scan_scores", err)
    launches.add()
    launches_by_variant[variant].add()
    launches_by_lanes[scan_stream.lane_key(g)].add()
    return out
