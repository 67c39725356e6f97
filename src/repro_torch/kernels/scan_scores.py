"""Fused similarity scan: wrapper of the Hopper kernel ``csrc/scan_scores.cu``.

Port of ``src/repro/kernels/scan_scores.py::scan_scores`` (the Pallas TPU
kernel).  A CPU tensor takes the plain version (`ref.scan_scores_ref`); a
CUDA tensor launches the kernel, or raises.  The kernel has two variants,
``stream`` and ``generic``; `variant_for` picks one from shapes and alignment
(see `scan_stream`).  A leading lane axis on every operand scans G
same-shaped collections in one launch (a cross-collection fused query);
a 2-D call is a G = 1 launch of the same kernel.  The rows may come in two
segments (``db``, ``ids`` then ``db2``, ``ids2``) scored as one: a full
scan reads an index's list tier and spill tier where they lie, with no
concatenated copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spans import span
from repro_torch.kernels import build, ref, scan_stream

launches = build.LaunchCounter()
launches_by_variant = {v: build.LaunchCounter() for v in scan_stream.VARIANTS}
launches_by_lanes = scan_stream.lane_counters()
launches_two_segment = build.LaunchCounter()  # launches that read a db2
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _P)


def variant_for(b: int, n: int, d: int, *ptrs: int) -> str:
    """``stream`` or ``generic`` for B = b queries over n rows of depth d
    (per lane, both segments), given the base addresses of q and of each
    segment of rows."""
    return scan_stream.choose(b, n, d, 4, ptrs)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def scan_scores(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                db_norms: torch.Tensor | None = None, *,
                metric: str = "ip", db2: torch.Tensor | None = None,
                ids2: torch.Tensor | None = None,
                db2_norms: torch.Tensor | None = None,
                _variant: str | None = None) -> torch.Tensor:
    """Scores f32[B, N] of queries q f32[B, D] against rows db f32[N, D],
    or, with a leading lane axis, f32[G, B, N] of q f32[G, B, D] against
    db f32[G, N, D] (ids, db_norms [G, N]): lane g scans only its own rows,
    in one launch.

    `db2` f32[(G,) N2, D] with `ids2` (and, beside db_norms, `db2_norms`)
    [(G,) N2] is a second segment of rows, scored after db's N1 rows as if
    the two were concatenated: f32[(G,) B, N1 + N2], each score the
    one-segment scan's of the concatenated rows, bit for bit.

    ip: bf16(q) . bf16(db)^T with f32 accumulation; l2: db_norms - 2 x that
    (db_norms defaults to the rows' norms).  Slots with ids < 0 score -inf
    (ip) or +inf (l2).  `_variant` forces a kernel variant (for the card
    tests and ``chip_smoke.py``; the main path never passes it).
    """
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be 'ip' or 'l2', got {metric!r}")
    if q.dim() not in (2, 3):
        raise ValueError(f"q must be [B, D] or [G, B, D], got {tuple(q.shape)}")
    if (db2 is None) != (ids2 is None) or (
            db2 is not None and (db_norms is None) != (db2_norms is None)):
        raise ValueError("scan_scores: db2 comes with ids2, and db2_norms "
                         "with db_norms")
    if q.device.type == "cpu":
        plain = ref.scan_scores_lanes_ref if q.dim() == 3 else \
            ref.scan_scores_ref
        return plain(q, db, ids, db_norms, metric=metric, db2=db2, ids2=ids2,
                     db2_norms=db2_norms)
    if q.device.type != "cuda":
        raise TypeError(f"scan_scores runs on cpu or cuda, not {q.device}")
    lanes = q.dim() == 3
    g, b, d = q.shape if lanes else (1, *q.shape)
    segs = [(db, ids, db_norms)]
    if db2 is not None:
        segs.append((db2, ids2, db2_norms))
    for rows, rids, _ in segs:
        n = rows.shape[-2]
        if rows.shape != ((g, n, d) if lanes else (n, d)) or \
                rids.shape != rows.shape[:-1]:
            raise ValueError(f"shapes q{tuple(q.shape)} db{tuple(rows.shape)} "
                             f"ids{tuple(rids.shape)} do not match")
    if len(segs) == 2 and db2.shape[-2] == 0:
        segs.pop()                      # an empty second segment: one
    if metric == "l2":
        segs = [(rows, rids, (ref.round_bf16(rows) ** 2).sum(-1)
                 if nrm is None else nrm) for rows, rids, nrm in segs]
    checks = [("q", q, torch.float32)]
    for i, (rows, rids, nrm) in enumerate(segs):
        tag = "2" if i else ""
        checks += [(f"db{tag}", rows, torch.float32),
                   (f"ids{tag}", rids, torch.int32),
                   (f"db{tag}_norms", nrm, torch.float32)]
        if nrm is not None and nrm.shape != rids.shape:
            raise ValueError(f"db{tag}_norms{tuple(nrm.shape)} != "
                             f"{tuple(rids.shape)}")
    for name, t, dt in checks:
        if t is None:
            continue
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"scan_scores: {name} must be a contiguous "
                             f"{dt} tensor on {q.device}")
    scan_stream.check_lanes("scan_scores", g)
    segs += [(None, None, None)] * (2 - len(segs))
    (db, ids, db_norms), (db2, ids2, db2_norms) = segs
    n1, n2 = db.shape[-2], 0 if db2 is None else db2.shape[-2]
    out = torch.empty((*q.shape[:-1], n1 + n2), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    # d % 4 == 0 keeps every lane's base as aligned as the first lane's
    ptrs = [t.data_ptr() for t in (q, db, db2) if t is not None]
    vec4 = int(d % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    variant = scan_stream.check_forced(
        "scan_scores", _variant, variant_for(b, n1 + n2, d, *ptrs))
    fn = build.entry("scan_scores", "scan_scores_launch", _ARGTYPES)
    with span("ame.kernel.scan_scores"), torch.cuda.device(q.device):
        err = fn(q.data_ptr(), db.data_ptr(), _ptr(db2), ids.data_ptr(),
                 _ptr(ids2), _ptr(db_norms), _ptr(db2_norms), out.data_ptr(),
                 g, b, n1, n2, d, int(metric == "l2"), vec4,
                 int(variant == "stream"),
                 torch.cuda.current_stream().cuda_stream)
    build.check_launch("scan_scores", err)
    launches.add()
    launches_by_variant[variant].add()
    launches_by_lanes[scan_stream.lane_key(g)].add()
    if db2 is not None:
        launches_two_segment.add()
    return out
