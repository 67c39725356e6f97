"""Dispatch that `core.index` and `core.kmeans` call (port of
``src/repro/kernels/ops.py``).

Keeps the reference's contracts: slots with id < 0 score -inf (ip) or +inf
(l2); the returned centroid index is always in [0, C); rows with assign < 0
drop out of sums and counts; ``fused_conversion=False`` materialises a
bf16-rounded copy before the scan.  The kernels handle ragged edges
themselves, so nothing is padded here.  ``use_kernel=False`` is the
reference's ablation switch: the plain version, explicitly asked for.
Otherwise each wrapper takes the plain version for a CPU tensor and launches
its Hopper kernel for a CUDA tensor.
"""
from __future__ import annotations

from repro_torch.kernels import kmeans_assign as _assign
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import scan_scores as _scan
from repro_torch.kernels import scan_scores_q8 as _scan_q8
from repro_torch.kernels import segsum_gemm as _segsum


def scan_scores(q, db, ids, db_norms=None, *, metric="ip", use_kernel=True,
                fused_conversion=True, db2=None, ids2=None, db2_norms=None):
    """Similarity scores f32[B, N] between queries and database rows; with
    a leading lane axis on every operand (q [G, B, D], db [G, N, D], ids
    and db_norms [G, N]) f32[G, B, N], lane g scanning only its own rows.
    `db2` (ids2, db2_norms) is a second segment of rows, scored after db's
    in the same launch: f32[(G,) B, N1 + N2]."""
    if not fused_conversion:
        # ablation baseline "C": materialise the converted copy first (an
        # extra full-matrix round trip), then an exact product
        q = _ref.round_bf16(q)
        db = _ref.round_bf16(db)
        db2 = None if db2 is None else _ref.round_bf16(db2)
    if not use_kernel:
        plain = _ref.scan_scores_lanes_ref if q.dim() == 3 else \
            _ref.scan_scores_ref
        return plain(q, db, ids, db_norms, metric=metric,
                     fused_conversion=fused_conversion, db2=db2, ids2=ids2,
                     db2_norms=db2_norms)
    return _scan.scan_scores(q, db, ids, db_norms, metric=metric, db2=db2,
                             ids2=ids2, db2_norms=db2_norms)


def scan_scores_q8(q, codes, ids, scales, zeros, db_norms=None, *,
                   metric="ip", use_kernel=True):
    """Quantized coarse scan: f32[B, N] approximate scores of f32 queries
    q[B, D] against the affine int8 row store (per-row scales/zeros; for l2,
    `db_norms` are the dequantized rows' norms); with a leading lane axis
    on every operand, f32[G, B, N].  The queries are quantized here, per
    query, and `corr` is taken over the real D, so the kernel and the plain
    version consume identical integer operands."""
    if not use_kernel:
        return _ref.scan_scores_q8_ref(q, codes, ids, scales, zeros,
                                       db_norms, metric=metric)
    qc, sq = _ref.quantize_queries(q)
    return _scan_q8.scan_scores_q8(qc, codes, ids, scales, zeros, sq,
                                   _ref.query_corr(qc, sq), db_norms,
                                   metric=metric)


def kmeans_assign(x, centroids, *, use_kernel=True, fused_conversion=True):
    """(idx int32[M], dist fp32[M]) nearest centroid per row (L2, mod ||x||^2)."""
    if not use_kernel:
        return _ref.kmeans_assign_ref(x, centroids,
                                      fused_conversion=fused_conversion)
    return _assign.kmeans_assign(x, centroids,
                                 fused_conversion=fused_conversion)


def segsum_gemm(x, assign, *, n_clusters, use_kernel=True):
    """(sums fp32[C, D], counts fp32[C]); assign < 0 rows are ignored."""
    if not use_kernel:
        return _ref.segsum_gemm_ref(x, assign, n_clusters=n_clusters)
    return _segsum.segsum_gemm(x, assign, n_clusters=n_clusters)


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the process started, by
    variant (``<kernel>.<variant>``; `segsum_gemm` has one variant), and
    ``scan_scores.two_segment``: the `scan_scores` launches (already
    counted by variant) that read a second segment of rows."""
    out = {}
    for name, mod in (("scan_scores", _scan), ("scan_scores_q8", _scan_q8),
                      ("kmeans_assign", _assign)):
        for variant, n in mod.launches_by_variant.items():
            out[f"{name}.{variant}"] = n.value
    out["scan_scores.two_segment"] = _scan.launches_two_segment.value
    out["segsum_gemm"] = _segsum.launches.value
    return out
