"""Plain PyTorch versions of the Hopper kernels (the correctness contracts).

Counterparts of ``src/repro/kernels/ref.py``.  JAX's bf16 dot with
``preferred_element_type=f32`` multiplies bf16 operands exactly and sums in
f32; PyTorch's ``bf16 @ bf16`` would return bf16.  So operands are rounded to
bf16, upcast, and multiplied in f32, which reproduces the reference's
arithmetic up to summation order.  The quantized scan's integer products
are exact (see `scan_scores_q8_plain`).
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")
POS_INF = float("inf")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to bf16 (nearest even) and held as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def scan_scores_ref(q, db, ids, db_norms=None, *, metric="ip",
                    fused_conversion=True, db2=None, ids2=None,
                    db2_norms=None):
    """Scores f32[B, N]: bf16(q) . bf16(db)^T (l2: norms - 2 q.db); slots
    with id < 0 score -inf (ip) or +inf (l2).  A second segment of rows
    `db2` (ids2, db2_norms) is scored after db's: the scan of the two
    concatenated."""
    if db2 is not None:
        db = torch.cat([db, db2])
        ids = torch.cat([ids, ids2])
        if db_norms is not None:
            db_norms = torch.cat([db_norms, db2_norms])
    if fused_conversion:
        q = round_bf16(q)
        db = round_bf16(db)
    scores = q.float() @ db.float().T
    if metric == "l2":
        if db_norms is None:
            db_norms = (db.float() ** 2).sum(1)
        scores = db_norms[None, :] - 2.0 * scores
    mask_val = POS_INF if metric == "l2" else NEG_INF
    return torch.where((ids >= 0)[None, :], scores, mask_val)


def _lane(t, g):
    return None if t is None else t[g]


def scan_scores_lanes_ref(q, db, ids, db_norms=None, *, metric="ip",
                          fused_conversion=True, db2=None, ids2=None,
                          db2_norms=None):
    """The lane scan f32[G, B, N]: lane g is `scan_scores_ref` of q[g]
    f32[B, D] against db[g] f32[N, D] (ids[g], db_norms[g]; a second
    segment's db2[g], ids2[g], db2_norms[g]); a loop over the lanes, so
    each lane is the 2-D plain version's own arithmetic."""
    return torch.stack([
        scan_scores_ref(q[g], db[g], ids[g], _lane(db_norms, g),
                        metric=metric, fused_conversion=fused_conversion,
                        db2=_lane(db2, g), ids2=_lane(ids2, g),
                        db2_norms=_lane(db2_norms, g))
        for g in range(q.shape[0])])


def quantize_queries(q):
    """Symmetric per-query int8 codes for the quantized coarse scan:
    (codes i8[..., B, D], sq f32[..., B]) with q ~= sq[..., None] * codes,
    one scale per query row (leading lane axes pass through).  Same
    operations as the reference (`torch.round` rounds half to even like
    `jnp.round`; a division, not a multiply by the reciprocal)."""
    q = q.float()
    sq = torch.clamp(q.abs().amax(dim=-1), min=1e-30) / 127.0
    codes = torch.clamp(torch.round(q / sq[..., None]), -127, 127)
    return codes.to(torch.int8), sq


def query_corr(qc, sq):
    """sq * sum(qc) per query, over the real D: the affine zero-point term
    of the quantized scan."""
    return sq * qc.to(torch.int32).sum(-1).to(torch.float32)


def scan_scores_q8_plain(qc, codes, ids, scales, zeros, sq, corr,
                         db_norms=None, *, metric="ip"):
    """The quantized scan over given integer operands (what the Hopper
    kernel computes):

        s = (float(qc . codes_n) * sq) * scale_n + corr * zero_n
        s = norms_n - 2 s               (l2; norms of the dequantized rows)

    masked where ids < 0.  The integer accumulator is exact: `int8 @ int8`
    in PyTorch returns int8 (it wraps) and CUDA has no int32 product, so the
    codes are multiplied in float64, where every product (|.| <= 127^2) and
    every partial sum (|.| <= D * 127^2 < 2^53) is an exact integer on both
    devices, in any summation order.  The epilogue is f32 in the
    reference's operation order."""
    if metric == "l2" and db_norms is None:
        raise ValueError("the q8 l2 scan needs the dequantized row norms")
    acc = (qc.double() @ codes.double().T).float()
    scores = acc * sq[:, None] * scales[None, :] + corr[:, None] * zeros[None, :]
    if metric == "l2":
        scores = db_norms[None, :] - 2.0 * scores
    mask_val = POS_INF if metric == "l2" else NEG_INF
    return torch.where((ids >= 0)[None, :], scores, mask_val)


def scan_scores_q8_lanes_plain(qc, codes, ids, scales, zeros, sq, corr,
                               db_norms=None, *, metric="ip"):
    """The lane quantized scan f32[G, B, N] over qc i8[G, B, D], codes
    i8[G, N, D], ids/scales/zeros/db_norms [G, N], sq/corr f32[G, B]:
    lane g is `scan_scores_q8_plain` of lane g's operands."""
    return torch.stack([
        scan_scores_q8_plain(qc[g], codes[g], ids[g], scales[g], zeros[g],
                             sq[g], corr[g], _lane(db_norms, g),
                             metric=metric)
        for g in range(qc.shape[0])])


def scan_scores_q8_ref(q, codes, ids, scales, zeros, db_norms=None, *,
                       metric="ip"):
    """Quantized coarse scores f32[B, N] of f32 queries against the affine
    int8 row store (row_n ~= scales[n] * codes_n + zeros[n]); with a
    leading lane axis on every operand, f32[G, B, N]."""
    qc, sq = quantize_queries(q)
    plain = scan_scores_q8_lanes_plain if q.dim() == 3 else \
        scan_scores_q8_plain
    return plain(qc, codes, ids, scales, zeros, sq, query_corr(qc, sq),
                 db_norms, metric=metric)


def kmeans_assign_ref(x, centroids, *, fused_conversion=True):
    """(idx i32[M], dist f32[M]): argmin_c ||c||^2 - 2 x.c, lowest index on
    a tie; ||c||^2 from the f32 centroids."""
    xc, cc = x, centroids
    if fused_conversion:
        xc = round_bf16(x)
        cc = round_bf16(centroids)
    dots = xc.float() @ cc.float().T
    cnorms = (centroids.float() ** 2).sum(1)
    d = cnorms[None, :] - 2.0 * dots
    idx = torch.argmin(d, dim=1)
    return idx.to(torch.int32), d.gather(1, idx[:, None])[:, 0]


def segsum_gemm_ref(x, assign, *, n_clusters):
    """(sums f32[C, D], counts f32[C]) over rows with assign in [0, C); the
    rest drop out, as one_hot(assign) drops them in the reference."""
    valid = (assign >= 0) & (assign < n_clusters)
    a = assign[valid].long()
    sums = torch.zeros((n_clusters, x.shape[1]), dtype=torch.float32,
                       device=x.device)
    sums.index_add_(0, a, x[valid].float())
    counts = torch.bincount(a, minlength=n_clusters).to(torch.float32)
    return sums, counts
