"""Retrieval quality metrics (paper: Recall@K vs ground-truth neighbors);
port of ``src/repro/core/metrics.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, as_tensor, resolve_device

# rows per f64 block of the oracle's product (a 1024-wide block is 0.5 GB)
_ORACLE_BLOCK_ELEMS = 1 << 26


def _exact_scores(q: torch.Tensor, r: torch.Tensor, metric: str
                  ) -> torch.Tensor:
    """f32 [B, N] scores whose products accumulate in f64, block by block
    of rows.  An f32 product on the card follows the process-wide
    ``torch.backends.cuda.matmul.allow_tf32`` / ``float32_matmul_precision``
    setting, and TF32 keeps 10 mantissa bits; f64 products have no reduced
    mode, so the oracle is exact whatever those settings say."""
    q64 = q.double()
    out = torch.empty((q.shape[0], r.shape[0]), dtype=torch.float32,
                      device=q.device)
    step = max(1, _ORACLE_BLOCK_ELEMS // max(1, r.shape[1]))
    for s in range(0, r.shape[0], step):
        blk = r[s:s + step].double()
        dots = q64 @ blk.T
        if metric == "l2":
            dots = -((blk * blk).sum(1)[None, :] - 2.0 * dots)
        out[:, s:s + step] = dots
        del blk, dots
    return out


def brute_force_topk(queries, rows, ids, k: int, metric: str = "ip", *,
                     device: DeviceLike = None) -> np.ndarray:
    """Exact ground truth (the paper's Flat baseline), as host int64.

    Scores are f64 dot products rounded to f32 (`_exact_scores`), on any
    device and under any matmul precision setting.  Tombstoned / empty
    slots (ids < 0) are masked out.  When k exceeds the number of rows the
    result is right-padded with -1, so the oracle stays total on tiny or
    heavily-deleted collections.  Ties go to the lower row index, as
    ``lax.top_k`` breaks them in the reference.
    """
    dev = resolve_device(device)
    return brute_force_topk_parts(
        queries, [(as_tensor(rows, torch.float32, dev), ids)], k, metric,
        device=dev)


def brute_force_topk_parts(queries, parts, k: int, metric: str = "ip", *,
                           device: DeviceLike = None) -> np.ndarray:
    """`brute_force_topk` over the concatenation of `parts`, an iterable of
    (rows, ids) — a sharded collection's per-shard flat views.  A tensor
    part is scored on its own device and only its scores move to
    `device`; a generator of parts holds one part at a time."""
    dev = resolve_device(device)
    q = as_tensor(queries, torch.float32, dev)
    scores, all_ids = [], []
    for rows, ids in parts:
        pdev = rows.device if isinstance(rows, torch.Tensor) else dev
        r = as_tensor(rows, torch.float32, pdev)
        i = as_tensor(ids, torch.int64, pdev)
        sc = _exact_scores(q.to(pdev), r, metric)
        sc.masked_fill_((i < 0)[None, :], float("-inf"))
        scores.append(sc.to(dev))
        all_ids.append(i.to(dev))
        del rows, ids, r, i, sc
    n = sum(int(i.shape[0]) for i in all_ids)
    if n == 0:
        return np.full((int(q.shape[0]), k), -1, dtype=np.int64)
    scores = scores[0] if len(scores) == 1 else torch.cat(scores, dim=1)
    ids = all_ids[0] if len(all_ids) == 1 else torch.cat(all_ids)
    kk = min(k, n)
    # stable descending sort: equal scores keep ascending row order
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    idx = order[:, :kk]
    top = torch.gather(scores, 1, idx)
    got = torch.where(torch.isfinite(top), ids[idx], -1)
    out = got.cpu().numpy()
    if kk < k:
        out = np.concatenate(
            [out, np.full((out.shape[0], k - kk), -1, dtype=out.dtype)], axis=1)
    return out


def recall_at_k(got_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Fraction of ground-truth neighbors returned (Recall@K).

    Padding / tombstone slots (ids < 0) never count: they are dropped from
    both sides, and each row's denominator is its count of *distinct* valid
    ground-truth ids — so `k > live rows`, duplicate ids, and all-tombstoned
    lists are all well-defined.  A query set with no valid ground truth at
    all (empty collection) vacuously has recall 1.0.
    """
    got_ids = np.asarray(got_ids)
    true_ids = np.asarray(true_ids)
    if got_ids.ndim != 2 or true_ids.ndim != 2:
        raise ValueError("recall_at_k takes 2-D id arrays")
    if got_ids.shape[0] != true_ids.shape[0]:
        raise ValueError(f"batch mismatch {got_ids.shape} vs {true_ids.shape}")
    hits = 0
    denom = 0
    for g, t in zip(got_ids, true_ids):
        tset = {int(i) for i in t.tolist() if i >= 0}
        gset = {int(i) for i in g.tolist() if i >= 0}
        hits += len(gset & tset)
        denom += len(tset)
    return 1.0 if denom == 0 else hits / denom
