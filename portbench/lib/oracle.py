"""The plain reference: exact inner products of the benchmark's own rows.

Plain PyTorch, imports nothing of the program.  It takes only what the
benchmark made (the rows, made again from the seed by `corpus`, and the
query vectors) and what the program answered, which it reads only to judge
it.  For every sampled query vector it works out, in float64 and in blocks
of rows so that it fits beside nothing else on the card:

- the exact score of every id that the program returned,
- the exact k best scores among the rows that were live for the whole of
  that request (acknowledged before it was sent, not yet deleted when it
  was answered),

and, for the control, the answer that the same brute force gives when its
products are computed in a lower precision than the configuration states
(fp8 e4m3 in place of bf16 operands; bf16 in place of the exact float32
rescore of the int8 store), with the exact scores of the rows it picked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

BLOCK = 1 << 16
FP8_MAX = 448.0          # largest finite float8_e4m3fn


def lower_precision(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x rounded as the control computes it, held in float64: `fp8` scales
    each vector to the e4m3 range and rounds; `bf16` rounds to bfloat16."""
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float64)
    if kind == "fp8":
        scale = FP8_MAX / x.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        q = (x * scale).to(torch.float8_e4m3fn).to(torch.float64)
        return q / scale.to(torch.float64)
    raise ValueError(f"unknown control precision {kind!r}")


@dataclass
class Verdicts:
    exact_returned: np.ndarray       # f64[V, k]; nan where not a row
    best: np.ndarray                 # f64[V, k] exact best, descending
    control_ids: Optional[np.ndarray] = None      # i64[V, k]
    control_scores: Optional[np.ndarray] = None   # f64[V, k]
    control_exact: Optional[np.ndarray] = None    # f64[V, k]


def judge(queries: torch.Tensor, returned: np.ndarray, t_sub: np.ndarray,
          t_done: np.ndarray, span: Tuple[int, int],
          rows: Callable[[int, int], torch.Tensor],
          live_times: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                     torch.Tensor]],
          k: int, control: Optional[str] = None,
          block: int = BLOCK) -> Verdicts:
    """Exact scores for queries f32[V, D] (on the rows' device) over ids
    [span[0], span[1]).  `returned` i64[V, k] are the program's ids.
    `rows(lo, hi)` gives the f32 rows of ids lo..hi-1; `live_times(ids)`
    gives each id's insert-acknowledged time and delete-sent time (-inf /
    +inf where there is none), on the host clock of `t_sub` / `t_done`."""
    dev = queries.device
    v = queries.shape[0]
    q64 = queries.to(torch.float64)
    qc = lower_precision(queries, control) if control else None
    ret = torch.as_tensor(returned, dtype=torch.int64, device=dev)
    exact_ret = torch.full((v, k), float("nan"), dtype=torch.float64,
                           device=dev)
    neg = torch.tensor(float("-inf"), dtype=torch.float64, device=dev)
    best = torch.full((v, k), float("-inf"), dtype=torch.float64,
                      device=dev)
    ctl = torch.full((v, k), float("-inf"), dtype=torch.float64, device=dev)
    ctl_exact = torch.full((v, k), float("-inf"), dtype=torch.float64,
                           device=dev)
    ctl_ids = torch.full((v, k), -1, dtype=torch.int64, device=dev)
    sub = torch.as_tensor(t_sub, dtype=torch.float64, device=dev)[:, None]
    done = torch.as_tensor(t_done, dtype=torch.float64, device=dev)[:, None]
    for lo in range(span[0], span[1], block):
        hi = min(lo + block, span[1])
        r = rows(lo, hi)
        s = q64 @ r.to(torch.float64).T                       # [V, n]
        inb = (ret >= lo) & (ret < hi)
        got = s.gather(1, (ret - lo).clamp(0, hi - lo - 1))
        exact_ret = torch.where(inb, got, exact_ret)
        ack, gone = live_times(torch.arange(lo, hi, device=dev))
        live = (ack[None, :] < sub) & (gone[None, :] > done)  # [V, n]
        masked = torch.where(live, s, neg)
        best = torch.topk(torch.cat([best, masked], 1), k, dim=1).values
        if control:
            sc = torch.where(live, qc @ lower_precision(r, control).T, neg)
            both = torch.cat([ctl, sc], 1)
            top = torch.topk(both, k, dim=1).indices
            ctl = both.gather(1, top)
            ctl_exact = torch.cat([ctl_exact, masked], 1).gather(1, top)
            here = torch.arange(lo, hi, device=dev).expand(v, hi - lo)
            ctl_ids = torch.cat([ctl_ids, here], 1).gather(1, top)
        del r, s, masked
    out = Verdicts(exact_ret.cpu().numpy(), best.cpu().numpy())
    if control:
        out.control_ids = ctl_ids.cpu().numpy()
        out.control_scores = ctl.cpu().numpy()
        out.control_exact = ctl_exact.cpu().numpy()
    return out


def score_err(reported: np.ndarray, exact: np.ndarray) -> float:
    """Widest gap between a reported score and the exact score of the row
    it names (a returned id that names no row counts as infinite)."""
    if reported.size == 0:
        return 0.0
    gap = np.abs(reported.astype(np.float64) - exact)
    gap[~np.isfinite(exact)] = np.inf
    return float(gap.max())


def rank_gap(best: np.ndarray, exact: np.ndarray) -> float:
    """Widest gap by which the answer's j-th best row (by exact score)
    lies below the exact j-th best live row, over every rank j."""
    if best.size == 0:
        return 0.0
    got = np.where(np.isfinite(exact), exact, -np.inf)
    got = -np.sort(-got, axis=1)
    gap = best - got
    gap[np.isnan(gap)] = 0.0        # no live row at that rank, none returned
    return float(gap.max())


def miss(best: np.ndarray, exact: np.ndarray) -> float:
    """Mean share of the exact k best live rows that an answer left out
    (1 - recall@k): a returned row counts as found if its exact score
    reaches the exact k-th best (0 where there is no vector)."""
    if best.size == 0:
        return 0.0
    k = best.shape[1]
    got = np.where(np.isfinite(exact), exact, -np.inf)
    found = np.minimum((got >= best[:, k - 1:k]).sum(axis=1), k)
    return float(1.0 - found.mean() / k)
