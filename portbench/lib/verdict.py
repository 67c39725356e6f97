"""The comparison that decides `correct`.

Numbers compared, each against the limit of the cell's limits file:

- lost_ids: acknowledged rows missing from the memory, and rows present
  that were never inserted or were deleted, after the build and after the
  window (read back from the program's state; exact, limit 0);
- bad_answers: over every request of the window, query vectors whose
  request failed or never came, or whose answer is malformed (wrong shape,
  a missing or repeated id, scores out of order) or names a row that was
  not live at any moment of the request, plus failed writes (exact, 0);
- self_miss: query vectors whose own row (the live row the query was
  perturbed from, live for the whole request) is not answered first
  (exact, 0);
- score_err: over the sample, the widest gap between a returned score and
  the exact float64 inner product of the row it names;
- rank_gap: over the sampled full-scan vectors, the widest gap by which
  the answer's j-th best row lies below the exact j-th best live row (the
  full scan is exact up to its arithmetic; the probed path is approximate
  by design, so its gap is reported, not compared);
- probed_miss: over the sampled probed vectors, the mean share of the
  exact k best live rows that the answer left out (1 - recall@k): the
  probed path scans `nprobe` lists, and an answer from fewer reads worse;
- rebuild_seen (cells that write): sampled requests sent after a rebuild
  of the window had been published (at least the limit).

The sample is drawn from the seed among the window's finished requests:
`per_size` of each batch size, the largest among them, and, where the
traffic writes, `after_rebuild` more sent after a rebuild.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import corpus, oracle
from portbench.lib.ledger import lifetimes


def _possibly_live(t_sub, t_done, life) -> np.ndarray:
    """Ids that were live at some moment between a request's send and its
    answer: insert sent before the answer, delete not acknowledged before
    the send."""
    ins_s, _, _, del_a = life
    return (ins_s < t_done) & (del_a > t_sub)


def _host_checks(reqs, k: int, lookup):
    """(bad vectors, self misses) over every request."""
    bad = miss = 0
    ok_reqs = [r for r in reqs if r.ok]
    bad += sum(r.b for r in reqs if not r.ok)
    if not ok_reqs:
        return bad, miss
    targets = torch.cat([r.target for r in ok_reqs]).cpu().numpy()
    pos = 0
    for r in ok_reqs:
        tg = targets[pos:pos + r.b]
        pos += r.b
        ids, sc = r.ids, r.scores
        if (ids is None or sc is None or ids.shape != (r.b, k)
                or sc.shape != (r.b, k)):
            bad += r.b
            continue
        ids64 = ids.astype(np.int64)
        life = lookup(ids64)
        alive = _possibly_live(r.t_sub, r.t_done, life)
        srt = np.sort(ids64, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        order = ~(np.diff(sc.astype(np.float64), axis=1) <= 0).all(axis=1)
        row_bad = (ids64 < 0).any(axis=1) | dup | order | ~alive.all(axis=1)
        row_bad |= ~np.isfinite(sc).all(axis=1)
        bad += int(row_bad.sum())
        t_life = lookup(tg.astype(np.int64))
        sure = (t_life[1] < r.t_sub) & (t_life[2] > r.t_done)
        miss += int((sure & (ids64[:, 0] != tg)).sum())
    return bad, miss


def _sample(reqs, rng, k: int, per_size: int, after: int, rb0: int):
    ok = [i for i, r in enumerate(reqs) if r.ok and r.ids is not None
          and r.ids.shape == (r.b, k) and r.scores is not None
          and r.scores.shape == (r.b, k)]
    chosen: List[int] = []
    for b in sorted({reqs[i].b for i in ok}):
        group = [i for i in ok if reqs[i].b == b]
        n = min(per_size, len(group))
        chosen += [group[j] for j in rng.choice(len(group), n, replace=False)]
    taken = set(chosen)
    later = [i for i in ok if reqs[i].rebuilds_before > rb0
             and i not in taken]
    n = min(after, len(later))
    chosen += [later[j] for j in rng.choice(len(later), n, replace=False)]
    return sorted(chosen)


def check(win, ledger, *, seed: int, k: int, limits: dict, lost: int,
          rebuilds_before: int, control, rows, device) -> dict:
    """Judge a window: the numbers above, each against its limit."""
    tables = ledger.tables()
    n0, ir, dr = ledger.n0, ledger.ins_rows, ledger.del_rows

    def lookup(ids):
        return lifetimes(ids, n0, ir, dr, tables)

    reqs = win.requests
    bad, miss = _host_checks(reqs, k, lookup)
    bad += sum(not w.ok for w in win.writes)

    rng = np.random.default_rng(corpus.mix(seed, 99))
    smp = limits["sample"]
    idx = _sample(reqs, rng, k, int(smp["per_size"]),
                  int(smp["after_rebuild"]), rebuilds_before)
    numbers: Dict[str, float] = {"lost_ids": lost, "bad_answers": bad,
                                 "self_miss": miss}
    info: Dict[str, float] = {"sampled_requests": len(idx)}
    if idx:
        q = torch.cat([reqs[i].q for i in idx]).to(device)
        ret = np.concatenate([reqs[i].ids for i in idx]).astype(np.int64)
        rsc = np.concatenate([reqs[i].scores for i in idx])
        tsub = np.concatenate([[reqs[i].t_sub] * reqs[i].b for i in idx])
        tdone = np.concatenate([[reqs[i].t_done] * reqs[i].b for i in idx])
        full = np.concatenate([[reqs[i].path == "full_scan"] * reqs[i].b
                               for i in idx])
        tgt = torch.cat([reqs[i].target for i in idx]).cpu().numpy()
        span = _span(ret, tdone, tables, dr, ledger.ins_next)
        ack_t = torch.as_tensor(tables[1], dtype=torch.float64, device=device)
        gone_t = torch.as_tensor(tables[2], dtype=torch.float64,
                                 device=device)

        def live_times(ids):
            j = torch.div(ids - n0, ir, rounding_mode="floor")
            ack = torch.full(ids.shape, -math.inf, dtype=torch.float64,
                             device=device)
            has = (ids >= n0) & (j < ack_t.numel())
            ack[has] = ack_t[j[has]]
            ack[(ids >= n0) & (j >= ack_t.numel())] = math.inf
            m = torch.div(ids, dr, rounding_mode="floor")
            gone = torch.full(ids.shape, math.inf, dtype=torch.float64,
                              device=device)
            hm = m < gone_t.numel()
            gone[hm] = gone_t[m[hm]]
            return ack, gone

        v = oracle.judge(q, ret, tsub, tdone, span, rows, live_times, k,
                         control=control)
        if control:
            rsc, exact = v.control_scores, v.control_exact
            t_life = lookup(tgt.astype(np.int64))
            sure = (t_life[1] < tsub) & (t_life[2] > tdone)
            numbers["self_miss"] = int(
                (sure & (v.control_ids[:, 0] != tgt)).sum())
        else:
            exact = v.exact_returned
        numbers["score_err"] = oracle.score_err(rsc, exact)
        numbers["rank_gap"] = oracle.rank_gap(v.best[full], exact[full])
        numbers["probed_miss"] = oracle.miss(v.best[~full], exact[~full])
        info["rank_gap_probed"] = oracle.rank_gap(v.best[~full],
                                                  exact[~full])
        info["sampled_vectors"] = int(q.shape[0])
        info["sampled_full_scan_vectors"] = int(full.sum())
    else:
        numbers["score_err"] = math.inf
        numbers["rank_gap"] = math.inf
        numbers["probed_miss"] = math.inf
    lim = limits["numbers"]
    if "rebuild_seen" in lim:
        numbers["rebuild_seen"] = sum(
            reqs[i].rebuilds_before > rebuilds_before for i in idx)
    correct = True
    table = {}
    for name, bound in lim.items():
        value = numbers[name]
        if "max" in bound:
            ok = value <= bound["max"]
            table[name] = {"value": value, "limit": bound["max"],
                           "op": "<="}
        else:
            ok = value >= bound["min"]
            table[name] = {"value": value, "limit": bound["min"],
                           "op": ">="}
        correct = correct and bool(ok)
    return {"correct": correct, "numbers": table, "info": info}


def _span(ret, tdone, tables, dr: int, ins_next: int):
    """Ids the reference must read: from the lowest id live for some
    sampled request (or returned), to the last id handed out."""
    del_s = tables[2]
    lo_live = []
    for t in np.unique(tdone):
        later = np.nonzero(del_s > t)[0]
        lo_live.append(int(later[0]) * dr if later.size else len(del_s) * dr)
    lo = min(lo_live) if lo_live else 0
    valid = ret[(ret >= 0) & (ret < ins_next)]
    if valid.size:
        lo = min(lo, int(valid.min()))
    return lo, ins_next


def print_lines(table: dict, out=sys.stderr) -> None:
    """The numbers compared, each beside its limit, as the last lines."""
    for name, e in table.items():
        print(f"check {name} {e['value']!r} {e['op']} {e['limit']!r}",
              file=out)


def finite(x):
    """JSON holds no infinity: an infinite reading is written as 1e308."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308 if x > 0 or math.isnan(x) else -1e308
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """Loaded modules of JAX or the JAX package, compared by whole
    top-level name (the port's name begins with the JAX package's)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
