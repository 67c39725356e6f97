"""The life of every id, by batch.

Inserts take ids in order and deletes take the oldest, so the live ids are
always one range.  For each batch the ledger keeps the host times at which
its insert was sent and acknowledged, and its delete sent and
acknowledged: times taken before a send and after an acknowledgement, so
that a row counts as live for a request only if it surely was, and as
possibly live wherever it may have been.
"""
from __future__ import annotations

import math
import threading
from typing import Dict

import numpy as np


# ---------------------------------------------------------------------------

class Ledger:
    """Ids in order: inserts take [ins_next, ins_next + rows), deletes the
    oldest [del_next, del_next + rows).  Times are host `perf_counter`
    readings, taken before a send and after an acknowledgement, so that a
    row counts as live for a request only if it surely was."""

    def __init__(self, n0: int, ins_rows: int, del_rows: int):
        self.lock = threading.Lock()
        self.n0, self.ins_rows, self.del_rows = n0, ins_rows, del_rows
        self.ins_next, self.del_next, self.acked_hi = n0, 0, n0
        self._acked: set = set()
        self.ins_sent: Dict[int, float] = {}
        self.ins_acked: Dict[int, float] = {}
        self.del_sent: Dict[int, float] = {}
        self.del_acked: Dict[int, float] = {}

    def alloc_insert(self):
        with self.lock:
            start = self.ins_next
            self.ins_next += self.ins_rows
        return (start - self.n0) // self.ins_rows, start

    def acked_insert(self, start: int, t: float) -> None:
        with self.lock:
            self.ins_acked[(start - self.n0) // self.ins_rows] = t
            self._acked.add(start)
            while self.acked_hi in self._acked:
                self._acked.remove(self.acked_hi)
                self.acked_hi += self.ins_rows

    def alloc_delete(self):
        with self.lock:
            start = self.del_next
            if start + self.del_rows > self.acked_hi:
                raise RuntimeError("a delete would pass the acknowledged ids")
            self.del_next += self.del_rows
        return start // self.del_rows, start

    def live_range(self):
        """Ids surely live now: acknowledged, and no delete sent."""
        with self.lock:
            return self.del_next, self.acked_hi

    def _times(self, table: Dict[int, float], n: int, fill: float):
        out = np.full(n, fill)
        for j, t in table.items():
            if j < n:
                out[j] = t
        return out

    def tables(self):
        """Per-batch time arrays: insert sent / acknowledged (index by
        (id - n0) // ins_rows), delete sent / acknowledged (id // del_rows);
        +inf where it never happened."""
        ni = (self.ins_next - self.n0) // self.ins_rows
        nd = self.del_next // self.del_rows
        return (self._times(self.ins_sent, ni, math.inf),
                self._times(self.ins_acked, ni, math.inf),
                self._times(self.del_sent, nd, math.inf),
                self._times(self.del_acked, nd, math.inf))


def lifetimes(ids: np.ndarray, n0: int, ins_rows: int, del_rows: int,
            tables):
    """Per-id (insert sent, insert acked, delete sent, delete acked)."""
    ins_s, ins_a, del_s, del_a = tables
    ids = ids.astype(np.int64)
    out = []
    j = np.where(ids >= n0, (ids - n0) // ins_rows, -1)
    for t in (ins_s, ins_a):
        v = np.full(ids.shape, -math.inf)
        ok = (j >= 0) & (j < len(t))
        v[ok] = t[j[ok]]
        v[(j >= len(t))] = math.inf
        out.append(v)
    m = ids // del_rows
    for t in (del_s, del_a):
        v = np.full(ids.shape, math.inf)
        ok = (m >= 0) & (m < len(t))
        v[ok] = t[m[ok]]
        out.append(v)
    return out
