"""Recall-adaptive knob tuner (paper: query throughput *at matched recall*);
copy of ``src/repro/core/tuner.py``.

A `RecallTuner` owns one integer search-effort knob — `nprobe` on the IVF
probe path, `ef` on the HNSW graph path — and walks it toward the cheapest
value whose measured recall@k stays at or above `target`.  Measurements come
from the background recall probe (`Collection.recall_probe`): a sampled
exact full-scan rescan over the live snapshot, so every observation is
against ground truth, never a proxy.

State machine (documented in docs/ARCHITECTURE.md):

    SEEKING   measured recall < target.  The knob multiplies up (×2) until
              a measurement clears the target or the knob saturates at
              `hi`.  Every missed measurement also raises `floor`, the
              largest knob value known to miss target — backoff may never
              return below it.
    HOLDING   measured recall >= target.  The knob holds, unless recall
              clears `target + slack`, in which case it backs off by 25%
              (never below `floor + 1`) to reclaim throughput — the next
              probe validates the cheaper setting and re-raises `floor`
              if it was too optimistic.

The knob is a single int read/written under the owner's pointer lock, so
queries always see a consistent value and retuning has zero query downtime:
in-flight queries keep the knob they resolved, later queries pick up the
new one atomically.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core import locking


class RecallTuner:
    """Auto-tunes one integer effort knob toward a target recall@k."""

    def __init__(self, target: float, knob: int, lo: int, hi: int,
                 slack: float = 0.03):
        if not 0.0 < target <= 1.0:
            raise ValueError(f"target recall must be in (0, 1] (got {target})")
        if not lo <= knob <= hi:
            raise ValueError(f"knob {knob} outside [{lo}, {hi}]")
        self.target = float(target)
        self.lo = int(lo)
        self.hi = int(hi)
        self.slack = float(slack)
        self._lock = locking.make_lock("_lock")   # leaf: never nests
        self._knob = int(knob)
        self._floor = int(lo) - 1   # largest knob known to miss target
        self._probes = 0
        self._raises = 0
        self._backoffs = 0
        self._last_recall: Optional[float] = None

    # -- readers ----------------------------------------------------------
    @property
    def knob(self) -> int:
        with self._lock:
            return self._knob

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "knob": self._knob,
                "floor": self._floor,
                "target": self.target,
                "probes": self._probes,
                "raises": self._raises,
                "backoffs": self._backoffs,
                "last_recall": self._last_recall,
            }

    # -- the state machine -------------------------------------------------
    def observe(self, recall: float) -> int:
        """Feed one oracle-measured recall@k; returns the (new) knob."""
        with self._lock:
            self._probes += 1
            self._last_recall = float(recall)
            k = self._knob
            if recall < self.target:
                # SEEKING: k provably misses target -> remember and double
                self._floor = max(self._floor, k)
                nk = min(self.hi, max(k + 1, k * 2))
                if nk != k:
                    self._raises += 1
            elif recall >= self.target + self.slack and k > self.lo:
                # HOLDING with headroom: back off 25%, never below floor+1
                nk = max(self.lo, self._floor + 1, (k * 3) // 4)
                if nk != k:
                    self._backoffs += 1
            else:
                nk = k
            self._knob = nk
            return nk

    # -- persistence -------------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        with self._lock:
            return {
                "target": self.target, "lo": self.lo, "hi": self.hi,
                "slack": self.slack, "knob": self._knob,
                "floor": self._floor, "probes": self._probes,
                "raises": self._raises, "backoffs": self._backoffs,
                "last_recall": self._last_recall,
            }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "RecallTuner":
        t = cls(float(d["target"]), int(d["knob"]), int(d["lo"]),
                int(d["hi"]), slack=float(d.get("slack", 0.03)))
        with t._lock:
            t._floor = int(d.get("floor", t.lo - 1))
            t._probes = int(d.get("probes", 0))
            t._raises = int(d.get("raises", 0))
            t._backoffs = int(d.get("backoffs", 0))
            lr = d.get("last_recall")
            t._last_recall = None if lr is None else float(lr)
        return t


__all__ = ["RecallTuner"]
