"""Fault tolerance: preemption handling + straggler detection; a copy of
``src/repro/distributed/fault.py`` (framework-free host code: the port keeps
its own copy instead of importing the JAX package).

The replication tier (`repro_torch.api.replication`) uses both: a
`PreemptionGuard` request (or SIGTERM) drains the shipping log before a
planned failover, and each replica's `StragglerMonitor` times its apply
batches so query routing can deprioritize a replica that falls behind.
"""
from __future__ import annotations

import collections
import signal
import threading
import time
from typing import Deque, Optional


class PreemptionGuard:
    """SIGTERM -> request a checkpoint/drain at the next step boundary.

    Signal handlers can only be installed from the main thread; off the
    main thread the guard degrades gracefully — it never even attempts the
    install (the previous code relied on catching `signal.signal`'s
    ValueError, which still races teardown and masks real ValueErrors from
    an already-installed chain) and stays fully functional through the
    programmatic path (`request()` / `should_checkpoint`), which is how
    the replication tier triggers its planned-failover drain.  `installed`
    reports whether a handler is live; `uninstall()` restores whatever
    handler was displaced (tests, embedders with their own signal policy).
    """

    def __init__(self, install: bool = True):
        self._requested = threading.Event()
        self._prev = {}
        self.installed = False
        if install and threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM,):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                    self.installed = True
                except (ValueError, OSError):
                    pass   # exotic embedders (no signal support)

    def _handler(self, signum, frame):
        self._requested.set()

    def request(self):
        self._requested.set()

    @property
    def should_checkpoint(self) -> bool:
        return self._requested.is_set()

    def reset(self):
        self._requested.clear()

    def uninstall(self) -> None:
        """Restore the displaced handlers (idempotent; main thread only —
        elsewhere there is nothing installed to restore)."""
        prev, self._prev = self._prev, {}
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
        self.installed = False


class StragglerMonitor:
    """Ring buffer of step durations; flags steps beyond median * threshold.

    On a real pod each host reports its own step time to the coordinator;
    here the same logic runs per-process and the trainer exposes the flags.
    """

    def __init__(self, window: int = 64, threshold: float = 2.0):
        self.durations: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.flagged = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._t0 is not None

    def stop(self) -> dict:
        """Close the step opened by `start()` and classify it.

        A stop() without a matching start() raises (a silent 0-duration
        sample would poison the median every flagged step is judged
        against) — but with a typed error, not a bare assert that
        `python -O` would strip from the production loop.
        """
        if self._t0 is None:
            raise RuntimeError("StragglerMonitor.stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        out = {"step_s": dt, "straggler": False}
        if len(self.durations) >= 8:
            med = sorted(self.durations)[len(self.durations) // 2]
            if dt > self.threshold * med:
                self.flagged += 1
                out["straggler"] = True
        self.durations.append(dt)
        return out

    def stats(self) -> dict:
        if not self.durations:
            return {"n": 0}
        ds = sorted(self.durations)
        return {
            "n": len(ds),
            "p50_s": ds[len(ds) // 2],
            "p95_s": ds[min(len(ds) - 1, int(0.95 * len(ds)))],
            "flagged": self.flagged,
        }
