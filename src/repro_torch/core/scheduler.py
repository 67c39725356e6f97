"""Windowed Batch Submission scheduler (paper §4.3 'Memory-efficient Scheduler');
port of ``src/repro/core/scheduler.py``.

The paper's core trade-off: submitting *all* tasks at once maximizes pipeline
occupancy but the in-flight working set peaks unacceptably; one-task-per-
worker keeps memory flat but starves the pipeline with bubbles.  Their
resolution — and ours — is a bounded submission window over per-backend
queues that backend-bound workers *pull* from: peak memory is O(window),
load balancing is implicit (faster backends pull more), and there is no
central dispatcher.

On this host the "backends" are worker threads that each own a class of
device work (latency / throughput / background — the template classes from
templates.py).  CUDA work is queued asynchronously; workers wait for the
work a task launched before finishing it, so in-flight device memory is
truly bounded by the window.  Every worker launches on the device's default
stream (one stream: no cross-stream buffer lifetimes to manage).

Each backend class has its own priority heap under one condition variable:
a worker pops from its own heap first, then steals per `_steal_order`
(latency workers never leave their lane; latency tasks are only ever stolen
by throughput workers), and otherwise *waits* — no pop/requeue spin burning
CPU when only one task class is queued.

No completed task is retained: `stats()` reports cumulative counts and
means, and `totals()` the cumulative sums, from per-kind aggregates that
never reset, so sustained traffic can't grow the scheduler's footprint.
A reader differences `totals()` across a window: per kind, tasks completed,
their queue wait, their latency, and `admit_wait_s`, the time `submit`
blocked on the full submission window before the task was queued (which the
queue wait, measured from the queueing, leaves out).

Modes for the Fig. 7 benchmark: "windowed" (AME), "all" (flood), "serial"
(one at a time).
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


def _block_until_ready(out: Any) -> None:
    """Wait for the CUDA work behind every tensor in `out` (nested tuples,
    lists and dicts; host values need no wait)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
    elif isinstance(out, (tuple, list)):
        for v in out:
            _block_until_ready(v)
    elif isinstance(out, dict):
        for v in out.values():
            _block_until_ready(v)


class Overloaded(RuntimeError):
    """Typed admission-control rejection: the target backend's queue is at
    its configured limit (or the estimated queue wait exceeds the bound).

    Raised from `WindowedScheduler.submit` *before* the task enters the
    queue, so a rejected op costs the caller one exception rather than an
    unbounded wait — overload degrades to bounded latency, never to an
    unbounded heap.  Callers can retry after a drain or shed the work to a
    read replica (`repro_torch.api.replication.ReplicaSet.query` does
    exactly that for queries).
    """

    def __init__(self, backend: str, depth: int, limit: float,
                 reason: str = "queue-depth"):
        self.backend = backend
        self.depth = depth
        self.limit = limit
        self.reason = reason
        super().__init__(
            f"backend {backend!r} overloaded ({reason}: {depth} vs limit "
            f"{limit}); retry after drain or shed to a replica")


@dataclass(frozen=True)
class AdmissionControl:
    """Per-backend queue-depth / queue-wait limits for the scheduler.

    `max_queue_depth` bounds how many tasks may sit queued (not yet
    running) per backend class.  The background class gets only
    `background_frac` of that budget, so under sustained overload
    maintenance work is shed strictly before latency-class queries —
    rebuilds are deferrable, serving traffic is not.  `max_queue_wait_s`
    additionally rejects tasks whose *estimated* queue wait (current depth
    x the backend's observed mean task time / its worker count) exceeds
    the bound, and caps how long `submit` may block on the submission
    window before rejecting — a full window cannot hang an admitted
    caller indefinitely.
    """

    max_queue_depth: int = 64
    max_queue_wait_s: Optional[float] = None
    background_frac: float = 0.5

    def depth_limit(self, backend: str) -> int:
        if backend == "background":
            return max(1, int(self.max_queue_depth * self.background_frac))
        return self.max_queue_depth


@dataclass
class Task:
    fn: Callable[[], Any]
    kind: str                    # query | insert | rebuild | ...
    backend: str                 # latency | throughput | background
    priority: int = 0
    size_bytes: int = 0
    admit_wait: float = 0.0      # blocked on the submission window
    submit_t: float = 0.0
    start_t: float = 0.0
    end_t: float = 0.0
    result: Any = None
    error: Optional[BaseException] = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def queue_wait(self) -> float:
        return self.start_t - self.submit_t

    @property
    def latency(self) -> float:
        return self.end_t - self.submit_t


class WindowedScheduler:
    """Worker-pulled, windowed-batch-submission task scheduler."""

    def __init__(self, window: int = 8, mode: str = "windowed",
                 backends: Dict[str, int] | None = None,
                 admission: Optional[AdmissionControl] = None):
        assert mode in ("windowed", "all", "serial")
        self.window = window if mode == "windowed" else (1 if mode == "serial" else 1 << 30)
        self.mode = mode
        # worker threads per backend class (paper: workers bound to CPU/GPU/NPU)
        self.backends = backends or {"latency": 1, "throughput": 1, "background": 1}
        self.admission = admission
        self._cond = threading.Condition()
        # one priority heap per backend class; tasks for classes nobody owns
        # get their own heap and are picked up by stealing workers
        self._queues: Dict[str, List[Tuple[int, int, Task]]] = {
            b: [] for b in self.backends}
        self._stopping = False
        self._sem = threading.Semaphore(self.window)
        self._seq = 0
        self._outstanding = 0            # queued or running (drain target)
        self._agg: Dict[str, Dict[str, float]] = {}
        self._n_completed = 0
        self._peak_inflight_bytes = 0
        self._inflight_bytes = 0
        # admission watermarks: per-backend queued-depth peaks and shed
        # counts (kept even with admission off — depth peaks are a free
        # overload diagnostic), plus per-backend exec-time aggregates that
        # feed the queue-wait estimate
        self._depth_peak: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}
        self._backend_exec: Dict[str, Dict[str, float]] = {}
        self._threads: List[threading.Thread] = []
        for backend, n in self.backends.items():
            for i in range(n):
                t = threading.Thread(
                    target=self._worker, args=(backend,),
                    name=f"ame-{backend}-{i}", daemon=True)
                t.start()
                self._threads.append(t)

    # ------------------------------------------------------------------
    def _admit(self, task: Task) -> None:
        """Admission check for `task`'s backend; raises `Overloaded`.

        Depth is read under the condvar but the subsequent window acquire
        is not atomic with it, so the limit is a watermark (off by at most
        the number of concurrent submitters), which is exactly what
        bounded-latency overload control needs — not a hard invariant.
        """
        adm = self.admission
        with self._cond:
            depth = len(self._queues.get(task.backend, ()))
            limit = adm.depth_limit(task.backend)
            if depth >= limit:
                self._shed[task.backend] = self._shed.get(task.backend, 0) + 1
                raise Overloaded(task.backend, depth, limit)
            if adm.max_queue_wait_s is not None:
                est = self._est_wait_locked(task.backend, depth)
                if est is not None and est > adm.max_queue_wait_s:
                    self._shed[task.backend] = (
                        self._shed.get(task.backend, 0) + 1)
                    raise Overloaded(task.backend, depth, adm.max_queue_wait_s,
                                     reason=f"est queue-wait {est:.3f}s")

    def _est_wait_locked(self, backend: str, depth: int) -> Optional[float]:
        """Estimated queue wait: depth x mean task time / workers.  None
        until the backend has completed at least one task (no estimate —
        admit).  Caller holds `_cond`."""
        agg = self._backend_exec.get(backend)
        if not agg or not agg["n"]:
            return None
        workers = max(1, self.backends.get(backend, 1))
        return depth * (agg["total_s"] / agg["n"]) / workers

    def submit(self, task: Task, block: bool = True) -> Task:
        """Windowed submission: blocks while `window` tasks are in flight.

        With admission control configured, an over-limit backend queue (or
        a submission window that stays full past `max_queue_wait_s`)
        raises `Overloaded` instead of queueing/blocking — the submit path
        has bounded latency under overload.
        """
        if self.admission is not None:
            self._admit(task)
            t0 = time.perf_counter()
            wait = self.admission.max_queue_wait_s
            if not self._sem.acquire(timeout=wait if wait else 30.0):
                with self._cond:
                    self._shed[task.backend] = (
                        self._shed.get(task.backend, 0) + 1)
                raise Overloaded(task.backend, self.window, self.window,
                                 reason="submission window full")
        else:
            t0 = time.perf_counter()
            self._sem.acquire()
        task.submit_t = time.perf_counter()
        task.admit_wait = task.submit_t - t0
        with self._cond:
            self._seq += 1
            self._outstanding += 1
            self._inflight_bytes += task.size_bytes
            self._peak_inflight_bytes = max(self._peak_inflight_bytes,
                                            self._inflight_bytes)
            heapq.heappush(self._queues.setdefault(task.backend, []),
                           (task.priority, self._seq, task))
            depth = len(self._queues[task.backend])
            if depth > self._depth_peak.get(task.backend, 0):
                self._depth_peak[task.backend] = depth
            self._cond.notify_all()
        if block and self.mode == "serial":
            task.done.wait()
        return task

    def map(self, tasks: List[Task]) -> List[Task]:
        for t in tasks:
            self.submit(t)
        for t in tasks:
            t.done.wait()
        return tasks

    def drain(self):
        with self._cond:
            self._cond.wait_for(lambda: self._outstanding == 0)

    def shutdown(self):
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)

    # ------------------------------------------------------------------
    def _steal_order(self, backend: str) -> Tuple[str, ...]:
        """Queues a worker may pop from, in preference order.

        Latency workers stay reserved for latency tasks; latency tasks are
        only ever stolen by throughput workers (keeps query tail latency
        isolated from rebuilds); throughput/background steal each other and
        any unowned backend class freely.
        """
        extras = tuple(b for b in self._queues
                       if b not in ("latency", "throughput", "background"))
        if backend == "latency":
            return ("latency",)
        if backend == "throughput":
            return ("throughput", "background") + extras + ("latency",)
        return (backend, "throughput", "background") + extras

    def _try_pop(self, backend: str) -> Optional[Task]:
        for name in self._steal_order(backend):
            q = self._queues.get(name)
            if q:
                return heapq.heappop(q)[2]
        return None

    def _worker(self, backend: str):
        while True:
            with self._cond:
                task = self._try_pop(backend)
                while task is None:
                    if self._stopping:
                        return           # queues we may serve are drained
                    self._cond.wait()
                    task = self._try_pop(backend)
            task.start_t = time.perf_counter()
            try:
                out = task.fn()
                _block_until_ready(out)
                task.result = out
            except BaseException as e:   # noqa: BLE001 - reported to caller
                task.error = e
            task.end_t = time.perf_counter()
            with self._cond:
                self._inflight_bytes -= task.size_bytes
                self._n_completed += 1
                agg = self._agg.setdefault(
                    task.kind, {"n": 0, "wait_total": 0.0, "lat_total": 0.0,
                                "admit_total": 0.0})
                agg["n"] += 1
                agg["wait_total"] += task.queue_wait
                agg["lat_total"] += task.latency
                agg["admit_total"] += task.admit_wait
                bex = self._backend_exec.setdefault(
                    task.backend, {"n": 0, "total_s": 0.0})
                bex["n"] += 1
                bex["total_s"] += task.end_t - task.start_t
            self._sem.release()
            task.done.set()
            # _outstanding is decremented only after done.set(), so a
            # drain()er waking on 0 never observes a task whose done event
            # (or result/error fields) has not been finalized yet
            with self._cond:
                self._outstanding -= 1
                self._cond.notify_all()   # wake drain()ers + idle stealers

    # ------------------------------------------------------------------
    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per kind, cumulative since start: tasks completed (`n`), their
        queue wait, latency and submission-window wait in seconds
        (`wait_s`, `lat_s`, `admit_wait_s`).  Host counters only."""
        with self._cond:
            return {k: {"n": int(a["n"]), "wait_s": a["wait_total"],
                        "lat_s": a["lat_total"],
                        "admit_wait_s": a["admit_total"]}
                    for k, a in self._agg.items()}

    def stats(self) -> dict:
        adm = self.admission
        with self._cond:
            agg = {k: dict(v) for k, v in self._agg.items()}
            peak = self._peak_inflight_bytes
            n_completed = self._n_completed
            admission = {
                "enabled": adm is not None,
                "queue_depth": {b: len(q) for b, q in self._queues.items()},
                "depth_peak": dict(self._depth_peak),
                "shed": dict(self._shed),
            }
            if adm is not None:
                admission["limits"] = {
                    b: adm.depth_limit(b) for b in self._queues}
                admission["max_queue_wait_s"] = adm.max_queue_wait_s

        out = {"peak_inflight_bytes": peak, "completed": n_completed,
               "admission": admission}
        for kind, a in agg.items():
            out[kind] = {
                "n": int(a["n"]),
                "mean_wait_ms": 1e3 * a["wait_total"] / max(a["n"], 1),
                "mean_ms": 1e3 * a["lat_total"] / max(a["n"], 1),
            }
        return out
