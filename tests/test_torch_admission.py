"""Admission control and the windowed scheduler of the port on the CPU.

The reference's `tests/test_admission.py` (overload degrades to a typed
`Overloaded` with bounded submit latency, background shed before latency
queries, recovery once the queues drain, the service's watermarks, the
maintenance poll counting a shed op as shed) and `tests/test_scheduler.py`
(windowed-batch invariants) run against `repro_torch.core.scheduler` and
`repro_torch.api.MemoryService`, test for test; the last test holds the
admission stats to the reference's keys and values under one overload.
`ReplicaSet.query` sheds to a replica exactly when admission raises
`Overloaded` (`tests/test_torch_replication.py`).
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.api import AdmissionControl, MemoryService, Overloaded
from repro_torch.api.ops import MemoryOp
from repro_torch.api.service import MaintenanceController
from repro_torch.configs.base import EngineConfig
from repro_torch.core.scheduler import Task, WindowedScheduler


def _wedge(sched, backend):
    """Block `backend`'s worker on a gate; returns the gate after the
    wedge task is actually running (so queue depths start at zero)."""
    gate = threading.Event()
    started = threading.Event()

    def fn():
        started.set()
        gate.wait()

    sched.submit(Task(fn=fn, kind="rebuild", backend=backend))
    assert started.wait(timeout=10), "wedge task never started"
    return gate


@pytest.mark.tier1
def test_overload_raises_typed_overloaded_not_hang():
    adm = AdmissionControl(max_queue_depth=2)
    sched = WindowedScheduler(backends={"latency": 1}, admission=adm)
    gate = _wedge(sched, "latency")
    try:
        for _ in range(adm.max_queue_depth):
            sched.submit(Task(fn=lambda: None, kind="query",
                              backend="latency"))
        t0 = time.perf_counter()
        with pytest.raises(Overloaded) as exc:
            sched.submit(Task(fn=lambda: None, kind="query",
                              backend="latency"))
        # bounded-latency rejection: the typed error is raised pre-queue,
        # not after a window/queue wait
        assert time.perf_counter() - t0 < 1.0
        assert exc.value.backend == "latency"
        assert exc.value.depth == 2 and exc.value.limit == 2
        assert exc.value.reason == "queue-depth"
        adm_stats = sched.stats()["admission"]
        assert adm_stats["enabled"]
        assert adm_stats["shed"]["latency"] == 1
        assert adm_stats["depth_peak"]["latency"] == 2
        assert adm_stats["limits"]["latency"] == 2
    finally:
        gate.set()
    # recovery: once the queue drains, the same submit is admitted (the
    # drain is asynchronous — poll the depth down before resubmitting)
    deadline = time.perf_counter() + 10
    while (sched.stats()["admission"]["queue_depth"].get("latency", 0) > 0
           and time.perf_counter() < deadline):
        time.sleep(0.01)
    task = sched.submit(Task(fn=lambda: 7, kind="query", backend="latency"))
    assert task.done.wait(timeout=10) and task.result == 7
    assert sched.stats()["admission"]["queue_depth"]["latency"] == 0
    sched.shutdown()


@pytest.mark.tier1
def test_background_shed_before_latency():
    # background gets only background_frac of the depth budget: under the
    # same overload, maintenance is rejected while queries still queue
    adm = AdmissionControl(max_queue_depth=4, background_frac=0.5)
    sched = WindowedScheduler(window=16, backends={"background": 1},
                              admission=adm)
    gate = _wedge(sched, "background")
    try:
        for _ in range(2):                 # frac * 4 = 2 admitted
            sched.submit(Task(fn=lambda: None, kind="rebuild",
                              backend="background"))
        with pytest.raises(Overloaded) as exc:
            sched.submit(Task(fn=lambda: None, kind="rebuild",
                              backend="background"))
        assert exc.value.limit == 2
        for _ in range(4):                 # full budget for latency
            sched.submit(Task(fn=lambda: None, kind="query",
                              backend="latency"))
        with pytest.raises(Overloaded):
            sched.submit(Task(fn=lambda: None, kind="query",
                              backend="latency"))
        shed = sched.stats()["admission"]["shed"]
        assert shed == {"background": 1, "latency": 1}
    finally:
        gate.set()
    sched.shutdown()


@pytest.mark.tier1
def test_estimated_queue_wait_rejection():
    adm = AdmissionControl(max_queue_depth=100, max_queue_wait_s=0.05)
    sched = WindowedScheduler(backends={"latency": 1}, admission=adm)
    # teach the estimator this backend's mean task time (~0.2s)
    seed = sched.submit(Task(fn=lambda: time.sleep(0.2), kind="query",
                             backend="latency"))
    assert seed.done.wait(timeout=10)
    gate = _wedge(sched, "latency")
    try:
        # depth 0: estimated wait 0 — admitted even with a slow backend
        sched.submit(Task(fn=lambda: None, kind="query", backend="latency"))
        # depth 1: est ~= 1 x 0.2s / 1 worker >> 0.05s — typed rejection
        with pytest.raises(Overloaded) as exc:
            sched.submit(Task(fn=lambda: None, kind="query",
                              backend="latency"))
        assert exc.value.reason.startswith("est queue-wait")
    finally:
        gate.set()
    sched.shutdown()


@pytest.mark.tier1
def test_full_submission_window_rejects_not_hangs():
    adm = AdmissionControl(max_queue_depth=100, max_queue_wait_s=0.2)
    sched = WindowedScheduler(window=2, backends={"latency": 1},
                              admission=adm)
    gate = _wedge(sched, "latency")        # 1 of 2 window slots in flight
    try:
        sched.submit(Task(fn=lambda: None, kind="query", backend="latency"))
        t0 = time.perf_counter()
        with pytest.raises(Overloaded) as exc:   # window full: bounded wait
            sched.submit(Task(fn=lambda: None, kind="query",
                              backend="latency"))
        assert 0.2 <= time.perf_counter() - t0 < 5.0
        assert exc.value.reason == "submission window full"
    finally:
        gate.set()
    sched.shutdown()


@pytest.mark.tier1
def test_service_exposes_admission_watermarks():
    adm = AdmissionControl(max_queue_depth=8)
    with MemoryService(maintenance=False, admission=adm,
                       device="cpu") as svc:
        cfg = EngineConfig(dim=128, n_clusters=128, list_capacity=64,
                           nprobe=64, k=10, use_kernel=False, kmeans_iters=3)
        svc.create_collection("mem", cfg)
        rng = np.random.default_rng(0)
        svc.build("mem", rng.standard_normal((256, 128)).astype(np.float32))
        ids, _ = svc.query("mem", rng.standard_normal(
            (4, 128)).astype(np.float32))
        assert ids.shape == (4, 10)
        stats = svc.stats()["scheduler"]["admission"]
        assert stats["enabled"]
        assert stats["limits"]["latency"] == 8
        assert stats["limits"]["background"] == 4     # frac of the budget
        assert all(d == 0 for d in stats["queue_depth"].values())
        assert stats["depth_peak"].get("latency", 0) <= 8


@pytest.mark.tier1
def test_maintenance_controller_counts_shed_not_failed(monkeypatch):
    svc = MemoryService(maintenance=False, device="cpu")
    ctrl = MaintenanceController(svc, poll_interval_s=0.01)
    try:
        def overloaded_submit(op):
            raise Overloaded("background", 2, 2)

        monkeypatch.setattr(svc, "submit", overloaded_submit)
        key = ("mem", None)
        op = MemoryOp("rebuild", "mem")
        # a shed background op is NOT a failure: it backs off one poll
        # interval and re-offers, without tripping the failure backoff
        assert not ctrl._try_submit(key, op)
        assert ctrl.stats()["shed"] == 1
        assert ctrl.stats()["failed"] == 0
        assert not ctrl._try_submit(key, op)      # still inside the backoff
        assert ctrl.stats()["shed"] == 1

        class _Fut:
            def done(self):
                return False

        monkeypatch.setattr(svc, "submit", lambda op: _Fut())
        time.sleep(0.05)                          # one poll interval later
        assert ctrl._try_submit(key, op)          # re-offered and accepted
        assert ctrl.stats()["failed"] == 0
    finally:
        ctrl.stop()
        svc.shutdown()


# ---------------------------------------------------------------------------
# The reference's scheduler invariants (tests/test_scheduler.py)
# ---------------------------------------------------------------------------


def _task(kind="query", backend="throughput", ms=2.0, size=100):
    def fn():
        time.sleep(ms / 1e3)
        return None
    return Task(fn=fn, kind=kind, backend=backend, size_bytes=size)


def test_all_tasks_complete():
    s = WindowedScheduler(window=4)
    tasks = [_task() for _ in range(32)]
    s.map(tasks)
    assert all(t.error is None for t in tasks)
    assert s.stats()["completed"] == 32
    s.shutdown()


def test_windowed_bounds_peak_memory():
    """Peak in-flight bytes must be <= window * task size (the paper's point)."""
    s = WindowedScheduler(window=4)
    s.map([_task(size=1000) for _ in range(64)])
    windowed_peak = s.stats()["peak_inflight_bytes"]
    s.shutdown()

    s2 = WindowedScheduler(window=4, mode="all")
    s2.map([_task(size=1000) for _ in range(64)])
    flood_peak = s2.stats()["peak_inflight_bytes"]
    s2.shutdown()

    assert windowed_peak <= 4 * 1000
    assert flood_peak > windowed_peak


def test_windowed_faster_than_serial():
    s = WindowedScheduler(window=8)
    t0 = time.perf_counter()
    s.map([_task(ms=5) for _ in range(24)])
    windowed = time.perf_counter() - t0
    s.shutdown()

    s2 = WindowedScheduler(window=1, mode="serial")
    t0 = time.perf_counter()
    s2.map([_task(ms=5) for _ in range(24)])
    serial = time.perf_counter() - t0
    s2.shutdown()
    assert windowed < serial


def test_latency_class_isolated_from_background():
    """Queries keep low tail latency while a rebuild hogs the background lane."""
    s = WindowedScheduler(window=8)
    bg = [_task(kind="rebuild", backend="background", ms=50) for _ in range(4)]
    for t in bg:
        s.submit(t)
    queries = [_task(kind="query", backend="latency", ms=1) for _ in range(16)]
    for t in queries:
        s.submit(t)
    for t in bg + queries:
        t.done.wait()
    st = s.stats()
    s.shutdown()
    assert st["query"]["n"] == 16 and st["rebuild"]["n"] == 4
    # the slowest query beats the rebuilds' mean (50, 100, 150, 200 ms)
    assert 1e3 * max(t.latency for t in queries) < st["rebuild"]["mean_ms"]
    assert st["query"]["mean_ms"] < st["rebuild"]["mean_ms"]


def test_completed_history_bounded_but_stats_cumulative():
    """Sustained traffic must not grow the scheduler: it retains no
    completed task, while counts/means come from cumulative aggregates."""
    import gc
    import weakref
    s = WindowedScheduler(window=8)
    tasks = [_task(ms=0.5) for _ in range(50)]
    s.map(tasks)
    refs = [weakref.ref(t) for t in tasks]
    del tasks
    gc.collect()
    st = s.stats()
    totals = s.totals()
    s.shutdown()
    assert st["completed"] == 50                  # cumulative, not truncated
    assert st["query"]["n"] == 50 == totals["query"]["n"]
    assert st["query"]["mean_wait_ms"] >= 0.0
    assert st["query"]["mean_ms"] == pytest.approx(
        1e3 * totals["query"]["lat_s"] / 50)
    assert all(r() is None for r in refs)         # nothing retained per task


def test_a_blocked_submission_window_counts_admit_wait():
    """A submit that blocks on the full window counts that wait apart from
    the queue wait, which starts once the task is queued."""
    s = WindowedScheduler(window=1)
    gate = threading.Event()
    first = Task(fn=gate.wait, kind="rebuild", backend="background")
    s.submit(first)
    second = Task(fn=lambda: None, kind="query", backend="latency")
    th = threading.Thread(target=s.submit, args=(second,))
    th.start()
    time.sleep(0.2)
    assert second.submit_t == 0.0                 # still blocked in submit
    gate.set()
    th.join(timeout=10)
    second.done.wait(timeout=10)
    totals = s.totals()
    s.shutdown()
    assert second.admit_wait >= 0.15
    assert totals["query"]["admit_wait_s"] == second.admit_wait
    assert totals["query"]["wait_s"] < 0.15
    assert totals["rebuild"]["admit_wait_s"] < 0.05


def test_unowned_backend_class_is_stolen():
    """Tasks routed to a backend class nobody owns still complete (picked
    up by throughput/background stealers instead of queueing forever)."""
    s = WindowedScheduler(window=4)
    tasks = [_task(backend="npu") for _ in range(6)]
    s.map(tasks)
    s.shutdown()
    assert all(t.error is None and t.done.is_set() for t in tasks)


def test_latency_tasks_never_run_on_background_workers():
    names = []

    def fn():
        names.append(threading.current_thread().name)
        time.sleep(0.001)

    s = WindowedScheduler(window=8)
    tasks = [Task(fn=fn, kind="query", backend="latency") for _ in range(12)]
    s.map(tasks)
    s.shutdown()
    assert len(names) == 12
    assert all(not n.startswith("ame-background") for n in names)


def test_drain_waits_for_everything_outstanding():
    s = WindowedScheduler(window=4)
    tasks = [_task(ms=10) for _ in range(8)]
    for t in tasks:
        s.submit(t)
    s.drain()
    assert all(t.done.is_set() for t in tasks)
    assert s.stats()["completed"] == 8
    s.shutdown()


def test_errors_are_captured_not_raised():
    def boom():
        raise RuntimeError("kaput")
    s = WindowedScheduler(window=2)
    t = Task(fn=boom, kind="query", backend="throughput")
    s.submit(t)
    t.done.wait()
    s.shutdown()
    assert isinstance(t.error, RuntimeError)


def test_admission_stats_match_reference_under_one_overload():
    """The same wedge and overload through both packages' schedulers: the
    same typed rejections and the same admission stats."""
    from repro.core.scheduler import AdmissionControl as JAdmissionControl
    from repro.core.scheduler import Overloaded as JOverloaded
    from repro.core.scheduler import Task as JTask
    from repro.core.scheduler import WindowedScheduler as JWindowedScheduler

    out = []
    for adm_cls, sched_cls, task_cls, over in (
            (AdmissionControl, WindowedScheduler, Task, Overloaded),
            (JAdmissionControl, JWindowedScheduler, JTask, JOverloaded)):
        sched = sched_cls(window=16, backends={"latency": 1, "background": 1},
                          admission=adm_cls(max_queue_depth=4,
                                            background_frac=0.5))
        gates = [_wedge(sched, b) for b in ("background", "latency")]
        errs = []
        try:
            for kind, backend in (("rebuild", "background"),) * 3 + \
                    (("query", "latency"),) * 5:
                try:
                    sched.submit(task_cls(fn=lambda: None, kind=kind,
                                          backend=backend))
                except over as e:
                    errs.append((e.backend, e.depth, e.limit, e.reason))
            adm = sched.stats()["admission"]
        finally:
            for g in gates:
                g.set()
        sched.shutdown()
        out.append((errs, adm))
    (errs, adm), (jerrs, jadm) = out
    assert errs == jerrs == [("background", 2, 2, "queue-depth"),
                             ("latency", 4, 4, "queue-depth")]
    assert adm == jadm
