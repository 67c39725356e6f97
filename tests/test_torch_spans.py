"""The port's spans and counters on the CPU: the spans a service's ops
record on the scheduler's worker threads under a profiler, nothing
recorded without one, the writer lock's counters under a rebuild that
races a writer, and `MemoryService.counters()` read without a device sync.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import MemoryService
from repro_torch.configs.base import EngineConfig
from repro_torch.core import index as ivf
from repro_torch.core import spans

CFG = EngineConfig(dim=128, n_clusters=128, list_capacity=32, nprobe=8, k=4,
                   kmeans_iters=2)
N0 = 512


def _rows(n, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, 128),
                                                    dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture
def svc():
    s = MemoryService(device="cpu", maintenance=False)
    s.create_collection("m", CFG, spill_capacity=64)
    s.build("m", _rows(N0), ids=np.arange(N0, dtype=np.int32))
    yield s
    s.shutdown()


def _traced(fn):
    """Host events of `fn()` under a profiler started as the benchmark's
    traced run starts it (every thread's host operators)."""
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=[ProfilerActivity.CPU], **kw)
    prof.start()
    try:
        with torch.profiler.record_function("test.main"):
            fn()
    finally:
        prof.stop()
    return list(prof.profiler.kineto_results.events())


def _ops(s):
    x = _rows(8, seed=1)
    s.query("m", x[:1], path="probed")
    s.query("m", x[:4], path="full_scan")
    s.insert("m", _rows(16, seed=2), ids=np.arange(N0, N0 + 16,
                                                   dtype=np.int32))
    s.delete("m", np.arange(4, dtype=np.int32))
    s.rebuild("m")


WRITTEN = {"ame.coll.query.to_host", "ame.coll.writer_lock",
           "ame.coll.rebuild.replay", "ame.index.probed",
           "ame.index.probed.gather", "ame.index.full_scan.flat_copy",
           "ame.index.full_scan.scan", "ame.index.insert.clone",
           "ame.index.delete.mask", "ame.index.rebuild.flat_copy",
           "ame.index.rebuild.cluster"}


def test_a_services_ops_record_their_spans_on_the_worker_threads(svc):
    events = _traced(lambda: _ops(svc))
    main = {e.start_thread_id() for e in events if e.name() == "test.main"}
    ame = [e for e in events if e.name().startswith("ame.")]
    assert {e.name() for e in ame} == WRITTEN
    # the ops ran on the scheduler's workers, not on the caller's thread
    assert not {e.start_thread_id() for e in ame} & main
    # a span's cause encloses it on its thread: the probed path's gathers
    # lie inside the probed span
    outer = [e for e in ame if e.name() == "ame.index.probed"]
    for g in (e for e in ame if e.name() == "ame.index.probed.gather"):
        assert any(o.start_thread_id() == g.start_thread_id()
                   and o.start_ns() <= g.start_ns()
                   and g.start_ns() + g.duration_ns()
                   <= o.start_ns() + o.duration_ns() for o in outer)
    # two gathers (rows, ids) for the one probed vector
    assert sum(e.name() == "ame.index.probed.gather" for e in ame) == 2


def test_without_a_profiler_a_span_records_nothing(svc, monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("a range was opened with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert spans.span("ame.a") is spans.span("ame.b")      # one shared no-op
    _ops(svc)
    assert svc.collection("m").counters["rebuilds"] == 2


def test_a_rebuild_racing_a_writer_counts_the_writer_lock(svc, monkeypatch):
    coll = svc.collection("m")
    racing = np.arange(N0, N0 + 24, dtype=np.int32)
    late = np.arange(N0 + 24, N0 + 40, dtype=np.int32)
    real_rebuild, real_replay = ivf.rebuild, ivf.replay
    waiter = []

    def rebuild(*a, **kw):
        # off the lock: this insert lands in the delta log
        coll.insert(_rows(24, seed=3), ids=racing)
        return real_rebuild(*a, **kw)

    def replay(*a, **kw):
        # under the lock: this insert waits for the publish step
        th = threading.Thread(target=coll.insert,
                              args=(_rows(16, seed=4),), kwargs={"ids": late})
        th.start()
        waiter.append(th)
        time.sleep(0.2)
        return real_replay(*a, **kw)
    monkeypatch.setattr(ivf, "rebuild", rebuild)
    monkeypatch.setattr(ivf, "replay", replay)
    before = dict(coll.writer_counters)
    out = svc.rebuild("m")
    waiter[0].join(timeout=30)
    c = coll.writer_counters
    assert out["replayed"] == 24 and out["restarts"] == 0
    assert c["rebuild_replayed_rows"] - before["rebuild_replayed_rows"] == 24
    assert c["rebuild_restarts"] == before["rebuild_restarts"]
    assert c["rebuild_lock_hold_s"] - before["rebuild_lock_hold_s"] >= 0.2
    assert c["insert_calls"] - before["insert_calls"] == 2
    assert c["insert_lock_wait_s"] - before["insert_lock_wait_s"] >= 0.15
    got = svc.counters()
    assert got["coll.m.rebuild_replayed_rows"] == c["rebuild_replayed_rows"]
    assert got["coll.m.insert_lock_wait_s"] == c["insert_lock_wait_s"]
    assert got["coll.m.inserts"] == 40


def test_counters_read_no_device_value(svc, monkeypatch):
    _ops(svc)

    def refused(*a, **kw):
        raise AssertionError("counters() read a device value")
    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refused)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    got = svc.counters()
    assert all(type(v) in (int, float) for v in got.values())
    assert got["sched.query.n"] == 2 and got["coll.m.queries"] == 5
    assert got["sched.rebuild.admit_wait_s"] >= 0.0
    assert {"launches.scan_scores.stream", "launches.kmeans_assign.wgmma",
            "launches.segsum_gemm"} <= set(got)


def test_concurrent_writers_lose_no_count(svc):
    """More inserting threads than cores, with a short switch interval:
    every call is counted once in `writer_counters` and in `counters`."""
    coll = svc.collection("m")
    n_threads, calls, rows = len(os.sched_getaffinity(0)) + 2, 4, 8
    ids = iter(range(N0, N0 + n_threads * calls * rows, rows))
    lock = threading.Lock()

    def writer(seed):
        for j in range(calls):
            with lock:
                start = next(ids)
            coll.insert(_rows(rows, seed=seed * 100 + j),
                        ids=np.arange(start, start + rows, dtype=np.int32))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert coll.writer_counters["insert_calls"] == n_threads * calls
    assert coll.counters["inserts"] == n_threads * calls * rows
    assert coll.writer_counters["insert_lock_wait_s"] > 0
