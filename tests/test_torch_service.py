"""The port's service layer on the CPU: MemoryService lifecycle, lost-update
safety of the delta-replay rebuild, workload-triggered maintenance, and the
same op sequence through the JAX and the port services.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.api import MemoryService as JMemoryService
from repro.configs.base import EngineConfig as JConfig
from repro_torch.api import Collection, MemoryOp, MemoryService
from repro_torch.configs.base import EngineConfig
from repro_torch.core import locking, templates

jax.config.update("jax_platform_name", "cpu")

ARGS = dict(dim=128, n_clusters=128, list_capacity=32, nprobe=8, k=4,
            kmeans_iters=2)
CFG = EngineConfig(**ARGS)
N0 = 512
INS_BATCH = 16
DEL_BATCH = 8


@pytest.fixture(autouse=True)
def _port_lock_order_guard():
    """With AME_DEBUG_LOCKS=1 the port's locks record their acquisition
    order in repro_torch's own validator; fail the test that inverted it."""
    if not locking.debug_enabled():
        yield
        return
    locking.validator.reset()
    yield
    violations = locking.validator.drain()
    assert not violations, "\n".join(violations)


def _corpus(n, seed=0, dim=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _live(coll):
    st = coll.snapshot()
    ids = torch.cat([st.list_ids.reshape(-1), st.spill_ids]).numpy()
    return set(ids[ids >= 0].tolist())


@pytest.fixture
def service():
    svc = MemoryService(device="cpu", maintenance=False)
    yield svc
    svc.shutdown()


def test_lifecycle_sync_equals_futures(service):
    service.create_collection("a", CFG)
    x = _corpus(N0)
    out = service.build("a", x)
    assert out["spilled"] >= 0 and service.collection("a").counters["rebuilds"] == 1
    q = x[:3] + 0.01
    sync = service.query("a", q)
    fut = service.submit(MemoryOp("query", "a", q))
    got = fut.result(timeout=30)
    np.testing.assert_array_equal(got[0], sync[0])
    np.testing.assert_array_equal(got[1], sync[1])
    np.testing.assert_array_equal(sync[0][:, 0], [0, 1, 2])
    # writes through futures land before their result is read
    rows = _corpus(INS_BATCH, seed=1)
    f = service.submit(MemoryOp("insert", "a", rows,
                                ids=np.arange(900, 900 + INS_BATCH),
                                concurrent=True))
    assert f.result(timeout=30) >= 0
    ids, _ = service.query("a", rows[:4], path="full_scan")
    np.testing.assert_array_equal(ids[:, 0], np.arange(900, 904))
    assert service.delete("a", np.arange(10)) == 10
    assert service.submit(MemoryOp("delete", "a", np.arange(10))).result(
        timeout=30) == 0
    r = service.rebuild("a")
    assert not r["aborted"]
    st = service.stats()["collections"]["a"]
    assert st["live"] == N0 + INS_BATCH - 10 and st["deleted"] == 0
    assert st["queries"] == 3 + 3 + 4 and st["residency"] == "hot"
    assert service.stats()["scheduler"]["completed"] >= 7


def test_routing_picks_probed_then_full_scan(service):
    coll = service.create_collection("a", CFG)
    # from_profile: full_scan_batch = 128 / (8 * 8) = 2
    assert coll.resolve_query(1, None, None, None) == (4, 8, "probed")
    assert coll.resolve_query(2, None, None, None) == (4, 0, "full_scan")
    assert coll.resolve_query(1, None, 10_000, None)[1] == 128   # clamped


def test_future_errors_and_registry(service):
    service.create_collection("a", CFG)
    with pytest.raises(ValueError):
        service.create_collection("a", CFG)
    with pytest.raises(KeyError):
        service.submit(MemoryOp("query", "missing", _corpus(1)))
    fut = service.submit(MemoryOp("insert", "a", _corpus(4)))
    with pytest.raises(RuntimeError, match="build"):
        fut.result(timeout=30)                   # insert before build
    assert service.list_collections() == ["a"] and "a" in service


@pytest.mark.parametrize("call", [
    lambda s: s.create_collection("b", dataclasses.replace(CFG,
                                                           shard_db=True)),
    lambda s: MemoryService.load("unused", mesh=object(), device="cpu"),
])
def test_later_slices_raise_not_implemented(service, call):
    """The sharded tier, the last later slice behind these calls, is
    ported: they raise the reference's own errors now (a sharded config
    without a mesh; a missing service directory), never NotImplementedError."""
    service.create_collection("a", CFG)
    with pytest.raises((ValueError, FileNotFoundError),
                       match="needs a mesh|unused") as err:
        call(service)
    assert not isinstance(err.value, NotImplementedError)


def test_service_without_cuda_and_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MemoryService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Collection("c", CFG)


def test_rebuild_delta_replay_loses_no_writes():
    coll = Collection("c", CFG, spill_capacity=2048, device="cpu")
    coll.build(_corpus(N0))
    inserted, deleted, errors = set(), set(), []

    def inserter():
        try:
            for i in range(10):
                ids = np.arange(10_000 + i * INS_BATCH,
                                10_000 + (i + 1) * INS_BATCH)
                coll.insert(_corpus(INS_BATCH, seed=100 + i), ids=ids)
                inserted.update(ids.tolist())
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    def deleter():
        try:
            for i in range(6):
                ids = np.arange(i * DEL_BATCH, (i + 1) * DEL_BATCH)
                assert coll.delete(ids) == DEL_BATCH
                deleted.update(ids.tolist())
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    def querier(stop):
        try:
            while not stop.is_set():
                ids, _ = coll.query(_corpus(2, seed=7), k=4)
                assert ids.shape == (2, 4)
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    stop = threading.Event()
    writers = [threading.Thread(target=inserter),
               threading.Thread(target=deleter)]
    readers = [threading.Thread(target=querier, args=(stop,))]
    for t in writers + readers:
        t.start()
    rebuilds = 0
    while any(t.is_alive() for t in writers):
        out = coll.rebuild()
        assert not out["aborted"]
        rebuilds += 1
    for t in writers:
        t.join(60)
    stop.set()
    for t in readers:
        t.join(60)
    assert not any(t.is_alive() for t in writers + readers)
    assert not errors, errors
    assert rebuilds >= 1
    want = (set(range(N0)) - deleted) | inserted
    assert _live(coll) == want                   # zero lost rows
    assert coll.counters["inserts"] == 10 * INS_BATCH
    assert coll.counters["deletes"] == 6 * DEL_BATCH
    coll.rebuild()
    assert coll.stats()["deleted"] == 0
    assert _live(coll) == want


def test_bulk_build_aborts_inflight_rebuild():
    coll = Collection("c", CFG, device="cpu")
    coll.build(_corpus(N0))
    entered, release = threading.Event(), threading.Event()
    orig_split = coll._split

    def slow_split():
        entered.set()                 # the rebuild has taken its snapshot
        release.wait(10)              # hold it in its compute phase
        return orig_split()

    coll._split = slow_split
    out = {}
    t = threading.Thread(target=lambda: out.update(coll.rebuild()))
    t.start()
    assert entered.wait(10)
    coll._split = orig_split
    coll.build(_corpus(256, seed=9), ids=np.arange(50_000, 50_256))
    release.set()
    t.join(30)
    assert out["aborted"]
    assert _live(coll) == set(range(50_000, 50_256))


def test_delta_log_overflow_restarts_rebuild():
    coll = Collection("c", CFG, delta_log_capacity=1, device="cpu")
    coll.build(_corpus(N0))
    orig_split = coll._split
    calls = []

    def split_then_write():
        gen = orig_split()
        if not calls:                 # during the first recompute: 2 writes
            calls.append(1)
            coll.insert(_corpus(4, seed=11), ids=np.arange(7000, 7004))
            coll.delete(np.arange(3))
        return gen

    coll._split = split_then_write
    out = coll.rebuild()
    assert out["restarts"] == 1 and not out["aborted"]
    assert _live(coll) == (set(range(N0)) - {0, 1, 2}) | set(range(7000, 7004))


def test_service_auto_rebuild_from_tombstone_pressure():
    th = templates.TemplateThresholds(maintenance_tombstone_frac=0.01,
                                      maintenance_min_pending=32)
    svc = MemoryService(device="cpu", maintenance_poll_interval_s=0.02)
    try:
        svc.create_collection("c", CFG, spill_capacity=2048, thresholds=th)
        assert svc.maintenance is not None
        svc.build("c", _corpus(N0, seed=3))
        assert svc.delete("c", np.arange(64)) == 64
        deadline = time.time() + 60
        while time.time() < deadline:
            st = svc.collection("c").stats()
            if st["rebuilds"] >= 2 and st["deleted"] == 0:
                break
            time.sleep(0.05)
        st = svc.collection("c").stats()
        assert st["rebuilds"] >= 2, st            # auto-triggered rebuild ran
        assert st["deleted"] == 0 and st["pressure"]["tombstones"] == 0
        assert svc.stats()["maintenance"]["triggered"] >= 1
        assert st["live"] == N0 - 64
    finally:
        svc.shutdown()


def test_maintenance_due_on_spill_pressure_and_floor():
    th = templates.TemplateThresholds(maintenance_spill_frac=0.25,
                                      maintenance_min_pending=1)
    cfg = EngineConfig(**{**ARGS, "list_capacity": 8})
    coll = Collection("c", cfg, spill_capacity=64, thresholds=th,
                      device="cpu")
    coll.build(_corpus(256, seed=5))
    assert not coll.maintenance_due()
    burst = np.repeat(_corpus(1, seed=6), 40, axis=0)  # one list overflows
    coll.insert(burst)
    assert coll.maintenance_pressure()["spilled"] >= 16
    assert coll.maintenance_due() and coll.maintenance_due_shards() == [0]
    coll.rebuild()
    # what the rebuild could not place is the floor, not new pressure
    assert coll._spill_floor == coll.maintenance_pressure()["spilled"]
    assert not coll.maintenance_due()


def test_same_ops_through_both_services_give_same_full_scan_ids():
    """Build + insert + delete through the JAX and the port services: the
    exact full scan returns the same ids up to ties, whatever the RNG."""
    x = _corpus(N0, seed=12)
    rows = _corpus(INS_BATCH, seed=13)
    q = np.concatenate([x[101:105], rows[:2]]) + 0.01
    out = []
    for svc, cfg in ((JMemoryService(maintenance=False),
                      JConfig(use_kernel=False, **ARGS)),
                     (MemoryService(device="cpu", maintenance=False), CFG)):
        try:
            svc.create_collection("m", cfg)
            svc.build("m", x)
            svc.insert("m", rows, ids=np.arange(5000, 5000 + INS_BATCH))
            svc.delete("m", np.arange(0, 512, 5))
            out.append(svc.query("m", q, k=6, path="full_scan"))
        finally:
            svc.shutdown()
    (jids, jsc), (tids, tsc) = out
    np.testing.assert_allclose(tsc, np.asarray(jsc), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tids[:, 0], np.asarray(jids)[:, 0])
    for a, b in zip(tids, np.asarray(jids)):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_array_equal(tids[:, 0], [101, 102, 103, 104, 5000, 5001])


def test_counters_consistent_under_concurrent_queries(service):
    service.create_collection("a", CFG)
    service.build("a", _corpus(N0))
    q = _corpus(1, seed=3)
    errors = []

    def hammer():
        try:
            for _ in range(10):
                service.query("a", q)
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert service.collection("a").counters["queries"] == 60
