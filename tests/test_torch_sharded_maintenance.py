"""Shard-local maintenance on mesh-sharded collections of the port.

The reference's ten cases of tests/test_sharded_maintenance.py, with the
same sizes and assertions, run against `repro_torch` on a 2-shard
`ShardMesh` of CPU shards: shard-local tombstoning and rebuilds (siblings'
tensors — the same storage — and versions untouched), zero lost rows under
concurrent writes and shard rebuilds (the reference's own case of it stops
at a jax 0.9 ShardingTypeError in `dist_replay`; the port holds the
invariant on its own), per-shard pressure driving the MaintenanceController,
and sharded save/load with the mesh check and resharding.  Then sharded
namespaces cross-load: one package saves, the other loads the same live set.
"""
import tempfile
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.api import Collection as JCollection
from repro.configs.base import EngineConfig as JConfig
from repro.core import distributed as jdce
from repro_torch.api import Collection, MemoryService
from repro_torch.configs.base import EngineConfig
from repro_torch.core import distributed as dce
from repro_torch.core import locking
from repro_torch.core import templates

N_SHARDS = 2
ARGS = dict(dim=128, n_clusters=128, list_capacity=16, nprobe=8, k=4,
            use_kernel=False, kmeans_iters=2)
CFG = EngineConfig(shard_db=True, **ARGS)
N0 = 512
INS_BATCH = 16           # divisible by N_SHARDS
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


@pytest.fixture(scope="module")
def mesh():
    return dce.make_mesh((N_SHARDS,), ("shard",), "cpu")


def _corpus(n, seed=0, dim=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _live_ids(state):
    """External ids live in a state: one IVFState (either package) or the
    port's tuple of shard-local ones."""
    shards = [state] if hasattr(state, "list_ids") else state
    ids = np.concatenate([np.concatenate([np.asarray(s.list_ids).ravel(),
                                          np.asarray(s.spill_ids).ravel()])
                          for s in shards])
    return set(ids[ids >= 0].tolist())


def _built(mesh, seed=0, spill_capacity=1024, thresholds=None):
    coll = Collection("c", CFG, mesh=mesh, spill_capacity=spill_capacity,
                      thresholds=thresholds)
    coll.build(_corpus(N0, seed=seed))            # ids 0 .. N0-1
    return coll


# ---------------------------------------------------------------------------
# Delete + rebuild lifecycle
# ---------------------------------------------------------------------------

def test_sharded_delete_then_rebuild_reclaims(mesh):
    coll = _built(mesh)
    n = coll.delete(np.arange(64))
    assert n == 64                                # every id existed once
    assert _live_ids(coll.snapshot()) == set(range(64, N0))
    press = coll.maintenance_pressure()
    assert press["tombstones"] == 64
    assert sum(p["tombstones"] for p in press["shards"]) == 64
    out = coll.rebuild()                          # sweeps both shards
    assert not out["aborted"] and out["shards"] == [0, 1]
    st = coll.stats()
    assert st["deleted"] == 0                     # tombstones reclaimed
    assert st["pressure"]["tombstones"] == 0
    assert _live_ids(coll.snapshot()) == set(range(64, N0))
    # deleting a missing id reports 0 hits
    assert coll.delete(np.asarray([999_999])) == 0


def test_shard_local_rebuild_leaves_siblings_untouched(mesh):
    coll = _built(mesh, seed=1)
    coll.delete(np.arange(96))
    pre = coll.snapshot()
    pre_press = coll.maintenance_pressure()["shards"]
    v0 = coll.shard_versions()
    # pick the shard that actually holds tombstones; rebuild only it
    deleted = [int(s.num_deleted) for s in pre]
    target = int(np.argmax(deleted))
    sibling = 1 - target
    out = coll.rebuild(shard=target)
    assert not out["aborted"] and out["shard"] == target
    v1 = coll.shard_versions()
    assert v1[target] == v0[target] + 1           # rebuilt shard bumped
    assert v1[sibling] == v0[sibling]             # sibling version untouched
    post = coll.snapshot()
    # sibling tensors bitwise identical, the same storage
    for a, b in zip(pre[sibling], post[sibling]):
        if a is not None:
            assert torch.equal(a, b) and a.data_ptr() == b.data_ptr()
    # rebuilt shard reclaimed its tombstones; sibling kept its own
    assert int(post[target].num_deleted) == 0
    assert int(post[sibling].num_deleted) == deleted[sibling]
    after_press = coll.maintenance_pressure()["shards"]
    assert after_press[target]["tombstones"] == 0
    assert after_press[sibling]["tombstones"] == pre_press[sibling]["tombstones"]
    assert _live_ids(coll.snapshot()) == set(range(96, N0))


def test_sharded_concurrent_writes_rebuild_zero_lost_rows(mesh):
    coll = _built(mesh, seed=2)
    n_ins_batches, n_del_batches = 10, 6
    inserted, deleted, errors = set(), set(), []

    def inserter():
        try:
            for i in range(n_ins_batches):
                ids = np.arange(10_000 + i * INS_BATCH,
                                10_000 + (i + 1) * INS_BATCH)
                coll.insert(_corpus(INS_BATCH, seed=100 + i), ids=ids)
                inserted.update(ids.tolist())
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    def deleter():
        try:
            for i in range(n_del_batches):
                ids = np.arange(i * DEL_BATCH, (i + 1) * DEL_BATCH)
                assert coll.delete(ids) == DEL_BATCH
                deleted.update(ids.tolist())
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=inserter),
               threading.Thread(target=deleter)]
    for t in threads:
        t.start()
    # alternate shard-local rebuilds while the writers churn: the per-shard
    # delta log must replay every concurrent write onto the rebuilt shard
    rebuilds = 0
    while any(t.is_alive() for t in threads):
        out = coll.rebuild(shard=rebuilds % N_SHARDS)
        assert not out["aborted"]
        rebuilds += 1
    for t in threads:
        t.join()
    assert not errors, errors
    assert rebuilds >= 1

    want = (set(range(N0)) - deleted) | inserted
    assert _live_ids(coll.snapshot()) == want     # zero lost rows
    assert coll.counters["inserts"] == n_ins_batches * INS_BATCH
    assert coll.counters["deletes"] == n_del_batches * DEL_BATCH
    # a quiet full sweep reclaims all remaining tombstones
    coll.rebuild()
    assert coll.stats()["deleted"] == 0
    assert _live_ids(coll.snapshot()) == want


def test_sharded_insert_batch_must_divide(mesh):
    coll = _built(mesh, seed=3)
    with pytest.raises(ValueError, match="divide over the 2-shard mesh"):
        coll.insert(_corpus(3, seed=9), ids=np.arange(70_000, 70_003))
    with pytest.raises(ValueError, match="shards 0..1"):
        coll.rebuild(shard=5)


def test_unsharded_rebuild_rejects_shard_arg():
    coll = Collection("solo", EngineConfig(**ARGS), device="cpu")
    coll.build(_corpus(128, seed=4))
    with pytest.raises(ValueError, match="unsharded"):
        coll.rebuild(shard=1)
    coll.rebuild(shard=0)                         # the single shard is fine


# ---------------------------------------------------------------------------
# Per-shard pressure -> shard-local auto-maintenance
# ---------------------------------------------------------------------------

def test_service_auto_schedules_shard_local_rebuild(mesh):
    th = templates.TemplateThresholds(maintenance_tombstone_frac=0.001,
                                      maintenance_min_pending=16,
                                      maintenance_shard_min_pending=16)
    svc = MemoryService(maintenance_poll_interval_s=0.02, device="cpu")
    try:
        svc.create_collection("c", CFG, mesh=mesh, thresholds=th)
        svc.build("c", _corpus(N0, seed=5))
        coll = svc.collection("c")
        # cross the per-shard tombstone threshold (max(16, .1% of 2048)=16)
        # on at least one shard and do NOT call rebuild(): the controller
        # must schedule shard-local rebuilds on its own
        assert svc.delete("c", np.arange(64)) == 64
        due = coll.maintenance_due_shards()
        assert due, coll.maintenance_pressure()
        deadline = time.time() + 60
        while time.time() < deadline:
            st = coll.stats()
            if st["deleted"] == 0 and not coll.maintenance_due_shards():
                break
            time.sleep(0.05)
        st = coll.stats()
        assert st["deleted"] == 0, st             # tombstones reclaimed
        assert st["rebuilds"] >= 2                # build + auto rebuild(s)
        assert svc.stats()["maintenance"]["triggered"] >= 1
        assert st["live"] == N0 - 64
        assert st["pressure"]["tombstones"] == 0
    finally:
        svc.shutdown()


def test_shard_pressure_is_per_shard(mesh):
    coll = _built(mesh, seed=6)
    _, hits = dce.dist_delete(coll.snapshot(),
                              torch.arange(48, dtype=torch.int32), mesh)
    per_shard_truth = [int(v) for v in hits]
    coll.delete(np.arange(48))
    shards = coll.maintenance_pressure()["shards"]
    assert [s["tombstones"] for s in shards] == per_shard_truth
    assert sum(per_shard_truth) == 48


# ---------------------------------------------------------------------------
# Sharded persistence
# ---------------------------------------------------------------------------

def test_sharded_save_load_roundtrip(mesh):
    coll = _built(mesh, seed=7)
    coll.insert(_corpus(INS_BATCH, seed=70),
                ids=np.arange(40_000, 40_000 + INS_BATCH))
    coll.delete(np.arange(32))
    q = _corpus(4, seed=71)
    want_ids, want_scores = coll.query(q, k=4)
    want_live = _live_ids(coll.snapshot())
    with tempfile.TemporaryDirectory() as d:
        coll.save_into(d)
        back = Collection.load_from(d, "c", CFG, mesh=mesh)
        assert _live_ids(back.snapshot()) == want_live
        assert all(s.centroids is back.snapshot()[0].centroids
                   for s in back.snapshot())
        got_ids, got_scores = back.query(q, k=4)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5)
        # pressure re-seeded from the restored per-shard state
        press = back.maintenance_pressure()
        assert press["tombstones"] == coll.maintenance_pressure()["tombstones"]
        # inserts keep going after a restore (id allocator survived)
        back.insert(_corpus(INS_BATCH, seed=72))
        assert back._next_id > 40_000


def test_sharded_load_mesh_mismatch_and_reshard(mesh):
    coll = _built(mesh, seed=8)
    coll.delete(np.arange(16))
    want_live = _live_ids(coll.snapshot())
    mesh_b = dce.make_mesh((1, N_SHARDS), ("replica", "shard"), "cpu")
    with tempfile.TemporaryDirectory() as d:
        coll.save_into(d)
        # same device count, different mesh shape: fail fast by default...
        with pytest.raises(ValueError, match="reshard=True"):
            Collection.load_from(d, "c", CFG, mesh=mesh_b)
        # ...and reshard on request, preserving every live row
        back = Collection.load_from(d, "c", CFG, mesh=mesh_b, reshard=True)
        assert _live_ids(back.snapshot()) == want_live
        ids, _ = back.query(_corpus(4, seed=80), k=4)
        assert ids.shape == (4, 4)
        # resharded tombstones were dropped with their slots: pressure clean
        assert back.stats()["deleted"] == 0
    # loading a sharded snapshot with an unsharded config is an error that
    # names the fix, not a NotImplementedError
    with tempfile.TemporaryDirectory() as d:
        coll.save_into(d)
        with pytest.raises(ValueError, match="shard_db"):
            Collection.load_from(d, "c", EngineConfig(**ARGS), device="cpu")


def test_service_save_load_sharded_collection(mesh):
    svc = MemoryService(maintenance=False, device="cpu")
    try:
        svc.create_collection("planet", CFG, mesh=mesh)
        svc.build("planet", _corpus(N0, seed=9))
        svc.delete("planet", np.arange(8))
        want = _live_ids(svc.collection("planet").snapshot())
        with tempfile.TemporaryDirectory() as d:
            svc.save(d)
            with pytest.raises(ValueError, match="mesh="):
                MemoryService.load(d, maintenance=False, device="cpu")
            back = MemoryService.load(d, maintenance=False, mesh=mesh,
                                      device="cpu")
            try:
                assert _live_ids(back.collection("planet").snapshot()) == want
                ids, _ = back.query("planet", _corpus(2, seed=90), k=3)
                assert ids.shape == (2, 3)
            finally:
                back.shutdown()
    finally:
        svc.shutdown()


# ---------------------------------------------------------------------------
# Sharded namespaces across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_namespace_cross_loads(tmp_path, mesh, writer):
    """A sharded collection saved by either package loads in the other
    with the same live set, shard by shard, and answers its own rows."""
    jcfg = JConfig(shard_db=True, **ARGS)
    jmesh = jax.make_mesh((N_SHARDS,), ("shard",))
    x = _corpus(N0, seed=11)
    if writer == "jax":
        src = JCollection("c", jcfg, mesh=jmesh)
    else:
        src = Collection("c", CFG, mesh=mesh)
    src.build(x)
    src.insert(_corpus(INS_BATCH, seed=12),
               ids=np.arange(50_000, 50_000 + INS_BATCH))
    src.delete(np.arange(40))
    src.save_into(str(tmp_path))
    if writer == "jax":
        dst = Collection.load_from(str(tmp_path), "c", CFG, mesh=mesh)
        want = [_live_ids(s) for s in jdce.split_host(src.snapshot(),
                                                      N_SHARDS)]
        got = [_live_ids(s) for s in dst.snapshot()]
    else:
        dst = JCollection.load_from(str(tmp_path), "c", jcfg, mesh=jmesh)
        want = [_live_ids(s) for s in src.snapshot()]
        got = [_live_ids(s) for s in jdce.split_host(dst.snapshot(),
                                                     N_SHARDS)]
    assert got == want and set().union(*got) == \
        (set(range(40, N0)) | set(range(50_000, 50_000 + INS_BATCH)))
    assert dst.maintenance_pressure()["shards"] == \
        src.maintenance_pressure()["shards"]
    ids, _ = dst.query(x[100:104], k=4)
    np.testing.assert_array_equal(np.asarray(ids)[:, 0], np.arange(100, 104))
