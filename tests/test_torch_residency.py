"""Residency tiers of the port on the CPU: HOT (device tensors), WARM (a host
copy), COLD (a checkpoint namespace) under a device byte budget.

The first eight tests are the reference's unsharded residency tests
(`tests/test_residency.py`) run against `repro_torch`: bitwise demote ->
promote round trips, queries racing demotions, LRU eviction under a budget
with the device/host/disk byte breakdown summing to the footprint, a query
promoting a COLD tenant inside its own scheduler task, fused windows that
never stack a non-HOT lane, idle demotion by the maintenance poll, and
tiers surviving save/load.  The rest hold the port to the JAX package: the
same byte sizes, the same tiers and counters after every op of one script,
and WARM/COLD namespaces that each package writes and the other reads.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Collection as JCollection
from repro.api import MemoryService as JMemoryService
from repro.configs.base import EngineConfig as JConfig
from repro.core import index as jivf
from repro_torch.api import Collection, MemoryOp, MemoryService
from repro_torch.configs.base import EngineConfig
from repro_torch.convert import ivf_state_from_numpy
from repro_torch.core import index as ivf
from repro_torch.core import locking

jax.config.update("jax_platform_name", "cpu")

ARGS = dict(dim=128, n_clusters=128, list_capacity=16, nprobe=8, k=4,
            use_kernel=False, kmeans_iters=2)
CFG = EngineConfig(**ARGS)
N0 = 256
SPILL = 64
# what the residency stats time; every other key must match the reference
TIMING_KEYS = ("promote_s_mean", "promote_s_max", "demote_s_total")


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
    x = np.random.default_rng(seed).standard_normal((n, dim),
                                                    dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _nb(cfg=CFG):
    return ivf.state_nbytes(cfg, spill_capacity=SPILL)


def _live(state):
    ids = torch.cat([state.list_ids.reshape(-1), state.spill_ids]).numpy()
    return set(ids[ids >= 0].tolist())


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The reference's unsharded residency tests, on the port
# ---------------------------------------------------------------------------

def test_state_nbytes_matches_footprint():
    for cfg in (CFG, dataclasses.replace(CFG, store_dtype="int8",
                                         rescore_k=32)):
        state = ivf.empty_state(cfg, spill_capacity=SPILL, device="cpu")
        fp = ivf.footprint(state)
        assert fp["index_bytes"] == ivf.state_nbytes(cfg,
                                                     spill_capacity=SPILL)
        coll = Collection("c", cfg, spill_capacity=SPILL, device="cpu")
        assert coll.index_nbytes() == fp["index_bytes"]
        if cfg.store_dtype == "int8":
            # int8 keeps BOTH the 1 B/component codes (scan stream) and
            # the retained 4 B/component f32 rows (exact rescore)
            assert fp["bytes_per_row"] == 5 * cfg.dim
            assert fp["scan_bytes_per_row"] == cfg.dim
        else:
            assert fp["bytes_per_row"] == 4 * cfg.dim
            assert fp["scan_bytes_per_row"] == 4 * cfg.dim


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_demote_promote_roundtrip_bitwise(tmp_path, store_dtype):
    cfg = dataclasses.replace(CFG, store_dtype=store_dtype, rescore_k=32)
    coll = Collection("c", cfg, spill_capacity=SPILL, device="cpu")
    coll.build(_corpus(N0))
    q = _corpus(4, seed=7)
    want = coll.query(q, k=4)
    before = coll.snapshot()
    want_live = _live(before)

    # HOT -> WARM: device state released, snapshot reads None; the host
    # copy is a separate copy of every leaf
    out = coll.demote("warm")
    assert out["demoted"] and coll.residency == "warm"
    assert coll.snapshot() is None
    assert coll.stats()["residency"] == "warm"
    assert coll.stats()["live"] == N0
    for a, b in zip(coll._host_state, before):
        if b is not None:
            assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    # re-demoting is a no-op, not an error
    assert coll.demote("warm")["demoted"] is False

    # query auto-promotes and is bitwise identical; every leaf keeps its
    # dtype, shape and contiguity
    got = coll.query(q, k=4)
    assert coll.residency == "hot"
    _same(got, want)
    after = coll.snapshot()
    assert _live(after) == want_live
    for a, b in zip(after, before):
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == b.dtype and a.is_contiguous()
            assert torch.equal(a, b)

    # WARM -> COLD: only the checkpoint remains; cold demote needs a dir
    coll.demote("warm")
    with pytest.raises(ValueError, match="cold"):
        coll.demote("cold")
    coll.demote("cold", directory=str(tmp_path / "c"))
    assert coll.residency == "cold"
    assert coll._host_state is None
    got = coll.query(q, k=4)                   # disk -> device in one hop
    assert coll.residency == "hot"
    _same(got, want)
    for a, b in zip(coll.snapshot(), before):
        if b is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)

    # writers promote too: insert/delete on a demoted collection
    coll.demote("warm")
    coll.insert(_corpus(8, seed=20), ids=np.arange(90_000, 90_008))
    assert coll.residency == "hot"
    assert _live(coll.snapshot()) == want_live | set(range(90_000, 90_008))
    coll.demote("warm")
    assert coll.delete(np.arange(90_000, 90_008)) == 8
    assert coll.residency == "hot"
    assert _live(coll.snapshot()) == want_live
    # and so does a rebuild
    coll.demote("cold")
    assert not coll.rebuild()["aborted"]
    assert coll.residency == "hot" and _live(coll.snapshot()) == want_live


def test_concurrent_queries_during_demotion():
    """Queries racing repeated demotions never error and never see a torn
    state — every answer equals the always-HOT reference."""
    coll = Collection("c", CFG, spill_capacity=SPILL, device="cpu")
    coll.build(_corpus(N0, seed=3))
    q = _corpus(4, seed=8)
    want = coll.query(q, k=4)
    errors, stop = [], threading.Event()

    def demoter():
        try:
            while not stop.is_set():
                coll.demote("warm")
                time.sleep(0.005)
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    def querier():
        try:
            for _ in range(25):
                _same(coll.query(q, k=4), want)
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=demoter)] + \
              [threading.Thread(target=querier) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads[1:]:
        t.join(timeout=60)
    stop.set()
    threads[0].join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert coll.query(q, k=4)[0].shape == (4, 4)


def test_lru_eviction_at_budget(tmp_path):
    """3 collections under a ~2.2-collection budget: every build/query
    succeeds, the least-recently-used tenant gets evicted, and the byte
    breakdown always sums to the footprint."""
    budget = int(_nb() * 2.2)
    svc = MemoryService(device="cpu", maintenance=False,
                        device_budget_bytes=budget,
                        residency_dir=str(tmp_path))
    try:
        X = _corpus(N0)
        q = _corpus(4, seed=7)
        for n in ("a", "b", "c"):
            svc.create_collection(n, CFG, spill_capacity=SPILL)
            svc.build(n, X)
        st = svc.stats()["residency"]
        assert st["evictions"] >= 1                 # budget < 3 tenants
        assert sorted(st["tiers"].values()).count("hot") <= 2
        ref = svc.query("a", q, k=4)                # may be a cold hit
        # LRU: touch b and c, then admitting a must evict neither of them
        svc.query("b", q, k=4)
        svc.query("c", q, k=4)
        svc.demote("a")                             # off-device
        got = svc.query("a", q, k=4)                # promotes, evicts LRU=b
        _same(got, ref)
        st = svc.stats()["residency"]
        assert st["tiers"] == {"a": "hot", "b": "warm", "c": "hot"}
        assert st["cold_hits"] >= 1
        assert st["promote_s_mean"] is not None     # cold-hit latency seam
        # capacity invariant: device+host+disk == sum of footprints (+ the
        # StackCache's derived device copies, counted in device)
        audited = 3 * _nb() + st["stack_cache_bytes"]
        assert (st["device_bytes"] + st["host_bytes"]
                + st["disk_bytes"]) == audited
        assert st["device_bytes"] - st["stack_cache_bytes"] <= budget
        assert st["over_budget_events"] == 0
    finally:
        svc.shutdown()


def test_async_promote_query_on_cold_collection(tmp_path):
    """submit() against a COLD tenant returns immediately; the scheduler
    task chains promote->query and the answer is bitwise-equal to the
    always-HOT answer."""
    svc = MemoryService(device="cpu", maintenance=False,
                        residency_dir=str(tmp_path))
    try:
        svc.create_collection("c", CFG, spill_capacity=SPILL)
        svc.build("c", _corpus(N0))
        q = _corpus(4, seed=7)
        want = svc.query("c", q, k=4)
        assert svc.demote("c", tier="cold") == "cold"
        assert svc.collection("c").residency == "cold"
        fut = svc.submit(MemoryOp("query", "c", q, k=4))
        _same(fut.result(timeout=60), want)
        assert svc.collection("c").residency == "hot"
        st = svc.stats()["residency"]
        assert st["cold_hits"] >= 1 and st["promotions"] >= 1
        # explicit sync wrappers round-trip the tier
        assert svc.demote("c") == "warm"
        assert svc.promote("c") == "hot"
    finally:
        svc.shutdown()


def test_fused_window_never_stacks_non_hot_lane():
    """Park same-signature queries on 3 tenants, demote one: flush must
    dispatch the 2 HOT lanes as ONE fused group plus the demoted lane as a
    self-promoting singleton — 2 dispatches, all answers exact."""
    svc = MemoryService(device="cpu", maintenance=False, batch_window=64)
    try:
        X, q = _corpus(N0), _corpus(3, seed=7)
        for n in ("a", "b", "c"):
            svc.create_collection(n, CFG, spill_capacity=SPILL)
            svc.build(n, X)
        sync = {n: svc.query(n, q, k=4) for n in ("a", "b", "c")}
        svc.demote("b")
        assert svc.collection("b").residency == "warm"
        futs = {n: svc.submit(MemoryOp("query", n, q, k=4, batch=True))
                for n in ("a", "b", "c")}
        assert svc.flush() == 2      # {a,c} fused; b dispatches alone
        for n, fut in futs.items():
            _same(fut.result(timeout=60), sync[n])
        assert svc.collection("b").residency == "hot"   # singleton promoted
        # the fused group's stack never held b
        assert all(c.name != "b" for key in svc._stack_cache._entries
                   for c, _ in key[1])
    finally:
        svc.shutdown()


def test_background_idle_demotion(tmp_path):
    """The MaintenanceController's residency sweep demotes idle tenants on
    its own: HOT past idle_demote_s -> WARM, WARM past cold_after_s ->
    COLD, without any caller intervention."""
    svc = MemoryService(device="cpu", maintenance_poll_interval_s=0.02,
                        residency_dir=str(tmp_path),
                        idle_demote_s=0.2, cold_after_s=0.5)
    try:
        svc.create_collection("c", CFG, spill_capacity=SPILL)
        svc.build("c", _corpus(N0))
        q = _corpus(2, seed=7)
        want = svc.query("c", q, k=4)
        deadline = time.time() + 60
        while (svc.collection("c").residency != "cold"
               and time.time() < deadline):
            time.sleep(0.05)
        assert svc.collection("c").residency == "cold"
        assert svc.stats()["maintenance"]["demotions_triggered"] >= 2
        _same(svc.query("c", q, k=4), want)   # wakes it straight from disk
    finally:
        svc.shutdown()


def test_residency_survives_save_load(tmp_path):
    svc = MemoryService(device="cpu", maintenance=False,
                        residency_dir=str(tmp_path / "r"))
    q = _corpus(4, seed=7)
    try:
        want = {}
        for n in ("hot0", "warm0", "cold0"):
            svc.create_collection(n, CFG, spill_capacity=SPILL)
            svc.build(n, _corpus(N0))
            want[n] = svc.query(n, q, k=4)
        svc.demote("warm0", tier="warm")
        svc.demote("cold0", tier="cold")
        svc.save(str(tmp_path / "snap"))
        # demoting to cold then saving must keep the service queryable
        assert svc.collection("cold0").residency == "cold"
    finally:
        svc.shutdown()
    back = MemoryService.load(str(tmp_path / "snap"), device="cpu",
                              maintenance=False)
    try:
        tiers = {n: back.collection(n).residency
                 for n in ("hot0", "warm0", "cold0")}
        assert tiers == {"hot0": "hot", "warm0": "warm", "cold0": "cold"}
        # COLD restored as a pointer: no state tensors held anywhere
        assert back.collection("cold0").snapshot() is None
        assert back.collection("cold0")._host_state is None
        st = back.stats()["residency"]
        assert (st["device_bytes"], st["host_bytes"], st["disk_bytes"]) == \
            (_nb(), _nb(), _nb())
        for n in ("hot0", "warm0", "cold0"):
            _same(back.query(n, q, k=4), want[n])
    finally:
        back.shutdown()


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
@pytest.mark.parametrize("spill", [SPILL, 4096])
def test_index_nbytes_equals_reference(store_dtype, spill):
    kw = dict(ARGS, store_dtype=store_dtype, rescore_k=32)
    got = Collection("c", EngineConfig(**kw), spill_capacity=spill,
                     device="cpu").index_nbytes()
    assert got == jivf.state_nbytes(JConfig(**kw), spill_capacity=spill)


def _script(svc, X, q):
    """One op sequence on either package's service; yields after each op."""
    for n in "abcd":
        svc.create_collection(n, CFG if isinstance(svc, MemoryService)
                              else JConfig(**ARGS), spill_capacity=SPILL)
        yield f"create {n}"
        svc.build(n, X)
        yield f"build {n}"
    for op, n in (("query", "a"), ("query", "b"), ("demote", "c"),
                  ("query", "d"), ("promote", "c"), ("cold", "a"),
                  ("query", "a"), ("demote", "b"), ("cold", "b"),
                  ("query", "b"), ("promote", "d"), ("query", "c")):
        if op == "query":
            svc.query(n, q, k=4)
        elif op == "cold":
            svc.demote(n, tier="cold")
        else:
            getattr(svc, op)(n)
        yield f"{op} {n}"


def test_scripted_residency_matches_reference(tmp_path):
    """Four tenants under a budget of 2.2 tenants: after every op the port
    and the JAX package report the same tiers, bytes and counters."""
    budget = int(_nb() * 2.2)
    X, q = _corpus(N0), _corpus(4, seed=7)
    tsvc = MemoryService(device="cpu", maintenance=False,
                         device_budget_bytes=budget,
                         residency_dir=str(tmp_path / "t"))
    jsvc = JMemoryService(maintenance=False, device_budget_bytes=budget,
                          residency_dir=str(tmp_path / "j"))
    try:
        steps = 0
        for what, _ in zip(_script(tsvc, X, q), _script(jsvc, X, q)):
            got, want = (dict(s.stats()["residency"]) for s in (tsvc, jsvc))
            for key in TIMING_KEYS:
                got.pop(key), want.pop(key)
            assert got == want, what
            steps += 1
        assert steps == 20
        assert got["evictions"] > 0 and got["promotions"] > 0
    finally:
        tsvc.shutdown()
        jsvc.shutdown()


def _carried(store_dtype):
    """One state built by the JAX package, in a JAX collection and carried
    into a port collection with `convert`; both answer the same queries."""
    kw = dict(ARGS, store_dtype=store_dtype, rescore_k=32)
    jcoll = JCollection("c", JConfig(**kw), spill_capacity=SPILL)
    jcoll.build(jnp.asarray(_corpus(300, seed=1)))
    tcoll = Collection("c", EngineConfig(**kw), spill_capacity=SPILL,
                       device="cpu")
    tcoll._swap(ivf_state_from_numpy(jax.device_get(jcoll.snapshot()),
                                     device="cpu"))
    tcoll._built = True
    return jcoll, tcoll, EngineConfig(**kw), JConfig(**kw)


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
@pytest.mark.parametrize("tier", ["warm", "cold"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_non_hot_namespace_cross_loads(tmp_path, store_dtype, tier, writer):
    """A WARM or COLD collection saved by one package loads in the other in
    that tier and, once its first query promotes it, answers with the
    writer's ids (scores to 1e-3)."""
    jcoll, tcoll, tcfg, jcfg = _carried(store_dtype)
    q = _corpus(6, seed=3) * 0.05 + _corpus(300, seed=1)[:6]
    paths = ("full_scan", "probed")
    src = jcoll if writer == "jax" else tcoll
    want = [src.query(jnp.asarray(q) if writer == "jax" else q, path=p)
            for p in paths]
    kw = {"directory": str(tmp_path / "cold")} if tier == "cold" else {}
    assert src.demote(tier, **kw)["demoted"]
    src.save_into(str(tmp_path / "snap"))
    if writer == "jax":
        back = Collection.load_from(str(tmp_path / "snap"), "c", tcfg,
                                    device="cpu")
        got = [back.query(q, path=p) for p in paths]
    else:
        back = JCollection.load_from(str(tmp_path / "snap"), "c", jcfg)
        got = [back.query(jnp.asarray(q), path=p) for p in paths]
    assert back.residency == "hot"
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_allclose(np.asarray(gs), np.asarray(ws),
                                   rtol=1e-3, atol=1e-3)


def test_non_hot_namespace_loads_in_its_tier_in_the_other_package(tmp_path):
    """Before its first query, a WARM snapshot of either package loads as
    WARM in the other (host arrays, no device state) and a COLD one as a
    pointer (nothing read)."""
    jcoll, tcoll, tcfg, jcfg = _carried("int8")
    jcoll.demote("warm")
    jcoll.save_into(str(tmp_path / "jw"))
    tcoll.demote("cold", directory=str(tmp_path / "tc"))
    tcoll.save_into(str(tmp_path / "tsnap"))
    back = Collection.load_from(str(tmp_path / "jw"), "c", tcfg,
                                device="cpu")
    assert back.residency == "warm" and back.snapshot() is None
    assert back._host_state.q_lists.dtype == torch.int8
    jback = JCollection.load_from(str(tmp_path / "tsnap"), "c", jcfg)
    assert jback.residency == "cold" and jback._host_state is None


def test_stack_cache_is_charged_and_dropped_first_under_budget():
    """A fused window's stacked copy counts against the budget, and an
    admission drops it before it demotes any live tenant; a cache miss
    keeps one stack per group (the port's `_drop_group`)."""
    budget = int(_nb() * 4.5)
    svc = MemoryService(device="cpu", maintenance=False, batch_window=64,
                        device_budget_bytes=budget)
    try:
        q = _corpus(2, seed=7)
        for i, n in enumerate("abc"):
            svc.create_collection(n, CFG, spill_capacity=SPILL, seed=i)
            svc.build(n, _corpus(N0, seed=i))
        want = {n: svc.query(n, q, k=4) for n in "abc"}
        for _ in range(2):      # a write between windows: one stack kept
            for (n, _), got in zip(want.items(), svc.query_many(
                    [(n, q) for n in "abc"], k=4)):
                _same(got, want[n])
            svc.insert("a", _corpus(1, seed=99), ids=[50_000])
            want["a"] = svc.query("a", q, k=4)
        st = svc.stats()["residency"]
        assert svc.stats()["stack_cache"]["entries"] == 1
        assert st["stack_cache_bytes"] == 3 * _nb()
        assert st["device_bytes"] == 6 * _nb() > budget
        svc.demote("b")
        _same(svc.query("b", q, k=4), want["b"])      # promotes b
        st = svc.stats()["residency"]
        assert st["cache_evictions"] == 1 and st["evictions"] == 0
        assert st["stack_cache_bytes"] == 0
        assert st["device_bytes"] == 3 * _nb() <= budget
        assert set(st["tiers"].values()) == {"hot"}
    finally:
        svc.shutdown()


# ---------------------------------------------------------------------------
# Sharded tiers + spill rebalance (tests/test_residency.py's sharded cases
# on the port, a 2-shard mesh of CPU shards)
# ---------------------------------------------------------------------------

SCFG = dataclasses.replace(CFG, shard_db=True)


def _slive(state):
    return set().union(*(_live(s) for s in state))


def test_sharded_demote_promote_roundtrip(tmp_path):
    """WARM holds the per-shard host states, COLD the `shard_<i>`
    namespaces; every promotion answers bit-equal with one centroids
    tensor per device again, and a WARM sharded tenant saves/loads in its
    tier.  The byte charge is `state_nbytes(..., n_shards)`."""
    from repro_torch.core import distributed as dce
    mesh = dce.make_mesh((2,), ("shard",), "cpu")
    coll = Collection("c", SCFG, mesh=mesh, spill_capacity=SPILL)
    assert coll.index_nbytes() == ivf.state_nbytes(SCFG, SPILL, 2)
    coll.build(_corpus(512))
    q = _corpus(4, seed=7)
    want = coll.query(q, k=4)
    want_live = _slive(coll.snapshot())
    for tier, kw in (("warm", {}),
                     ("cold", {"directory": str(tmp_path / "c")})):
        coll.demote("warm")
        assert len(coll._host_state) == 2
        if tier == "cold":
            coll.demote("cold", **kw)
            assert sorted(p.name for p in (tmp_path / "c").iterdir()) == \
                ["shard_000", "shard_001"]
        assert coll.residency == tier
        assert coll.stats()["shards"] == 2
        got = coll.query(q, k=4)
        assert coll.residency == "hot"
        _same(got, want)
        st = coll.snapshot()
        assert _slive(st) == want_live
        assert st[1].centroids is st[0].centroids
    # warm sharded state save/loads with its tier
    coll.demote("warm")
    coll.save_into(str(tmp_path / "snap"))
    back = Collection.load_from(str(tmp_path / "snap"), "c", SCFG, mesh=mesh)
    assert back.residency == "warm"
    _same(back.query(q, k=4), want)


def test_sharded_spill_rebalance():
    """A hot-spotted shard's rebuild hands its residual spill rows to the
    underfull sibling (zero lost ids); the sibling's own rebuild then
    absorbs them into list slots."""
    from repro_torch.core import distributed as dce
    from repro_torch.core import templates
    mesh = dce.make_mesh((2,), ("shard",), "cpu")
    th = templates.TemplateThresholds(maintenance_spill_frac=0.01,
                                      maintenance_shard_min_pending=16)
    coll = Collection("c", SCFG, mesh=mesh, spill_capacity=1024,
                      thresholds=th)
    coll.build(_corpus(512))
    v = _corpus(1, seed=99)[0]
    nid = 10_000
    # contiguous-block insert split: the FIRST half of each batch lands on
    # shard 0 — cluster it tightly around v so one centroid's 16-slot list
    # overflows there, while shard 1's half stays diverse
    for i in range(10):
        hot = v[None, :] + 1e-3 * np.random.default_rng(i).standard_normal(
            (8, 128)).astype(np.float32)
        hot /= np.linalg.norm(hot, axis=1, keepdims=True)
        batch = np.concatenate([hot, _corpus(8, seed=500 + i)])
        coll.insert(batch.astype(np.float32),
                    ids=np.arange(nid, nid + 16))
        nid += 16
    want = _slive(coll.snapshot())
    press = coll.maintenance_pressure()["shards"]
    assert press[0]["spilled"] > 0 and press[1]["spilled"] == 0
    assert 0 in coll.maintenance_due_shards()   # controller would fire this
    sibling = coll.snapshot()[1]
    out = coll.rebuild(shard=0)
    assert not out["aborted"]
    assert out["rebalanced"] > 0 and out["rebalance_to"] == 1
    assert _slive(coll.snapshot()) == want      # zero lost rows
    # the sibling's lists were not copied: only its spill fields are new
    assert coll.snapshot()[1].lists is sibling.lists
    assert int(coll.snapshot()[1].spill_size) == out["rebalanced"]
    post = coll.maintenance_pressure()["shards"]
    assert post[0]["spilled"] == 0
    assert post[1]["spilled"] == out["rebalanced"]
    # destination shard's rebuild drains the adopted rows into lists
    out2 = coll.rebuild(shard=1)
    assert not out2["aborted"]
    assert _slive(coll.snapshot()) == want
    ids, _ = coll.query(v[None, :], k=4)
    assert set(ids[0].tolist()) <= want
