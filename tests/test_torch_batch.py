"""Port parity for cross-collection batch fusion: `repro_torch` against the
JAX package on the CPU, from numpy inputs made from a seed (D=128, C=128,
L=16-64, a few hundred rows per tenant).

* the lane plain versions of both scans against the Pallas kernels under
  `jax.vmap` (interpret mode);
* the port's `fused_query` against the reference's on JAX-built states
  carried over by `convert.py`;
* the service invariants of the reference's fusion tests
  (tests/test_api.py, tests/test_quantized.py, tests/test_batch_fusion.py)
  on the port: batched == sync == futures, lane merge and signature
  splits, auto-flush, the stack cache, demux under a concurrent rebuild,
  and error propagation.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import batch as jbatch
from repro.configs.base import EngineConfig as JConfig
from repro.core import index as jivf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.api import MemoryOp, MemoryService
from repro_torch.api import batch as fuse
from repro_torch.configs.base import EngineConfig
from repro_torch.convert import ivf_state_from_numpy
from repro_torch.core import distributed as dce
from repro_torch.core import index as ivf
from repro_torch.core import templates
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scan_scores as t_scan
from repro_torch.kernels import scan_scores_q8 as t_q8

jax.config.update("jax_platform_name", "cpu")

DIM = 128
BLOCKS = dict(block_m=8, block_n=128, block_k=128)
ARGS = dict(dim=DIM, n_clusters=128, list_capacity=16, nprobe=8, k=4,
            kmeans_iters=2, rescore_k=32)
CFG = EngineConfig(**ARGS)
QCFG = dataclasses.replace(CFG, store_dtype="int8")
N0 = 256
TENANTS = ("t0", "t1", "t2")


def _corpus(n, seed=0, dim=DIM):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# lane plain versions vs the Pallas kernels under vmap
# ---------------------------------------------------------------------------

LANE_SHAPES = [(1, 1, 100, 64), (3, 5, 300, 130), (2, 9, 257, 128)]


@pytest.mark.parametrize("g,b,n,d", LANE_SHAPES)
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_lane_scan_plain_matches_pallas_under_vmap(g, b, n, d, metric):
    q, db = _randn(0, (g, b, d)), _randn(1, (g, n, d))
    ids = np.tile(np.arange(n, dtype=np.int32), (g, 1))
    ids[:, ::7] = -1
    ids[g - 1, 1::5] = -1                     # lanes masked differently
    norms = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)

    def pallas(qi, dbi, idi, ni):
        return jops.scan_scores(qi, dbi, idi, ni if metric == "l2" else None,
                                metric=metric, use_kernel=True,
                                interpret=True, **BLOCKS)

    want = jax.vmap(pallas)(*map(jnp.asarray, (q, db, ids, norms)))
    tn = torch.from_numpy(norms) if metric == "l2" else None
    args = [torch.from_numpy(a) for a in (q, db, ids)]
    got = t_scan.scan_scores(*args, tn, metric=metric)
    assert got.shape == (g, b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_array_equal(
        tops.scan_scores(*args, tn, metric=metric, use_kernel=False).numpy(),
        got.numpy())


@pytest.mark.parametrize("g,b,n,d", LANE_SHAPES)
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_lane_q8_plain_matches_pallas_under_vmap(g, b, n, d, metric):
    """The integer accumulator is exact on both sides and the epilogue is
    the reference's operation order: bit for bit against the reference's
    oracle under vmap.  The Pallas kernel in interpret mode runs jitted,
    where XLA may contract the epilogue's multiply-add into an FMA, so it
    is held to the 2-D parity test's 1e-5 (tests/test_torch_quantized.py)."""
    rng = np.random.default_rng(3)
    q = _randn(4, (g, b, d))
    codes = rng.integers(-127, 128, (g, n, d), dtype=np.int8)
    scales = (rng.random((g, n)) * 1e-2 + 1e-3).astype(np.float32)
    zeros = (rng.standard_normal((g, n)) * 1e-2).astype(np.float32)
    norms = (rng.random((g, n)) * 2).astype(np.float32)
    ids = np.tile(np.arange(n, dtype=np.int32), (g, 1))
    ids[:, ::7] = -1

    def pallas(qi, ci, idi, si, zi, ni):
        return jops.scan_scores_q8(qi, ci, idi, si, zi,
                                   ni if metric == "l2" else None,
                                   metric=metric, use_kernel=True,
                                   interpret=True, **BLOCKS)

    def oracle(qi, ci, idi, si, zi, ni):
        return jref.scan_scores_q8_ref(qi, ci, idi, si, zi,
                                       ni if metric == "l2" else None,
                                       metric=metric)

    jargs = list(map(jnp.asarray, (q, codes, ids, scales, zeros, norms)))
    want = jax.vmap(pallas)(*jargs)
    targs = [torch.from_numpy(a.copy()) for a in (q, codes, ids, scales,
                                                  zeros)]
    tn = torch.from_numpy(norms.copy()) if metric == "l2" else None
    got = tops.scan_scores_q8(*targs, tn, metric=metric)
    assert got.shape == (g, b, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.vmap(oracle)(*jargs)))
    qc, sq = tref.quantize_queries(targs[0])
    plain = t_q8.scan_scores_q8(qc, *targs[1:], sq, tref.query_corr(qc, sq),
                                tn, metric=metric)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_lane_plain_versions_are_loops_of_the_2d_ones():
    """Lane g of a lane call is the 2-D plain version on lane g, bit for
    bit, and a CPU call moves no launch counter."""
    g, b, n, d = 3, 4, 200, 128
    q, db = torch.from_numpy(_randn(5, (g, b, d))), torch.from_numpy(
        _randn(6, (g, n, d)))
    ids = torch.arange(n, dtype=torch.int32).repeat(g, 1)
    ids[1, ::3] = -1
    counters = [c.value for m in (t_scan, t_q8)
                for c in (m.launches, *m.launches_by_lanes.values())]
    lane = t_scan.scan_scores(q, db, ids, metric="l2")
    qc, sq = tref.quantize_queries(q)
    codes = torch.randint(-127, 128, (g, n, d), dtype=torch.int8,
                          generator=torch.Generator().manual_seed(0))
    scales, zeros = torch.rand(g, n) * 1e-2, torch.randn(g, n) * 1e-2
    corr = tref.query_corr(qc, sq)
    lane8 = t_q8.scan_scores_q8(qc, codes, ids, scales, zeros, sq, corr)
    for i in range(g):
        torch.testing.assert_close(
            lane[i], t_scan.scan_scores(q[i], db[i], ids[i], metric="l2"),
            rtol=0, atol=0)
        qci, sqi = tref.quantize_queries(q[i])
        assert torch.equal(qci, qc[i]) and torch.equal(sqi, sq[i])
        assert torch.equal(tref.query_corr(qci, sqi), corr[i])
        torch.testing.assert_close(
            lane8[i], t_q8.scan_scores_q8(qci, codes[i], ids[i], scales[i],
                                          zeros[i], sqi, corr[i]),
            rtol=0, atol=0)
    assert counters == [c.value for m in (t_scan, t_q8)
                        for c in (m.launches, *m.launches_by_lanes.values())]


def test_lane_launch_keys():
    from repro_torch.kernels import scan_stream
    assert scan_stream.lane_key(1) == "G=1"
    assert scan_stream.lane_key(2) == scan_stream.lane_key(9) == "G>1"
    assert set(t_scan.launches_by_lanes) == set(t_q8.launches_by_lanes) == \
        set(scan_stream.LANE_KEYS)
    with pytest.raises(ValueError, match="lanes"):
        scan_stream.check_lanes("scan_scores", 0)
    with pytest.raises(ValueError, match="lanes"):
        scan_stream.check_lanes("scan_scores", scan_stream.MAX_LANES + 1)


# ---------------------------------------------------------------------------
# fused_query: the port against the reference on carried states
# ---------------------------------------------------------------------------

def _carried_stack(store_dtype, metric):
    jcfg = JConfig(use_kernel=False, interpret=True, metric=metric,
                   store_dtype=store_dtype, **ARGS)
    tcfg = dataclasses.replace(CFG, metric=metric, store_dtype=store_dtype)
    jstates, tstates, xs = [], [], []
    for i in range(3):
        x = _corpus(300, seed=40 + i)
        st, _ = jivf.build(jax.random.PRNGKey(i), jnp.asarray(x),
                           jnp.arange(300, dtype=jnp.int32) + 1000 * i, jcfg,
                           spill_capacity=128)
        st = jax.device_get(st)
        jstates.append(st)
        tstates.append(ivf_state_from_numpy(st, device="cpu"))
        xs.append(x)
    return jcfg, tcfg, jstates, tstates, xs


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
@pytest.mark.parametrize("path", ["full_scan", "probed"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_fused_query_matches_reference(store_dtype, path, metric):
    jcfg, tcfg, jstates, tstates, xs = _carried_stack(store_dtype, metric)
    q = np.stack([x[:5] + 0.05 * _corpus(5, seed=50 + i)
                  for i, x in enumerate(xs)])
    nprobe = 8 if path == "probed" else 0
    jids, jsc = jbatch.fused_query(jbatch.stack_states(jstates),
                                   jnp.asarray(q), jcfg, 4, nprobe, path)
    stacked = fuse.stack_states(tstates)
    tids, tsc = fuse.fused_query(stacked, torch.from_numpy(q), tcfg, 4,
                                 nprobe, path)
    assert tids.shape == (3, 5, 4) and tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    tol = dict(rtol=1e-5, atol=1e-6) if store_dtype == "int8" else \
        dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), **tol)
    for i in range(3):           # each lane finds its own rows first
        np.testing.assert_array_equal(tids.numpy()[i, :, 0],
                                      np.arange(5) + 1000 * i)


def test_stack_states_stacks_leaves_and_skips_none():
    _, _, _, f32, _ = _carried_stack("float32", "ip")
    _, _, _, q8, _ = _carried_stack("int8", "ip")
    s = fuse.stack_states(f32)
    assert s.lists.shape == (3, 128, 16, DIM) and s.q_lists is None
    assert torch.equal(s.spill_ids[1], f32[1].spill_ids)
    s8 = fuse.stack_states(q8)
    assert s8.q_lists.shape == (3, 128, 16, DIM)
    assert s8.q_spill_norms.shape == (3, 128)
    assert fuse._nbytes(s8) == sum(fuse._nbytes(t) for t in q8)


def test_fused_lane_templates_equal_the_single_ones():
    """Lane g of the lane templates is the single-collection template on
    collection g (same ids; scores to the f32 rounding of the padded
    product)."""
    for store_dtype in ("float32", "int8"):
        _, tcfg, _, tstates, xs = _carried_stack(store_dtype, "ip")
        stacked = fuse.stack_states(tstates)
        q = torch.from_numpy(np.stack([x[:3] for x in xs]))
        for path, fn in (("full_scan", ivf.query_full_scan),
                         ("probed", ivf.query_probed)):
            ids, sc = fuse.fused_query(stacked, q, tcfg, 4, 8, path)
            for i, st in enumerate(tstates):
                args = (st, q[i], tcfg, 4) + ((8,) if path == "probed"
                                              else ())
                wi, ws = fn(*args)
                assert torch.equal(ids[i], wi), (store_dtype, path, i)
                torch.testing.assert_close(sc[i], ws, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the service on the port: the reference's fusion invariants
# ---------------------------------------------------------------------------

@pytest.fixture()
def svc():
    svc = MemoryService(device="cpu", maintenance=False)
    for i, name in enumerate(TENANTS):
        svc.create_collection(name, CFG, seed=i)
        svc.build(name, _corpus(N0, seed=i),
                  ids=np.arange(i * 10_000, i * 10_000 + N0))
    yield svc
    svc.shutdown()


def _window(svc, qs, **kw):
    futs = {n: svc.submit(MemoryOp("query", n, q, batch=True, **kw))
            for n, q in qs.items()}
    n = svc.flush()
    return n, {name: f.result(timeout=60) for name, f in futs.items()}


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", [None, "full_scan", "probed"])
def test_batched_equals_sync_equals_futures(svc, path):
    qs = {n: _corpus(b, seed=60 + i) for i, (n, b) in
          enumerate(zip(TENANTS, (1, 3, 6)))}      # unequal: padding
    sync = {n: svc.query(n, q, k=4, path=path) for n, q in qs.items()}
    futs = {n: svc.submit(MemoryOp("query", n, q, k=4, path=path)).result(
        timeout=60) for n, q in qs.items()}
    many = svc.query_many(list(qs.items()), k=4, path=path)
    for (n, _), got in zip(qs.items(), many):
        _assert_same(got, sync[n])
        _assert_same(futs[n], sync[n])
        assert got[0].shape == sync[n][0].shape


def test_tensor_and_1d_payloads_fuse(svc):
    """Queries may come as tensors (on the collections' device) or as one
    1-D row, as `svc.query` takes them."""
    q = _corpus(3, seed=61)
    many = svc.query_many([("t0", torch.from_numpy(q)), ("t1", q[0]),
                           ("t2", torch.from_numpy(q[:2]))], k=4)
    _assert_same(many[0], svc.query("t0", q, k=4))
    _assert_same(many[1], svc.query("t1", q[:1], k=4))
    _assert_same(many[2], svc.query("t2", q[:2], k=4))
    assert many[1][0].shape == (1, 4)


def test_int8_batched_equals_sync_and_mixed_window_flushes_as_two():
    svc = MemoryService(device="cpu", maintenance=False)
    try:
        for name, cfg, seed in (("q0", QCFG, 10), ("q1", QCFG, 11),
                                ("f0", CFG, 12), ("f1", CFG, 13)):
            svc.create_collection(name, cfg)
            svc.build(name, _corpus(N0, seed=seed))
        qs = {n: _corpus(2 + i, seed=20 + i)
              for i, n in enumerate(("q0", "q1", "f0", "f1"))}
        sync = {n: svc.query(n, q, k=4) for n, q in qs.items()}
        n, got = _window(svc, qs, k=4)
        assert n == 2                 # {q0, q1} and {f0, f1}: never mixed
        for name in qs:
            _assert_same(got[name], sync[name])
    finally:
        svc.shutdown()


def test_same_collection_ops_merge_and_k_splits(svc):
    xa = _corpus(8, seed=70)
    futs = [svc.submit(MemoryOp("query", "t0", xa[:3], k=4, batch=True)),
            svc.submit(MemoryOp("query", "t1", xa[3:5], k=4, batch=True)),
            svc.submit(MemoryOp("query", "t0", xa[5:8], k=4, batch=True))]
    assert svc.flush() == 1                  # one group, two lanes
    _assert_same(futs[0].result(timeout=60), svc.query("t0", xa[:3], k=4))
    _assert_same(futs[2].result(timeout=60), svc.query("t0", xa[5:8], k=4))
    assert futs[0].task is futs[1].task is futs[2].task
    futs = [svc.submit(MemoryOp("query", "t0", xa[:3], k=4, batch=True)),
            svc.submit(MemoryOp("query", "t1", xa[:3], k=3, batch=True))]
    assert svc.flush() == 2                  # different k: two groups
    assert futs[1].result(timeout=60)[0].shape == (3, 3)
    _assert_same(futs[1].result(), svc.query("t1", xa[:3], k=3))


def test_degenerate_single_lane_still_fuses(svc):
    xa = _corpus(4, seed=71)
    futs = [svc.submit(MemoryOp("query", "t2", xa[:2], k=4, batch=True)),
            svc.submit(MemoryOp("query", "t2", xa[2:], k=4, batch=True))]
    assert svc.flush() == 1
    _assert_same(futs[1].result(timeout=60), svc.query("t2", xa[2:], k=4))
    assert svc.stats()["stack_cache"]["misses"] == 1     # a G=1 stack


def test_lone_op_takes_the_per_op_path(svc):
    fut = svc.submit(MemoryOp("query", "t0", _corpus(2, seed=72), k=4,
                              batch=True))
    assert svc.flush() == 1
    _assert_same(fut.result(timeout=60),
                 svc.query("t0", _corpus(2, seed=72), k=4))
    assert svc.stats()["stack_cache"] == {"hits": 0, "misses": 0,
                                          "entries": 0, "device_bytes": 0}


def test_auto_flush_at_batch_window():
    svc = MemoryService(device="cpu", maintenance=False, batch_window=3)
    try:
        for i, name in enumerate(TENANTS):
            svc.create_collection(name, CFG, seed=i)
            svc.build(name, _corpus(N0, seed=i))
        futs = [svc.submit(MemoryOp("query", n, _corpus(2, seed=i), k=4,
                                    batch=True))
                for i, n in enumerate(TENANTS[:2])]
        assert all(f._on_wait is not None for f in futs)
        assert len(svc._pending) == 2
        futs.append(svc.submit(MemoryOp("query", "t2", _corpus(2, seed=2),
                                        k=4, batch=True)))
        assert svc._pending == []             # the third op flushed
        for f in futs:
            assert f.result(timeout=60)[0].shape == (2, 4)
        assert svc.flush() == 0
    finally:
        svc.shutdown()


def test_fused_route_is_throughput_class(svc):
    th = templates.TemplateThresholds(full_scan_batch=32)
    assert templates.route("query", 4, CFG, th).backend == "latency"
    plan = templates.route("query", 4, CFG, th, fused_lanes=3)
    assert plan.backend == "throughput" and plan.path == "probed"
    futs = [svc.submit(MemoryOp("query", n, _corpus(1, seed=i), k=4,
                                batch=True)) for i, n in enumerate(TENANTS)]
    svc.flush()
    futs[0].result(timeout=60)
    assert futs[0].task.backend == "throughput"


def test_stack_cache_hits_invalidates_and_evicts(svc):
    qs = {n: _corpus(3, seed=80 + i) for i, n in enumerate(TENANTS)}
    _, first = _window(svc, qs, k=4)
    base = svc.stats()["stack_cache"]
    assert base["misses"] == 1 and base["device_bytes"] > 0
    _, second = _window(svc, qs, k=4)
    after = svc.stats()["stack_cache"]
    assert after["hits"] == base["hits"] + 1
    assert after["misses"] == base["misses"]
    for n in qs:
        np.testing.assert_array_equal(second[n][0], first[n][0])
    probe = _corpus(2, seed=99)
    svc.insert("t1", probe, ids=np.asarray([77_777, 77_778]))
    _, third = _window(svc, {**qs, "t1": probe}, k=4)
    assert svc.stats()["stack_cache"]["misses"] == after["misses"] + 1
    assert 77_777 in third["t1"][0][0]          # the new row is visible
    # the group's stack of the old version can never hit again: replaced
    assert svc.stats()["stack_cache"]["entries"] == 1
    svc.drop_collection("t1")
    assert svc.stats()["stack_cache"]["entries"] == 0


def test_stack_cache_lru_and_pop():
    cache = fuse.StackCache(maxsize=1)

    class Lane:
        def __init__(self, name, state):
            self.name, self._state = name, state

        def versioned_snapshot(self):
            return self._state, 0

    _, _, _, tstates, _ = _carried_stack("float32", "ip")
    a, b = Lane("a", tstates[0]), Lane("b", tstates[1])
    cache.stacked([a, b], None)
    cache.stacked([b, a], None)                  # another key: LRU drops one
    assert cache.stats()["entries"] == 1 and cache.misses == 2
    assert cache.device_bytes() == 2 * fuse._nbytes(tstates[0])
    assert cache.pop_lru() and not cache.pop_lru()
    with pytest.raises(fuse.NotResident):
        cache.stacked([Lane("c", None)], None)
    # a mesh stacks per shard, which needs sharded lanes
    with pytest.raises(ValueError, match="2-shard state"):
        cache.stacked([a], dce.make_mesh((2,), ("shard",), "cpu"))


def test_stack_cache_keeps_one_entry_per_group():
    cache = fuse.StackCache(maxsize=4)

    class Lane:
        def __init__(self, name, state):
            self.name, self._state, self.version = name, state, 0

        def versioned_snapshot(self):
            return self._state, self.version

    _, _, _, tstates, _ = _carried_stack("float32", "ip")
    a, b, c = (Lane(n, s) for n, s in zip("abc", tstates))
    first = cache.stacked([a, b], None)
    other = cache.stacked([a, c], None)
    for _ in range(3):                           # a write, then a window
        b.version += 1
        cache.stacked([a, b], None)
    assert cache.misses == 5 and cache.stats()["entries"] == 2
    assert cache.stacked([a, c], None) is other  # the other group stays
    assert cache.stacked([a, b], None) is not first and cache.hits == 2
    assert cache.device_bytes() == 4 * fuse._nbytes(tstates[0])


def test_unfusable_groups_settle_every_future(svc, monkeypatch):
    # graph-path lanes have no scan to stack: the fused task serves them
    # lane by lane from each collection's own graph (never execute_group,
    # which refuses them); a lane that fails there settles every future
    served = []

    def graph_t0(q, k, ef=None):
        served.append("t0")
        return (np.zeros((len(q), k), np.int64),
                np.zeros((len(q), k), np.float32))

    def graph_t1(q, k, ef=None):
        served.append("t1")
        raise ValueError("hnsw graph unavailable")

    monkeypatch.setattr(svc.collection("t0"), "_query_graph", graph_t0)
    monkeypatch.setattr(svc.collection("t1"), "_query_graph", graph_t1)
    futs = [svc.submit(MemoryOp("query", n, _corpus(1), path="hnsw",
                                batch=True)) for n in ("t0", "t1")]
    assert svc.flush() == 1
    for f in futs:
        with pytest.raises(ValueError, match="hnsw"):
            f.result(timeout=10)
    assert served == ["t0", "t1"]
    # a lane whose state is gone at every dispatch: three NotResident
    # retries, then the per-lane fallback answers as the sync query does
    want = {n: svc.query(n, _corpus(2)) for n in ("t0", "t1")}
    coll = svc.collection("t1")
    calls = []

    def gone():
        calls.append(1)
        return None, 0

    monkeypatch.setattr(coll, "versioned_snapshot", gone)
    futs = {n: svc.submit(MemoryOp("query", n, _corpus(2), batch=True))
            for n in ("t0", "t1")}
    assert svc.flush() == 1
    for n, f in futs.items():
        got = f.result(timeout=10)
        np.testing.assert_array_equal(got[0], want[n][0])
        np.testing.assert_array_equal(got[1], want[n][1])
    assert len(calls) == 3


def test_waiting_on_a_parked_future_flushes_and_shutdown_flushes():
    svc = MemoryService(device="cpu", maintenance=False)
    for i, name in enumerate(TENANTS[:2]):
        svc.create_collection(name, CFG, seed=i)
        svc.build(name, _corpus(N0, seed=i))
    q = _corpus(2, seed=5)
    fut = svc.submit(MemoryOp("query", "t0", q, k=4, batch=True))
    assert not fut.done()
    _assert_same(fut.result(timeout=60), svc.query("t0", q, k=4))
    parked = svc.submit(MemoryOp("query", "t1", q, k=4, batch=True))
    assert svc._pending
    svc.shutdown()
    assert parked.done() and parked.exception() is None
    assert svc._pending == []


def test_demux_correct_under_concurrent_rebuild(svc):
    svc.delete("t0", np.arange(32))
    stop = threading.Event()
    errors = []

    def churn():
        try:
            while not stop.is_set():
                assert not svc.collection("t0").rebuild()["aborted"]
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    qs = {n: _corpus(3, seed=90 + i) for i, n in enumerate(TENANTS)}
    want = {n: svc.query(n, qs[n], k=4) for n in ("t1", "t2")}
    t = threading.Thread(target=churn)
    t.start()
    try:
        for _ in range(5):
            n, got = _window(svc, qs, k=4)
            assert n == 1
            assert got["t0"][0].shape == (3, 4)
            assert not np.isin(got["t0"][0], np.arange(32)).any()
            for name in ("t1", "t2"):
                np.testing.assert_array_equal(got[name][0], want[name][0])
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors


def test_failing_groups_settle_every_future(svc, monkeypatch):
    # a signature failure: the collection dropped between park and flush
    gone = svc.submit(MemoryOp("query", "t2", _corpus(1), batch=True))
    svc.drop_collection("t2")
    assert svc.flush() == 0
    with pytest.raises(KeyError):
        gone.result(timeout=10)

    # a dispatch failure settles every future of the group
    def boom(*a, **kw):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(fuse, "execute_group", boom)
    futs = [svc.submit(MemoryOp("query", n, _corpus(2), batch=True))
            for n in ("t0", "t1")]
    assert svc.flush() == 1
    for f in futs:
        with pytest.raises(RuntimeError, match="dispatch failed"):
            f.result(timeout=10)


def test_execute_group_pads_bumps_and_refuses(svc):
    colls = [svc.collection(n) for n in TENANTS]
    before = [c.counters["queries"] for c in colls]
    qs = [_corpus(b, seed=b) for b in (1, 4, 2)]
    out = fuse.execute_group(colls, qs, CFG, 4, 0, "full_scan")
    assert [o[0].shape for o in out] == [(1, 4), (4, 4), (2, 4)]
    assert [c.counters["queries"] for c in colls] == \
        [b + d for b, d in zip(before, (1, 4, 2))]
    for c, q, (ids, scores) in zip(colls, qs, out):
        _assert_same((ids, scores), c.query(q, k=4, path="full_scan"))
    with pytest.raises(ValueError, match="hnsw"):
        fuse.execute_group(colls, qs, CFG, 4, 0, "hnsw")
    with pytest.raises(ValueError, match="2-shard state"):
        fuse.execute_group(colls, qs, CFG, 4, 0, "full_scan",
                           mesh=dce.make_mesh((2,), ("shard",), "cpu"))


def test_batch_signature_has_the_reference_shape(svc):
    sig = svc.collection("t0").batch_signature(1, None, None, None)
    assert sig == (CFG, "float32", 4096, None, 4, 8, "probed")
    assert svc.collection("t0").batch_signature(2, 3, None, None)[4:] == \
        (3, 0, "full_scan")
    state, version = svc.collection("t0").versioned_snapshot()
    assert state is svc.collection("t0").snapshot()
    assert version == svc.collection("t0").version()


# ---------------------------------------------------------------------------
# Mesh-sharded tenants (tests/test_batch_fusion.py's sharded cases on the
# port, a 2-shard mesh of CPU shards): one dispatch per window, equal to the
# per-op `dist_query` path; ids equal, scores to 1e-5 (on the CPU a padded
# lane may differ in the last place, see `_assert_same`)
# ---------------------------------------------------------------------------

SCFG = dataclasses.replace(CFG, shard_db=True)
SHARDED = ("s0", "s1", "s2")


@pytest.fixture()
def ssvc():
    mesh = dce.make_mesh((2,), ("shard",), "cpu")
    svc = MemoryService(device="cpu", maintenance=False)
    for i, name in enumerate(SHARDED):
        svc.create_collection(name, SCFG, mesh=mesh, seed=i)
        svc.build(name, _corpus(N0, seed=i),
                  ids=np.arange(i * 10_000, i * 10_000 + N0))
    yield svc, mesh
    svc.shutdown()


def test_sharded_window_is_one_dispatch_equal_to_dist_query(ssvc):
    svc, mesh = ssvc
    qs = {n: _corpus(3 + i, seed=20 + i) for i, n in enumerate(SHARDED)}
    coll = svc.collection("s0")
    ref_ids, ref_scores = dce.dist_query(coll.snapshot(),
                                         torch.from_numpy(qs["s0"]), SCFG,
                                         mesh, 4)
    sync = {n: svc.query(n, q, k=4) for n, q in qs.items()}
    np.testing.assert_array_equal(sync["s0"][0], ref_ids.numpy())
    np.testing.assert_array_equal(sync["s0"][1], ref_scores.numpy())
    n, got = _window(svc, qs, k=4)
    assert n == 1                                # ONE dispatch, 3 tenants
    for name in qs:
        _assert_same(got[name], sync[name])
    # lane g only scanned collection g
    assert (got["s1"][0] // 10_000 == 1).all()
    assert (got["s2"][0] // 10_000 == 2).all()


def test_query_many_sharded(ssvc):
    svc, _ = ssvc
    qs = [("s0", _corpus(4, seed=30)), ("s2", _corpus(6, seed=31))]
    for (name, q), got in zip(qs, svc.query_many(qs, k=4)):
        _assert_same(got, svc.query(name, q, k=4))


def test_degenerate_single_lane_still_fuses_sharded(ssvc):
    svc, _ = ssvc
    q1, q2 = _corpus(3, seed=40), _corpus(5, seed=41)
    f1 = svc.submit(MemoryOp("query", "s1", q1, k=4, batch=True))
    f2 = svc.submit(MemoryOp("query", "s1", q2, k=4, batch=True))
    assert svc.flush() == 1
    np.testing.assert_array_equal(f1.result(timeout=60)[0],
                                  svc.query("s1", q1, k=4)[0])
    np.testing.assert_array_equal(f2.result(timeout=60)[0],
                                  svc.query("s1", q2, k=4)[0])


def test_mixed_window_splits_sharded_and_unsharded(ssvc):
    """Sharded and unsharded tenants in one window -> two fused groups (the
    mesh is part of the signature), each correct; the stacks of both are
    cached apart."""
    svc, mesh = ssvc
    for name, seed in (("u0", 7), ("u1", 8)):
        svc.create_collection(name, CFG)
        svc.build(name, _corpus(N0, seed=seed))
    qs = {n: _corpus(4, seed=50 + i)
          for i, n in enumerate(("s0", "s1", "u0", "u1"))}
    sync = {n: svc.query(n, q, k=4) for n, q in qs.items()}
    n, got = _window(svc, qs, k=4)
    assert n == 2
    for name in qs:
        _assert_same(got[name], sync[name])
    assert svc.collection("s0").batch_signature(4, 4, None, None)[3] == mesh
    assert svc.collection("u0").batch_signature(4, 4, None, None)[3] is None
    assert svc.stats()["stack_cache"]["entries"] == 2
    for name in ("u0", "u1"):
        svc.drop_collection(name)
