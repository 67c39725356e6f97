"""Port parity for k-means and the f32 IVF index: `repro_torch` against the
JAX package on the same numpy inputs (small shapes: dim 128, C 128, L 16-32).

The JAX side mostly runs with use_kernel=False (its jnp oracles), as its
own service tests do; the port runs its kernels' plain versions on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JConfig
from repro.core import index as jivf
from repro.core import kmeans as jkmeans
from repro_torch.configs.base import EngineConfig
from repro_torch.convert import ivf_state_from_numpy, ivf_state_to_numpy
from repro_torch.core import index as ivf
from repro_torch.core import kmeans as tkmeans
from repro_torch.core import metrics

jax.config.update("jax_platform_name", "cpu")

CFG = dict(dim=128, n_clusters=128, list_capacity=16, nprobe=8, k=5,
           kmeans_iters=3)


def _cfgs(use_kernel=True, jax_kernel=False, **kw):
    args = {**CFG, **kw}
    return (JConfig(use_kernel=jax_kernel, interpret=True, **args),
            EngineConfig(use_kernel=use_kernel, **args))


def _randn(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _live(state):
    ids = np.concatenate([np.asarray(state.list_ids).ravel(),
                          np.asarray(state.spill_ids).ravel()])
    return set(ids[ids >= 0].tolist())


def _jax_build(jcfg, x, ids, seed=1, spill=256):
    st, sp = jivf.build(jax.random.PRNGKey(seed), jnp.asarray(x),
                        jnp.asarray(ids), jcfg, spill_capacity=spill)
    return jax.device_get(st), int(sp)


def _same_topk(ids_a, sc_a, ids_b, sc_b, tol=1e-3):
    """Equal scores; ids equal up to ties (a tie may order either way, and
    at the k-th place either tied id may be in)."""
    np.testing.assert_allclose(sc_a, sc_b, rtol=tol, atol=tol)
    for ia, sa, ib, sb in zip(ids_a, sc_a, ids_b, sc_b):
        clear_a = {int(i) for i, s in zip(ia, sa) if s > sa[-1] + tol}
        clear_b = {int(i) for i, s in zip(ib, sb) if s > sb[-1] + tol}
        assert clear_a == clear_b
        sep = np.r_[True, np.diff(sa) < -tol] & np.r_[np.diff(sa) < -tol, True]
        np.testing.assert_array_equal(np.asarray(ia)[sep], np.asarray(ib)[sep])


# ---------------------------------------------------------------------------
# k-means with the reference's draws injected
# ---------------------------------------------------------------------------

def _jax_draws(key, valid, c, iters):
    """The draws of repro/core/kmeans.py:35-38 and :51-52, replayed."""
    m = valid.shape[0]
    key, sub = jax.random.split(key)
    g = jax.random.gumbel(sub, (m,)) + jnp.where(valid, 0.0, -1e30)
    _, seed_idx = jax.lax.top_k(g, c)
    reseeds = []
    for k in jax.random.split(key, iters):
        g = jax.random.gumbel(k, (m,)) + jnp.where(valid, 0.0, -1e30)
        reseeds.append(torch.from_numpy(np.array(jax.lax.top_k(g, c)[1])))
    return torch.from_numpy(np.array(seed_idx)), reseeds


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_kmeans_with_injected_draws_matches_reference(use_kernel, metric):
    """Both sides in the same arithmetic (the port's kernel plain versions
    against the Pallas kernels in interpret mode, or both sets of oracles).
    Each cluster's rows coincide and are small integers, so every product
    and mean is exact: two seeds drawn from one cluster tie exactly and the
    lowest index wins on both sides, where a spread cluster would split
    between them by the summation order alone."""
    jcfg, tcfg = _cfgs(use_kernel, jax_kernel=use_kernel, metric=metric)
    c, per = 128, 6
    centers = np.random.default_rng(20).integers(-8, 9, (c, 128))
    x = np.repeat(centers.astype(np.float32), per, 0)
    valid = np.ones(c * per, bool)
    valid[::11] = False
    key = jax.random.PRNGKey(3)
    jcent, jassign = jkmeans.kmeans(key, jnp.asarray(x), jnp.asarray(valid),
                                    jcfg)
    seed_idx, reseeds = _jax_draws(key, jnp.asarray(valid), c,
                                   jcfg.kmeans_iters)
    cent, assign = tkmeans.kmeans(None, torch.from_numpy(x),
                                  torch.from_numpy(valid), tcfg,
                                  seed_idx=seed_idx, reseed_idx=reseeds)
    np.testing.assert_allclose(cent.numpy(), np.asarray(jcent),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
    assert np.all(assign.numpy()[~valid] == -1)


def test_kmeans_own_draws_cluster_every_row():
    _, tcfg = _cfgs()
    x = torch.from_numpy(_randn(22, (1000, 128)))
    valid = torch.ones(1000, dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    cent, assign = tkmeans.kmeans(gen, x, valid, tcfg)
    assert cent.shape == (128, 128) and assign.dtype == torch.int32
    assert int(assign.min()) >= 0 and int(assign.max()) < 128
    # ip: spherical centroids
    torch.testing.assert_close(cent.norm(dim=1), torch.ones(128))


# ---------------------------------------------------------------------------
# packing, insert, delete, replay, rebuild
# ---------------------------------------------------------------------------

def test_pack_fed_reference_assignments_is_identical():
    jcfg, tcfg = _cfgs()
    n = 900
    x = _randn(23, (n, 128))
    ids = np.arange(n, dtype=np.int32)
    ids[::13] = -1
    # skewed assignments: a few hot clusters overflow into the spill buffer
    assign = (np.random.default_rng(24).zipf(1.5, n) % 128).astype(np.int32)
    cent = _randn(25, (128, 128))
    jstate = jivf.empty_state(jcfg, 128)._replace(centroids=jnp.asarray(cent))
    jnew, jover = jivf._pack(jstate, jnp.asarray(x), jnp.asarray(ids),
                             jnp.asarray(assign), jcfg)
    tstate = ivf.empty_state(tcfg, 128, device="cpu")._replace(
        centroids=torch.from_numpy(cent))
    tnew, tover = ivf._pack(tstate, torch.from_numpy(x),
                            torch.from_numpy(ids), torch.from_numpy(assign),
                            tcfg)
    assert int(tover) == int(jover) > 128          # spill overflowed too
    for f in ("lists", "list_ids", "list_sizes", "spill", "spill_ids",
              "spill_size", "num_deleted"):
        np.testing.assert_array_equal(getattr(tnew, f).numpy(),
                                      np.asarray(getattr(jnew, f)), err_msg=f)


@pytest.mark.parametrize("cl", [
    [3, 1, 3, 3, 0, 1, 7], [5] * 9, list(range(6)), [],
])
def test_batch_ranks_matches_reference(cl):
    cl = np.asarray(cl, np.int32)
    want = np.asarray(jivf._batch_ranks(jnp.asarray(cl)))
    np.testing.assert_array_equal(
        ivf._batch_ranks(torch.from_numpy(cl)).numpy(), want)


def _carried(jcfg, n=600, seed=26):
    x = _randn(seed, (n, 128))
    ids = np.arange(n, dtype=np.int32)
    jstate, _ = _jax_build(jcfg, x, ids)
    return jstate, ivf_state_from_numpy(jstate, device="cpu"), x


def test_insert_delete_replay_rebuild_match_reference():
    jcfg, tcfg = _cfgs()
    jstate, tstate, x = _carried(jcfg)
    rows = _randn(27, (64, 128))
    new_ids = np.arange(1000, 1064, dtype=np.int32)
    js, jsp = jivf.insert_shared(jstate, jnp.asarray(rows),
                                 jnp.asarray(new_ids), jcfg)
    ts, tsp = ivf.insert_shared(tstate, torch.from_numpy(rows),
                                torch.from_numpy(new_ids), tcfg)
    assert int(tsp) == int(jsp)
    assert _live(ts) == _live(jax.device_get(js))
    np.testing.assert_array_equal(ts.list_sizes.numpy(),
                                  np.asarray(js.list_sizes))
    # the shared variant left the carried state untouched
    assert _live(tstate) == set(range(600))

    gone = np.asarray([0, 5, 1003, 9999], np.int32)
    js2, jn = jivf.delete_shared(js, jnp.asarray(gone))
    ts2, tn = ivf.delete_shared(ts, torch.from_numpy(gone))
    assert int(tn) == int(jn) == 3
    assert int(ts2.num_deleted) == int(js2.num_deleted) == 3
    assert _live(ts2) == _live(jax.device_get(js2))

    log_rows = _randn(28, (24, 128))
    jlog = [jivf.DeltaOp("insert", jnp.asarray(log_rows),
                         jnp.arange(2000, 2024, dtype=jnp.int32)),
            jivf.DeltaOp("delete", None, jnp.asarray([1, 2, 2005], jnp.int32))]
    tlog = [ivf.DeltaOp("insert", torch.from_numpy(log_rows),
                        torch.arange(2000, 2024, dtype=torch.int32)),
            ivf.DeltaOp("delete", None,
                        torch.tensor([1, 2, 2005], dtype=torch.int32))]
    jr, _ = jivf.rebuild(jax.random.PRNGKey(5), js2, jcfg)
    tr, _ = ivf.rebuild(torch.Generator().manual_seed(5), ts2, tcfg)
    assert _live(tr) == _live(jax.device_get(jr))
    assert int(tr.num_deleted) == 0
    jr, jspill, jtomb = jivf.replay(jr, jlog, jcfg)
    tr, tspill, ttomb = ivf.replay(tr, tlog, tcfg)
    assert ttomb == jtomb == 3
    assert _live(tr) == _live(jax.device_get(jr))
    with pytest.raises(ValueError):
        ivf.replay(tr, [ivf.DeltaOp("upsert", None, torch.tensor([1]))], tcfg)


def test_in_place_variants_write_into_the_state():
    jcfg, tcfg = _cfgs()
    _, tstate, _ = _carried(jcfg, n=300)
    before = tstate.lists
    new, _ = ivf.insert(tstate, torch.from_numpy(_randn(29, (10, 128))),
                        torch.arange(500, 510, dtype=torch.int32), tcfg)
    assert new.lists is before and 505 in _live(tstate)
    new, n = ivf.delete(new, torch.tensor([505], dtype=torch.int32))
    assert int(n) == 1 and 505 not in _live(tstate)


# ---------------------------------------------------------------------------
# queries on a state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("path", ["full_scan", "probed"])
def test_queries_on_carried_state_match_reference(metric, path):
    jcfg, tcfg = _cfgs(metric=metric)
    jstate, tstate, x = _carried(jcfg)
    q = x[:6] + _randn(30, (6, 128), scale=0.05)
    if path == "full_scan":
        jids, jsc = jivf.query_full_scan(jstate, jnp.asarray(q), jcfg, 5)
        tids, tsc = ivf.query_full_scan(tstate, torch.from_numpy(q), tcfg, 5)
    else:
        jids, jsc = jivf.query_probed(jstate, jnp.asarray(q), jcfg, 5, 8)
        tids, tsc = ivf.query_probed(tstate, torch.from_numpy(q), tcfg, 5, 8)
    assert tids.dtype == torch.int32 and tsc.dtype == torch.float32
    _same_topk(tids.numpy(), tsc.numpy(), np.asarray(jids), np.asarray(jsc))
    np.testing.assert_array_equal(tids.numpy()[:, 0], np.arange(6))


def test_query_full_scan_rows_returns_the_vectors():
    jcfg, tcfg = _cfgs()
    _, tstate, x = _carried(jcfg)
    ids, _, rows = ivf.query_full_scan_rows(tstate, torch.from_numpy(x[:4]),
                                            tcfg, 3)
    np.testing.assert_array_equal(rows[:, 0].numpy(),
                                  x[ids[:, 0].numpy()])
    host_rows, host_ids = ivf.flat_rows_host(tstate)   # lists, then spill
    jrows, jids = jivf.flat_rows_host(jivf.IVFState(*map(
        jnp.asarray, ivf_state_to_numpy(tstate)[:8])))
    np.testing.assert_array_equal(host_ids, jids)
    np.testing.assert_array_equal(host_rows, jrows)


def test_query_probed_clamps_nprobe_to_cluster_count():
    jcfg, tcfg = _cfgs()
    _, tstate, x = _carried(jcfg)
    q = torch.from_numpy(x[:4])
    a = ivf.query_probed(tstate, q, tcfg, 4, 128)
    b = ivf.query_probed(tstate, q, tcfg, 4, 128 + 37)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=1e-6)


def test_brute_force_oracle_matches_reference():
    from repro.core import metrics as jmetrics
    rows = _randn(31, (200, 128))
    ids = np.arange(200, dtype=np.int32)
    ids[::9] = -1
    q = rows[:7] + 0.01
    for metric in ("ip", "l2"):
        want = jmetrics.brute_force_topk(q, rows, ids, 10, metric)
        got = metrics.brute_force_topk(q, rows, ids, 10, metric,
                                       device="cpu")
        np.testing.assert_array_equal(got, want)
    # k past the live rows pads with -1
    got = metrics.brute_force_topk(q, rows[:3], ids[:3], 5, device="cpu")
    assert np.all(got[:, 2:] == -1)
    assert metrics.recall_at_k(got, got) == 1.0


# ---------------------------------------------------------------------------
# state carried across the packages, accounting
# ---------------------------------------------------------------------------

def test_convert_round_trip_is_bitwise():
    jcfg, _ = _cfgs()
    jstate, tstate, _ = _carried(jcfg)
    jstate = jax.device_get(jstate)
    back = ivf_state_to_numpy(tstate)
    for f in jivf.IVFState._fields:
        a, b = getattr(jstate, f), getattr(back, f)
        if a is None:
            assert b is None
            continue
        assert np.asarray(a).dtype == b.dtype and np.asarray(a).shape == b.shape
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f)


def test_footprint_stats_and_nbytes_match_reference():
    jcfg, tcfg = _cfgs()
    jstate, tstate, _ = _carried(jcfg)
    assert ivf.state_nbytes(tcfg, 256) == jivf.state_nbytes(jcfg, 256)
    assert ivf.footprint(tstate) == jivf.footprint(jstate)
    assert ivf.stats(tstate) == jivf.stats(jstate)
    assert int(ivf.live_count(tstate)) == int(jivf.live_count(jstate))


def test_int8_policy_names_its_slice():
    """The int8 policy is ported: its state carries the reference's int8
    store fields and its accounting names the policy."""
    jcfg, tcfg = _cfgs(store_dtype="int8")
    state = ivf.empty_state(tcfg, 256, device="cpu")
    jstate = jivf.empty_state(jcfg, 256)
    for f in jivf.IVFState._fields:
        a, b = getattr(jstate, f), getattr(state, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f)
            assert b.numpy().dtype == np.asarray(a).dtype, f
    assert ivf.footprint(state) == jivf.footprint(jstate)
    assert ivf.footprint(state)["store_dtype"] == "int8"
