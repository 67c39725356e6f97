"""Port parity for the mesh-sharded tier (`repro_torch.core.distributed`)
against `repro.core.distributed` on the 2-device CPU mesh tests/conftest.py
forces, from numpy inputs made from a seed (D=128, C=128, L=16, a few
hundred rows).

Both packages compare through the reference's global layout
(`split_host` / `assemble_host`, the sharded `convert` pair).  The JAX side
runs its jnp oracles (``use_kernel=False``), the port its kernels' plain
versions on the CPU.  Rows are small integers (clusters of coincident rows
for the builds), so every product, mean and distance is exact in both and
ids and leaves compare exactly; scores to 1e-5.  Beyond the build's own
parity test, both packages start from one state (built by the port,
carried to the reference's layout): a reference build compiles for ~10 s
on the CPU.  Query data has no tie inside a shard (the packages' top-k
orders such ties differently) and ties across the shards on purpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JConfig
from repro.core import distributed as jdce
from repro.core import index as jivf
from repro_torch.configs.base import EngineConfig
from repro_torch.convert import sharded_state_from_numpy, \
    sharded_state_to_numpy
from repro_torch.core import distributed as dce
from repro_torch.core import index as ivf

jax.config.update("jax_platform_name", "cpu")

if jax.device_count() < 2:
    pytest.skip("needs >= 2 devices (tests/conftest.py forces 2 fake CPU "
                "devices unless XLA_FLAGS was pre-set)",
                allow_module_level=True)

S = 2
ARGS = dict(dim=128, n_clusters=128, list_capacity=16, nprobe=8, k=4,
            kmeans_iters=2, shard_db=True, rescore_k=32)
SPILL = 64


def _cfgs(**kw):
    args = {**ARGS, **kw}
    return JConfig(use_kernel=False, **args), EngineConfig(**args)


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((S,), ("shard",))


@pytest.fixture(scope="module")
def mesh():
    return dce.make_mesh((S,), ("shard",), "cpu")


def _ints(seed, shape, lo=-8, hi=9):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def _clustered(seed, c=128, per=4):
    """c clusters of `per` coincident integer rows, rows shuffled."""
    x = np.repeat(_ints(seed, (c, 128)), per, axis=0)
    return x[np.random.default_rng(seed + 1).permutation(len(x))]


def _same_leaves(got, want):
    for f in ivf.IVFState._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _jax_seed_idx(key, ids, cfg, n):
    """The reference's per-shard seed draws (repro/core/distributed.py
    dist_build: one stream per shard from `base + shard`), replayed."""
    base = int(jax.random.randint(key, (), 0, 2**31 - 1))
    m = len(ids) // n
    out = []
    for s in range(n):
        k0, _ = jax.random.split(jax.random.key((base + s) % (2**31 - 1)))
        valid = jnp.asarray(ids[s * m:(s + 1) * m] >= 0)
        g = jax.random.gumbel(k0, (m,)) + jnp.where(valid, 0.0, -1e30)
        _, si = jax.lax.top_k(g, max(cfg.n_clusters // n, 1))
        out.append(torch.from_numpy(np.array(si)).long())
    return out


def _built(mesh, x, seed=3, **kw):
    """A port build over rows x (ids 0..N-1) and the same state in the
    reference's global layout, as host arrays."""
    jcfg, tcfg = _cfgs(metric="l2", **kw)
    st, _ = dce.dist_build(torch.Generator().manual_seed(seed),
                           torch.from_numpy(x),
                           torch.arange(len(x), dtype=torch.int32), tcfg,
                           mesh, SPILL)
    return jcfg, tcfg, jivf.IVFState(*sharded_state_to_numpy(st)), st


def _clustered_built(mesh, **kw):
    return _built(mesh, _clustered(3), **kw)


# ---------------------------------------------------------------------------
# Mesh, layout, convert pair, byte sizes
# ---------------------------------------------------------------------------

def test_make_mesh_row_major_and_hashable():
    m = dce.make_mesh((2, 3), ("replica", "shard"), "cpu")
    assert m.size == 6 and m.shape == (2, 3)
    assert m.axis_names == ("replica", "shard")
    assert m.devices == (torch.device("cpu"),) * 6
    assert m == dce.make_mesh((2, 3), ("replica", "shard"), ["cpu"] * 6)
    assert len({m, dce.make_mesh((2, 3), ("replica", "shard"), "cpu")}) == 1
    assert m != dce.make_mesh((3, 2), ("replica", "shard"), "cpu")
    with pytest.raises(ValueError, match="needs 6 devices"):
        dce.ShardMesh((2, 3), ("a", "b"), (torch.device("cpu"),) * 4)


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_state_nbytes_matches_reference(store_dtype, n_shards):
    jcfg, tcfg = _cfgs(store_dtype=store_dtype)
    assert ivf.state_nbytes(tcfg, SPILL, n_shards) == \
        jivf.state_nbytes(jcfg, SPILL, n_shards)
    mesh = dce.make_mesh((n_shards,), ("shard",), "cpu")
    st = dce.empty_dist_state(tcfg, mesh, SPILL)
    assert all(s.centroids is st[0].centroids for s in st)   # shared
    nbytes = {(t.data_ptr()): t.numel() * t.element_size()
              for s in st for t in s if t is not None}
    assert sum(nbytes.values()) == ivf.state_nbytes(tcfg, SPILL, n_shards)


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_convert_pair_and_host_layout_round_trip(mesh, store_dtype):
    _, _, ref, _ = _clustered_built(mesh, store_dtype=store_dtype)
    st = sharded_state_from_numpy(ref, mesh)
    assert all(s.centroids is st[0].centroids for s in st)
    _same_leaves(sharded_state_to_numpy(st), ref)
    # split_host: the reference's per-shard states, leaf for leaf
    for mine, theirs in zip(dce.split_host(ref, S), jdce.split_host(ref, S)):
        _same_leaves(mine, theirs)
    for local, want in zip(st, jdce.split_host(ref, S)):
        _same_leaves(local, want)
    # assemble_host inverts split_host (from tensors or host arrays)
    _same_leaves(dce.assemble_host(dce.split_host(ref, S)), ref)
    _same_leaves(dce.assemble_host(st),
                 jax.device_get(jdce.assemble_host(jdce.split_host(ref, S))))


# ---------------------------------------------------------------------------
# dist_build
# ---------------------------------------------------------------------------

def test_dist_build_with_reference_draws(jmesh, mesh):
    """The reference's seed draws injected: the same state leaf for leaf
    and the same per-shard spill (l2: the centroids are means of
    coincident integer rows, exact in both).  Clusters of 12 rows into
    lists of 8 overflow into the spill."""
    jcfg, tcfg = _cfgs(metric="l2", list_capacity=8)
    x = _clustered(5, per=12)
    ids = np.arange(len(x), dtype=np.int32)
    ids[::7] = -1                                   # invalid rows
    key = jax.random.PRNGKey(11)
    ref, ref_sp = jdce.dist_build(key, jnp.asarray(x), jnp.asarray(ids),
                                  jcfg, jmesh, spill_capacity_per_shard=SPILL)
    ref, ref_sp = jax.device_get(ref), np.asarray(ref_sp)
    st, sp = dce.dist_build(None, torch.from_numpy(x), torch.from_numpy(ids),
                            tcfg, mesh, spill_capacity_per_shard=SPILL,
                            seed_idx=_jax_seed_idx(key, ids, jcfg, S))
    assert ref_sp.sum() > 0                         # the spill path ran
    np.testing.assert_array_equal(sp.numpy(), ref_sp)
    _same_leaves(sharded_state_to_numpy(st), ref)
    assert all(s.centroids is st[0].centroids for s in st)


def test_dist_build_own_draws_places_every_valid_row(mesh):
    _, tcfg = _cfgs()
    x = torch.from_numpy(_clustered(6))
    ids = torch.arange(len(x), dtype=torch.int32)
    st, sp = dce.dist_build(torch.Generator().manual_seed(0), x, ids, tcfg,
                            mesh, SPILL)
    live = torch.cat([torch.cat([s.list_ids.flatten(), s.spill_ids])
                      for s in st])
    assert sorted(live[live >= 0].tolist()) == list(range(len(x)))
    assert int(sp.sum()) == sum(int(s.spill_size) for s in st)
    with pytest.raises(ValueError, match="divide"):
        dce.dist_build(torch.Generator(), x[:3], ids[:3], tcfg, mesh, SPILL)


# ---------------------------------------------------------------------------
# dist_query (+ fused lanes)
# ---------------------------------------------------------------------------

def _twin(mesh, seed=7, store_dtype="float32", b=6):
    """Shard 1 holds a copy of shard 0's rows under other ids, so every
    candidate ties across the shards; within a shard the exact integer
    scores of the queries are distinct (checked)."""
    base = _ints(seed, (256, 128), -100, 101)
    q = _ints(seed + 1, (b, 128), -100, 101)
    d2 = (base ** 2).sum(1)[None, :] - 2.0 * q @ base.T
    top = np.sort(d2, axis=1)[:, :2 * ARGS["k"]]
    assert (np.diff(top, axis=1) > 0).all()        # no tie inside a shard
    return (q,) + _built(mesh, np.concatenate([base, base]), seed,
                         store_dtype=store_dtype)


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_dist_query_matches_reference_with_ties_across_shards(
        jmesh, mesh, store_dtype):
    q, jcfg, tcfg, ref, st = _twin(mesh, store_dtype=store_dtype)
    want_ids, want_sc = jdce.dist_query(ref, jnp.asarray(q), jcfg, jmesh, 4)
    ids, sc = dce.dist_query(st, torch.from_numpy(q), tcfg, mesh, 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=1e-5,
                               atol=1e-5)
    # each pair tied and went to shard 0's id first
    assert (ids.numpy()[:, 0] < 256).all()
    assert (ids.numpy()[:, 1] == ids.numpy()[:, 0] + 256).all()


def test_fused_stacked_equals_dist_query_and_reference(jmesh, mesh):
    """G = 2 sharded lanes, one of them padded: the fused dispatch equals
    the per-lane `dist_query` bit for bit (B >= 2 lanes: no gemv case) and
    the reference's `dist_fused_query` (ids equal, scores 1e-5)."""
    q_a, jcfg, tcfg, ref_a, st_a = _twin(mesh, seed=7, b=3)
    q_b, _, _, ref_b, st_b = _twin(mesh, seed=17, b=3)
    q = np.stack([q_a, q_b])
    q[1, 2:] = 0.0                                 # a padding row
    stacked = dce.dist_stack_states([st_a, st_b], mesh)
    assert stacked[0].lists.shape == (2, 128, 16, 128)
    ids, sc = dce.dist_fused_query_stacked(stacked, torch.from_numpy(q),
                                           tcfg, mesh, 4, 0, "full_scan")
    for g, st in enumerate((st_a, st_b)):
        i1, s1 = dce.dist_query(st, torch.from_numpy(q[g]), tcfg, mesh, 4)
        assert torch.equal(ids[g], i1) and torch.equal(sc[g], s1)
    want_ids, want_sc = jdce.dist_fused_query(
        [jax.device_put(r) for r in (ref_a, ref_b)], jnp.asarray(q), jcfg,
        jmesh, 4, 0, "full_scan")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="2-shard state"):
        dce.dist_stack_states([st_a[0]], mesh)


# ---------------------------------------------------------------------------
# dist_insert / dist_delete / dist_rebuild / adopt / replay
# ---------------------------------------------------------------------------

def test_dist_insert_and_delete_match_reference(jmesh, mesh):
    jcfg, tcfg, ref, st = _clustered_built(mesh)
    rows = np.repeat(_ints(30, (4, 128)), 8, axis=0)   # overflow -> spill
    nid = np.arange(5000, 5000 + len(rows), dtype=np.int32)
    jst, jsp = jdce.dist_insert(ref, jnp.asarray(rows), jnp.asarray(nid),
                                jcfg, jmesh)
    st2, sp = dce.dist_insert(st, torch.from_numpy(rows),
                              torch.from_numpy(nid), tcfg, mesh)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    _same_leaves(sharded_state_to_numpy(st2), jax.device_get(jst))
    _same_leaves(sharded_state_to_numpy(st), ref)    # the input unchanged
    dead = np.concatenate([np.arange(0, 400, 3), nid[::5], [99_999]])
    jst2, jhits = jdce.dist_delete(jst, jnp.asarray(dead, jnp.int32), jmesh)
    st3, hits = dce.dist_delete(st2, torch.from_numpy(dead.astype(np.int32)),
                                mesh)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    assert int(hits.sum()) == len(dead) - 1
    _same_leaves(sharded_state_to_numpy(st3), jax.device_get(jst2))
    with pytest.raises(ValueError, match="divide"):
        dce.dist_insert(st, torch.from_numpy(rows[:3]),
                        torch.from_numpy(nid[:3]), tcfg, mesh)


@pytest.mark.parametrize("shard", [1, -1])
def test_dist_rebuild_matches_reference_siblings_untouched(jmesh, mesh, shard):
    jcfg, tcfg, ref, st = _clustered_built(mesh)
    dead = np.arange(0, 512, 2, dtype=np.int32)
    jst, _ = jdce.dist_delete(ref, jnp.asarray(dead), jmesh)
    st, _ = dce.dist_delete(st, torch.from_numpy(dead), mesh)
    jreb, jsp = jdce.dist_rebuild(jst, jcfg, jmesh, shard=shard)
    reb, sp = dce.dist_rebuild(st, tcfg, mesh, shard=shard)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    _same_leaves(sharded_state_to_numpy(reb), jax.device_get(jreb))
    for i in range(S):
        if shard >= 0 and i != shard:
            assert reb[i] is st[i]                  # the same tensors
        else:
            assert int(reb[i].num_deleted) == 0
    adopted = dce.dist_adopt_shard(st, reb, max(shard, 0), mesh)
    want = jdce.dist_adopt_shard(jst, jreb, max(shard, 0), jmesh)
    _same_leaves(sharded_state_to_numpy(adopted), jax.device_get(want))


def test_dist_replay_onto_one_shard(jmesh, mesh):
    """Insert and delete ops replayed onto shard 1 alone, against the
    reference's single-shard `ivf.replay` on that shard (its own
    `dist_replay` stops at a jax 0.9 ShardingTypeError); shard 0 is
    untouched."""
    jcfg, tcfg, ref, st = _clustered_built(mesh)
    rows = _ints(40, (6, 128))
    log_np = [("insert", rows[:4], np.arange(7000, 7004, dtype=np.int32)),
              ("delete", None, np.asarray([1, 2, 3, 7001], np.int32)),
              ("insert", np.repeat(rows[4:], 20, axis=0),
               np.arange(7100, 7140, dtype=np.int32))]
    log = [ivf.DeltaOp(k, None if r is None else torch.from_numpy(r),
                       torch.from_numpy(i)) for k, r, i in log_np]
    reb, _ = dce.dist_rebuild(st, tcfg, mesh, shard=1)
    before0 = reb[0]
    out, spilled, tomb = dce.dist_replay(reb, log, 1, tcfg, mesh)
    assert out[0] is before0
    jreb, _ = jdce.dist_rebuild(jax.device_put(ref), jcfg, jmesh, shard=1)
    local = jax.tree.map(jnp.asarray, jdce.split_host(jreb, S)[1])
    jlog = [jivf.DeltaOp(k, None if r is None else jnp.asarray(r),
                         jnp.asarray(i)) for k, r, i in log_np]
    want, jsp, jtomb = jivf.replay(local, jlog, jcfg)
    assert (spilled, tomb) == (int(jsp), int(jtomb))
    assert spilled > 0
    _same_leaves(out[1], jax.device_get(want))
    with pytest.raises(ValueError, match="unknown delta op"):
        dce.dist_replay(out, [ivf.DeltaOp("upsert", None, log[1].ids)], 1,
                        tcfg, mesh)


# ---------------------------------------------------------------------------
# reshard_host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_new", [1, 4])
def test_reshard_host_matches_reference(jmesh, mesh, n_new):
    jcfg, tcfg, ref, st = _clustered_built(mesh)
    dead = np.arange(0, 512, 5, dtype=np.int32)
    st, _ = dce.dist_delete(st, torch.from_numpy(dead), mesh)
    jst, _ = jdce.dist_delete(ref, jnp.asarray(dead), jmesh)
    saved = jdce.split_host(jst, S)
    want = jdce.reshard_host(saved, jcfg, n_new, SPILL)
    new_mesh = dce.make_mesh((n_new,), ("shard",), "cpu")
    got = dce.reshard_host(list(st), tcfg, new_mesh, SPILL)
    assert len(got) == n_new
    assert all(s.centroids is got[0].centroids for s in got)
    for g, w in zip(got, want):
        _same_leaves(g, jax.device_get(w))
    live = np.concatenate([np.concatenate([s.list_ids.flatten().numpy(),
                                           s.spill_ids.numpy()])
                           for s in got])
    assert set(live[live >= 0].tolist()) == set(range(512)) - set(dead.tolist())
