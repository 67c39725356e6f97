"""Save/load of the port against the JAX package: the checkpoint layout
(`step_<N>/manifest.json` + `arr_<i>.npy` + `COMMIT`), collection
snapshots that each package loads from the other for both store dtypes,
and the port's `MemoryService.save`/`load` round trip.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Collection as JCollection
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import EngineConfig as JConfig
from repro.core import index as jivf
from repro_torch.api import Collection, MemoryService
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
from repro_torch.configs.base import EngineConfig
from repro_torch.convert import ivf_state_to_numpy
from repro_torch.core import index as ivf

jax.config.update("jax_platform_name", "cpu")

ARGS = dict(dim=128, n_clusters=128, list_capacity=16, nprobe=8, k=4,
            kmeans_iters=2, rescore_k=32)
DTYPES = ["float32", "int8"]


def _corpus(n, seed=0, dim=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _queries():
    return _corpus(6, seed=3) * 0.05 + _corpus(300, seed=1)[:6]


def _assert_same_state(tstate, jstate):
    host = ivf_state_to_numpy(tstate)
    for f in jivf.IVFState._fields:
        a, b = getattr(jstate, f), getattr(host, f)
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _written(coll, asarray):
    """The same writes on either package's collection."""
    coll.build(asarray(_corpus(300, seed=1)))
    coll.insert(asarray(_corpus(20, seed=2)))
    coll.delete(asarray(np.asarray([3, 7, 305], np.int32)))
    return coll


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_snapshot_loads_in_the_port(tmp_path, dtype):
    jcoll = _written(JCollection("c", JConfig(use_kernel=False,
                                              store_dtype=dtype, **ARGS)),
                     jnp.asarray)
    jcoll.save_into(str(tmp_path))
    tcoll = Collection.load_from(str(tmp_path), "c",
                                 EngineConfig(store_dtype=dtype, **ARGS),
                                 device="cpu")
    _assert_same_state(tcoll.snapshot(), jax.device_get(jcoll.snapshot()))
    q = _queries()
    for path in ("full_scan", "probed"):
        want = jcoll.query(jnp.asarray(q), path=path)
        got = tcoll.query(q, path=path)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-3,
                                   atol=1e-3)
    tst, jst = tcoll.stats(), jcoll.stats()
    for key in ("live", "deleted", "spill", "inserts", "deletes",
                "bytes_per_row", "index_bytes", "store_dtype"):
        assert tst[key] == jst[key], key
    assert tcoll._next_id == jcoll._next_id == 320
    assert tcoll._approx_live == jcoll._approx_live == 317


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_snapshot_loads_in_jax(tmp_path, dtype):
    tcoll = _written(Collection("c", EngineConfig(store_dtype=dtype, **ARGS),
                                device="cpu"), np.asarray)
    tcoll.save_into(str(tmp_path), step=3)
    jcoll = JCollection.load_from(str(tmp_path), "c",
                                  JConfig(use_kernel=False, **ARGS))
    assert jcoll.cfg.store_dtype == dtype
    _assert_same_state(tcoll.snapshot(), jax.device_get(jcoll.snapshot()))
    q = _queries()
    want = tcoll.query(q, path="full_scan")
    got = jcoll.query(jnp.asarray(q), path="full_scan")
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])
    assert jcoll.maintenance_pressure()["tombstones"] == 3
    assert jcoll.stats()["inserts"] == tcoll.stats()["inserts"] == 20


def test_leaf_order_is_jax_flatten_order(tmp_path):
    """Leaves are numbered as `jax.tree.flatten` numbers them: a dict's
    keys sorted (not IVFState's field order), None fields no leaf."""
    cfg = EngineConfig(store_dtype="int8", **ARGS)
    tree = ivf.empty_host_state(cfg, 64)._asdict()
    leaves = []
    treedef = _flatten(tree, leaves)
    jleaves, jdef = jax.tree.flatten(
        jivf.empty_host_state(JConfig(store_dtype="int8", **ARGS),
                              64)._asdict())
    assert f"PyTreeDef({treedef})" == str(jdef)
    assert [a.shape for a in leaves] == [a.shape for a in jleaves]
    Checkpointer(str(tmp_path)).save(0, tree)
    with open(tmp_path / "step_00000000" / "manifest.json") as f:
        assert json.load(f)["treedef"] == str(jdef)
    f32 = ivf.empty_host_state(dataclasses.replace(cfg, store_dtype="float32"),
                               64)._asdict()
    assert sum(v is not None for v in f32.values()) == 8


def test_service_save_load_round_trip(tmp_path):
    with MemoryService(device="cpu", maintenance=False) as svc:
        for name, dtype in (("f", "float32"), ("q", "int8")):
            svc.create_collection(name, EngineConfig(store_dtype=dtype,
                                                     **ARGS))
            svc.build(name, _corpus(300, seed=1))
            svc.insert(name, _corpus(20, seed=2))
            svc.delete(name, np.asarray([3, 7], np.int32))
        want = {n: svc.query(n, _queries()) for n in ("f", "q")}
        stats = svc.stats()["collections"]
        svc.save(str(tmp_path))
    back = MemoryService.load(str(tmp_path), device="cpu", maintenance=False)
    try:
        assert back.list_collections() == ["f", "q"]
        for n in ("f", "q"):
            got = back.query(n, _queries())
            np.testing.assert_array_equal(got[0], want[n][0])
            np.testing.assert_array_equal(got[1], want[n][1])
            st = back.stats()["collections"][n]
            for key in ("live", "deleted", "spill", "inserts", "deletes",
                        "rebuilds", "store_dtype", "index_bytes", "pressure"):
                assert st[key] == stats[n][key], (n, key)
        # the id allocator carried over: new rows continue after the old ids
        back.insert("q", _corpus(2, seed=4))
        ids, _ = back.query("q", _corpus(2, seed=4), k=1)
        np.testing.assert_array_equal(ids[:, 0], [320, 321])
    finally:
        back.shutdown()


@pytest.mark.parametrize("saved,asked", [("int8", "float32"),
                                         ("float32", "int8")])
def test_saved_store_dtype_wins(tmp_path, saved, asked):
    coll = Collection("c", EngineConfig(store_dtype=saved, **ARGS),
                      device="cpu")
    coll.build(_corpus(256, seed=13), ids=np.arange(256, dtype=np.int32))
    q = _corpus(8, seed=14)
    want = coll.query(q, k=4)
    coll.save_into(str(tmp_path))
    back = Collection.load_from(str(tmp_path), "c",
                               EngineConfig(store_dtype=asked, **ARGS),
                               device="cpu")
    assert back.cfg.store_dtype == saved
    assert back.snapshot().quantized == (saved == "int8")
    got = back.query(q, k=4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_checkpoint_without_commit_is_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": np.arange(3), "b": None})
    ck.save(2, {"a": np.arange(3) + 10, "b": None})
    os.remove(tmp_path / "step_00000002" / "COMMIT")     # a torn write
    os.makedirs(tmp_path / "step_00000005.tmp")           # an unpublished one
    assert ck.all_steps() == [1] and ck.latest_step() == 1
    np.testing.assert_array_equal(ck.restore({"a": 0, "b": None})["a"],
                                  np.arange(3))
    # the reference's checkpointer reads the same directory the same way
    jck = JCheckpointer(str(tmp_path))
    assert jck.all_steps() == [1]
    np.testing.assert_array_equal(jck.restore({"a": 0, "b": None})["a"],
                                  np.arange(3))
    empty = Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        empty.restore({"a": 0})
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"a": 0, "b": 0})


def test_save_async_keep_n_and_device_restore(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    for step in range(1, 5):
        ck.save_async(step, {"w": torch.full((4,), float(step)),
                             "n": torch.tensor(step, dtype=torch.int32)})
    ck.wait()
    assert ck.all_steps() == [3, 4]
    out = ck.restore({"w": 0, "n": 0}, device="cpu")
    assert isinstance(out["w"], torch.Tensor)
    assert torch.equal(out["w"], torch.full((4,), 4.0))
    assert out["n"].dtype == torch.int32 and int(out["n"]) == 4


@pytest.mark.parametrize("meta", [{"sharded": True}])
def test_sharded_and_non_hot_snapshots_name_their_item(tmp_path, meta):
    coll = Collection("c", EngineConfig(**ARGS), device="cpu")
    coll.build(_corpus(200, seed=5))
    coll.save_into(str(tmp_path))
    path = tmp_path / "collection.json"
    saved = json.loads(path.read_text())
    path.write_text(json.dumps({**saved, **meta}))
    # the sharded tier is ported: an unsharded config names the fix
    with pytest.raises(ValueError, match="shard_db"):
        Collection.load_from(str(tmp_path), "c", EngineConfig(**ARGS),
                             device="cpu")


@pytest.mark.parametrize("tier", ["warm", "cold"])
def test_warm_and_cold_snapshots_load_in_their_tier(tmp_path, tier):
    """A WARM or COLD collection saves from its host copy or its cold
    checkpoint and loads back in that tier (COLD as a pointer, no array
    read); its first query promotes it and answers as the HOT original."""
    coll = _written(Collection("c", EngineConfig(**ARGS), device="cpu"),
                    np.asarray)
    q = _queries()
    want = coll.query(q)
    kw = {"directory": str(tmp_path / "cold")} if tier == "cold" else {}
    assert coll.demote(tier, **kw)["demoted"]
    coll.save_into(str(tmp_path / "snap"))
    assert coll.snapshot() is None                 # saving did not promote
    saved = json.loads((tmp_path / "snap" / "collection.json").read_text())
    assert saved["residency"] == tier
    back = Collection.load_from(str(tmp_path / "snap"), "c",
                                EngineConfig(**ARGS), device="cpu")
    assert back.residency == tier and back.snapshot() is None
    assert (back._host_state is None) == (tier == "cold")
    assert back.maintenance_pressure() == coll.maintenance_pressure()
    got = back.query(q)
    assert back.residency == "hot"
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert back.stats()["live"] == 317


def test_load_restores_pressure_and_spill_floor(tmp_path):
    cfg = EngineConfig(**{**ARGS, "list_capacity": 8})
    coll = Collection("c", cfg, device="cpu", spill_capacity=512)
    coll.build(_corpus(1200, seed=6))             # lists overflow to spill
    coll.delete(np.arange(10, dtype=np.int32))
    coll.save_into(str(tmp_path))
    back = Collection.load_from(str(tmp_path), "c", cfg, device="cpu")
    assert back.spill_capacity == 512
    assert back.maintenance_pressure() == coll.maintenance_pressure()
    assert back._spill_floor == coll._spill_floor > 0
    assert back.maintenance_due_shards() == coll.maintenance_due_shards()
