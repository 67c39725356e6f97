"""The port's device mesh on the CPU: `MeshConfig`, `launch.mesh`
(`make_mesh`, `make_production_mesh`, `describe`), `models.sharding`
(`use_mesh`, the logical-axis table, placements, `Placed`, the three
collectives), `distributed.elastic` (`remesh`, `reshard_restore` onto a
mesh) and `Checkpointer.restore(shardings=)`, held against the JAX
package where it has a counterpart: the reference's
`test_elastic_reshard_roundtrip` (4 x 2 -> remesh(model_pref=4) -> 2 x 4
over 8 shards, every leaf equal) runs on the port over eight CPU shards,
and a checkpoint the reference saved from its params placed on its 2-device
CPU mesh restores onto port meshes.  Port meshes name their devices
("cpu"); the reference's mesh is built with ``jax.sharding.Mesh`` (Auto
axes), never ``jax.make_mesh``.
"""
import dataclasses
import threading
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.distributed import elastic as jelastic
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.models import sharding as jsharding
from repro.models import specs as jspecs
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import MeshConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.distributed import elastic
from repro_torch.launch import mesh as lmesh
from repro_torch.models import lm, sharding, specs

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")


def _fake_mesh(shape, axes):
    """What the reference's `describe` reads of a mesh."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


# ---------------------------------------------------------------------------
# MeshConfig and launch.mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_config_is_the_reference(multi_pod):
    mine = MeshConfig(multi_pod=multi_pod)
    ref = jbase.MeshConfig(multi_pod=multi_pod)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    for prop in ("shape", "axes", "num_devices", "data_axes"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    small = MeshConfig(multi_pod=multi_pod, pods=2, data=2, model=4)
    jsmall = jbase.MeshConfig(multi_pod=multi_pod, pods=2, data=2, model=4)
    assert (small.shape, small.num_devices) == (jsmall.shape,
                                                jsmall.num_devices)


@pytest.mark.parametrize("mc", [MeshConfig(data=2, model=4),
                                MeshConfig(data=1, model=2),
                                MeshConfig(multi_pod=True, pods=2, data=1,
                                           model=2)])
def test_make_mesh_and_describe(mc):
    mesh = lmesh.make_mesh(mc, devices="cpu")
    assert isinstance(mesh, ShardMesh)
    assert mesh.shape == mc.shape and mesh.axis_names == mc.axes
    assert mesh.devices == (CPU,) * mc.num_devices
    assert lmesh.describe(mesh) == jmesh.describe(_fake_mesh(mc.shape,
                                                             mc.axes))
    listed = lmesh.make_mesh(mc, devices=["cpu"] * mc.num_devices)
    assert listed == mesh
    with pytest.raises(ValueError):
        lmesh.make_mesh(mc, devices=["cpu"] * (mc.num_devices + 1))


def test_describe_matches_reference_string():
    mesh = lmesh.make_mesh(MeshConfig(data=2, model=4), devices="cpu")
    assert lmesh.describe(mesh) == "data=2xmodel=4"


def test_meshes_take_one_card_a_shard_and_never_cycle(monkeypatch):
    """No devices named: cuda:0 .. cuda:n-1, and too few cards raise (no
    silent cycling); the production meshes raise below 256 / 512 cards
    unless devices are named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = lmesh.make_mesh(MeshConfig(data=2, model=4))
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(8))
    with pytest.raises(RuntimeError, match="8"):
        lmesh.make_mesh(MeshConfig(data=4, model=4))
    with pytest.raises(RuntimeError, match="256"):
        lmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512"):
        lmesh.make_production_mesh(multi_pod=True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        lmesh.make_mesh(MeshConfig(data=1, model=2))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_named_devices(multi_pod):
    mesh = lmesh.make_production_mesh(multi_pod=multi_pod, devices="cpu")
    mc = jbase.MeshConfig(multi_pod=multi_pod)
    assert mesh.shape == mc.shape and mesh.axis_names == mc.axes
    assert mesh.size == mc.num_devices
    assert lmesh.describe(mesh) == jmesh.describe(_fake_mesh(mc.shape,
                                                             mc.axes))


# ---------------------------------------------------------------------------
# use_mesh, the logical table, placements
# ---------------------------------------------------------------------------

def test_use_mesh_nests_and_is_thread_local():
    a = lmesh.make_mesh(MeshConfig(data=1, model=2), devices="cpu")
    b = lmesh.make_mesh(MeshConfig(data=2, model=1), devices="cpu")
    x = torch.arange(8.0).reshape(2, 4)
    assert sharding.current_mesh() is None
    assert sharding.shard(x, "batch", "model") is x
    assert sharding.spec("batch") is None
    seen = {}
    with sharding.use_mesh(a):
        assert sharding.current_mesh() is a
        with sharding.use_mesh(b):
            assert sharding.current_mesh() is b
            t = threading.Thread(target=lambda: seen.update(
                other=sharding.current_mesh()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            with sharding.use_mesh(None):
                assert sharding.current_mesh() is None
            assert sharding.current_mesh() is b
        assert sharding.current_mesh() is a
        placed = sharding.shard(x, "batch", "model")
        assert placed.spec == ("data", "model")
        assert torch.equal(placed.full(), x)
        assert sharding.spec(None, "model") == (None, "model")
    assert seen["other"] is None
    assert sharding.current_mesh() is None


@pytest.mark.parametrize("shape,axes", [((1, 2), ("data", "model")),
                                        ((1, 1, 2), ("pod", "data", "model"))])
def test_logical_table_matches_reference(shape, axes):
    jm = Mesh(np.array(jax.devices()[:2]).reshape(shape), axes)
    mine = lmesh.model_mesh(shape, axes, "cpu")
    for logical in ("batch", "fsdp", "expert", "model", "seq_kv",
                    "seq_data", "seq_all", "nothing", None):
        assert sharding._axes(mine, logical) == jsharding._axes(jm, logical)


def test_placement_guards_divisibility_and_first_taker():
    mesh = lmesh.model_mesh((2, 4), ("data", "model"), "cpu")
    assert sharding.placement((8, 12, 5), "batch", "model", None,
                              mesh=mesh) == ("data", "model", None)
    # kv heads 2 do not divide 4: replicated; batch 3 does not divide 2
    assert sharding.placement((3, 16, 2, 8), "batch", None, "model", None,
                              mesh=mesh) == (None, None, None, None)
    # 'model' goes to the first dim that takes it
    assert sharding.placement((4, 8), "model", "seq_kv",
                              mesh=mesh) == ("model", None)
    pod = lmesh.model_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    assert sharding.placement((8, 4), "batch", "model", mesh=pod) == \
        (("pod", "data"), "model")


@pytest.mark.parametrize("spec", [(("pod", "data"), "model"),
                                  ("model", ("pod", "data")),
                                  (None, "data"), ("pod", None), ()])
def test_placed_round_trip(spec):
    mesh = lmesh.model_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    placed = sharding.place(x, spec, mesh, copy=True)
    assert torch.equal(placed.full(), x)
    for i, p in enumerate(placed.parts):
        assert torch.equal(p, x[sharding.local_slices(x.shape, spec, mesh,
                                                      i)])
        assert p.is_contiguous()
    # row-major shard order: shard 5 is (pod 1, data 0, model 1)
    assert sharding.coords(mesh, 5) == {"pod": 1, "data": 0, "model": 1}
    if spec == (("pod", "data"), "model"):
        assert torch.equal(placed.parts[5], x[4:6, 6:12])


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_all_sum_in_shard_order_and_replicas_bit_identical():
    mesh = lmesh.model_mesh((2, 3), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        parts = [torch.randn(4, 7, generator=g).to(dtype) * 10 ** i
                 for i in range(6)]
        out = sharding.all_sum(parts, mesh, "model")
        for block in ((0, 1, 2), (3, 4, 5)):
            acc = parts[block[0]].float()
            for j in block[1:]:
                acc = acc + parts[j].float()
            for i in block:
                assert out[i].dtype == dtype
                assert torch.equal(out[i], acc.to(dtype))
                assert torch.equal(out[i], out[block[0]])
    # over 'data' the groups are the columns
    out = sharding.all_sum([torch.full((2,), float(i)) for i in range(6)],
                           mesh, "data")
    assert [float(t[0]) for t in out] == [3, 5, 7, 3, 5, 7]


def test_all_gather_and_gather_axes():
    mesh = lmesh.model_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.arange(4 * 6.0).reshape(4, 6)
    placed = sharding.place(x, ("model", "data"), mesh)
    parts, left = sharding.gather_axes(placed.parts, placed.spec, mesh,
                                       ("data",))
    assert left == ("model", None)
    assert torch.equal(parts[0], x[:2]) and torch.equal(parts[3], x[2:])
    parts, left = sharding.gather_axes(placed.parts, placed.spec, mesh,
                                       ("data", "model"))
    assert left == (None, None)
    assert all(torch.equal(p, x) for p in parts)


@pytest.mark.parametrize("batch_entry", [None, "data"])
def test_argmax_across_vocab_shards_breaks_ties_to_the_lower_index(
        batch_entry):
    mesh = lmesh.model_mesh((2, 4), ("data", "model"), "cpu")
    v = 16
    logits = torch.zeros(4, v)
    logits[0, [3, 9]] = 5.0             # a tie across shards: 3 wins
    logits[1, [13, 14]] = 7.0           # a tie inside a shard: 13 wins
    logits[2, 15] = 9.0                 # past the limit: left out
    logits[2, 6] = 1.0
    logits[3] = -1.0                    # all equal: index 0
    placed = sharding.place(logits, (batch_entry, "model"), mesh)
    got = sharding.argmax(placed, 15)
    want = torch.where(torch.arange(v) < 15, logits, float("-inf")).argmax(-1)
    assert got.tolist() == want.tolist() == [3, 13, 6, 0]


# ---------------------------------------------------------------------------
# elastic: remesh, reshard_restore, restore(shardings=)
# ---------------------------------------------------------------------------

def test_remesh_over_device_lists():
    for n, pref in ((8, 4), (8, 16), (6, 16), (16, 16), (7, 4), (1, 16)):
        mesh = elastic.remesh(devices=["cpu"] * n, model_pref=pref)
        assert mesh.shape == jelastic.best_grid(n, pref)
        assert mesh.axis_names == ("data", "model")
        assert mesh.size == n and mesh.devices == (CPU,) * n


def test_remesh_needs_live_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        elastic.remesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = elastic.remesh(model_pref=4)
    assert mesh.shape == (2, 4)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(8))


def _leaves_equal(sp, tree):
    """Every leaf of a placed model, gathered, equal to the tree's."""
    got = convert.lm_params_to_numpy(specs.gather_params(sp, "cpu"))
    flat_got = dict(convert._flatten(got))
    flat_want = dict(convert._flatten(tree))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], np.asarray(v), err_msg=k)


def test_elastic_reshard_roundtrip(tmp_path):
    """The reference's test on the port: checkpoint on a 4x2 mesh,
    elastic-restart into a 2x4 mesh of the same eight (CPU) shards."""
    cfg = registry.reduced_arch("granite-3-2b").replace(dtype="float32")
    mesh_a = lmesh.model_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    params = specs.place_params(
        lm.init_params(torch.Generator().manual_seed(0), cfg), cfg, mesh_a)
    tree = convert.lm_params_to_numpy(specs.gather_params(params, "cpu"))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(7, tree)

    mesh_b = elastic.remesh(devices=["cpu"] * 8, model_pref=4)
    assert mesh_b.shape == (2, 4)
    restored = elastic.reshard_restore(ckpt, tree, mesh_b, cfg, step=7)
    assert isinstance(restored, specs.ShardedLM) and restored.mesh == mesh_b
    _leaves_equal(restored, tree)
    # restored leaves actually live on the new mesh, cut by its placements
    want = dict(convert._flatten(specs.param_shardings(cfg, mesh_b)))
    assert want.keys() == restored.specs.keys()
    for key, sh in want.items():
        assert sh.mesh == mesh_b and restored.specs[key] == sh.spec
        for shard in restored.shards:
            assert tuple(shard[key].shape) == sharding.local_shape(
                restored.shapes[key], sh.spec, mesh_b), key
    # leaves restored placed save whole, and go back onto the first mesh
    placed = ckpt.restore(tree, step=7,
                          shardings=specs.param_shardings(cfg, mesh_b))
    assert isinstance(placed["embed"]["table"], sharding.Placed)
    ckpt.save(8, placed)
    back = elastic.reshard_restore(ckpt, tree, mesh_a, cfg, step=8)
    _leaves_equal(back, tree)


def test_restore_with_shardings_places_every_leaf(tmp_path):
    mesh = lmesh.model_mesh((2, 2), ("data", "model"), "cpu")
    ckpt = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(24.0).reshape(4, 6), "b": torch.arange(4.0)}
    ckpt.save(1, tree)
    sh = {"w": sharding.NamedSharding(mesh, ("data", "model")),
          "b": sharding.NamedSharding(mesh, ())}
    got = ckpt.restore(tree, step=1, shardings=sh)
    assert isinstance(got["w"], sharding.Placed)
    assert tuple(got["w"].parts[3].shape) == (2, 3)
    assert torch.equal(got["w"].full(), tree["w"])
    assert torch.equal(got["b"].parts[2], tree["b"])
    # a placed leaf saves whole
    ckpt.save(2, {"w": got["w"], "b": got["b"]})
    again = ckpt.restore(tree, step=2, device="cpu")
    assert torch.equal(again["w"], tree["w"])
    with pytest.raises(ValueError):
        ckpt.restore(tree, step=1, shardings={"w": sh["w"]})


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_reference_sharded_checkpoint_restores_onto_a_port_mesh(tmp_path,
                                                                shape):
    """The reference places its params on its (1, 2) CPU mesh and saves
    them; the port restores the checkpoint onto its own mesh, each leaf cut
    by the port's placements and every leaf equal."""
    jcfg = jregistry.reduced_arch("granite-3-2b")
    jm = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    with jsharding.use_mesh(jm):
        jparams = jax.device_put(jlm.init_params(jax.random.PRNGKey(0), jcfg),
                                 jspecs.param_shardings(jcfg, jm))
    JCheckpointer(str(tmp_path)).save(3, jparams)
    host = jax.device_get(jparams)

    cfg = registry.reduced_arch("granite-3-2b").replace(dtype="float32")
    mesh = lmesh.model_mesh(shape, ("data", "model"), "cpu")
    restored = elastic.reshard_restore(Checkpointer(str(tmp_path)), host,
                                       mesh, cfg, step=3)
    _leaves_equal(restored, host)
    # straight from the host arrays too
    direct = convert.lm_params_to_mesh(cfg, host, mesh)
    for key in direct.specs:
        for a, b in zip(direct.placed(key).parts,
                        restored.placed(key).parts):
            assert torch.equal(a, b), key


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b", "gemma2-9b",
                                  "stablelm-12b", "deepseek-moe-16b"])
def test_multi_pod_mesh_serves_as_one_device(arch):
    """The reference's ('pod', 'data', 'model') shape: the batch over pod
    x data, the parameters replicated over 'pod'; float32 prefill and 2
    decode steps within 1e-4 of the one-device model, for each dense and
    MoE arch's flags (gemma2's post-norms, alternating windows and
    softcaps; stablelm's; deepseek's shared experts)."""
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = lmesh.make_mesh(MeshConfig(multi_pod=True, pods=2, data=2,
                                      model=2), devices="cpu")
    sp = specs.place_params(params, cfg, mesh)
    toks = torch.randint(0, cfg.vocab_size, (4, 10),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    want, wc, wp = lm.prefill(params, cfg, {"tokens": toks[:, :8]}, 12)
    got, gc, gp = lm.prefill(sp, cfg, {"tokens": toks[:, :8]}, 12)
    assert got.spec == (("pod", "data"), "model")
    for t in (8, 9):
        torch.testing.assert_close(got.full(), want, rtol=1e-4, atol=1e-4)
        pos = torch.full((4,), t, dtype=torch.int32)
        want, wc = lm.decode_step(params, cfg, toks[:, t: t + 1], wc, pos)
        got, gc = lm.decode_step(sp, cfg, toks[:, t: t + 1], gc, pos)
    torch.testing.assert_close(got.full(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gc.k.full(), wc.k, rtol=1e-4, atol=1e-4)


def test_serve_production_mesh_flag(monkeypatch, capsys):
    """`launch.serve --production-mesh`: refused on a node of fewer than
    256 cards; with --device, all 256 shards on that device."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--production-mesh", "--requests",
                      "2", "--decode-steps", "2", "--corpus", "512",
                      "--concurrent-inserts", "32"])
    assert "model placed on the mesh data=16xmodel=16" in \
        capsys.readouterr().out
    assert out["turns"][0]["tokens"].shape == (2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(RuntimeError, match="256"):
        serve.main(["--production-mesh"])
