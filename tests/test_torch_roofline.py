"""The pure-Python parts of the port's dry-run tooling against the
reference's: `launch.roofline` on one record, `models.specs` placements on
the reference's meshes, `launch.profile` sums; and the per-arch config
modules."""
import dataclasses
import importlib
import types

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.launch import roofline as jroofline
from repro.models import specs as jspecs
from repro_torch import convert
from repro_torch.configs import base, registry
from repro_torch.launch import profile, roofline
from repro_torch.models import api, specs

RECORD = {
    "arch": "granite-3-2b", "shape": "decode_32k", "kind": "decode",
    "mesh": "h100x1", "n_devices": 1, "tokens_per_step": 128,
    "params": 2537553920, "active_params": 2537553920,
    "model_flops_total": 2.0 * 2537553920 * 128,
    "memory_analysis": {"argument_size_in_bytes": 3.4867e11,
                        "output_size_in_bytes": 3.436e11,
                        "alias_size_in_bytes": 3.436e11,
                        "temp_size_in_bytes": 1.88e10,
                        "peak_memory_in_bytes": 3.6747e11},
    "hlo_rollup_per_device": {"dot_flops": 2.0243e12,
                              "collective_bytes": {},
                              "collective_bytes_total": 0.0,
                              "hbm_bytes_est": 3.3369e12,
                              "hbm_bytes_lower": 6.9e11,
                              "hbm_by_op": {}},
    "by_module": {"blocks.*": {"dot_flops": 1.0e12, "hbm_bytes": 3.0e12,
                               "ops": 7},
                  "blocks.*.mlp": {"dot_flops": 1.0243e12,
                                   "hbm_bytes": 3.369e11, "ops": 5}},
    "status": "ok",
}


def _hw_pair():
    """The port's H100 and the reference's class holding the same
    numbers."""
    h = base.H100
    return h, jbase.HardwareConfig(**dataclasses.asdict(h))


def test_hardware_config_is_one_h100():
    h = base.H100
    assert (h.peak_flops_bf16, h.hbm_bandwidth, h.hbm_bytes,
            h.ici_bandwidth) == (989e12, 3.35e12, 80e9, 450e9)


@pytest.mark.parametrize("rec", [
    RECORD,
    dict(RECORD, shape="train_4k", kind="train",
         hlo_rollup_per_device=dict(RECORD["hlo_rollup_per_device"],
                                    dot_flops=2.5287e16,
                                    hbm_bytes_est=1.3745e15)),
    dict(RECORD, mesh="pod1", n_devices=256,
         hlo_rollup_per_device=dict(RECORD["hlo_rollup_per_device"],
                                    collective_bytes={"all-reduce": 3e9,
                                                      "all-gather": 1e9})),
], ids=["decode", "train", "reference-record"])
def test_roofline_terms_equal_the_reference(rec):
    """Same record, same hardware numbers: every term within 1e-12."""
    hw, jhw = _hw_pair()
    mine, ref = roofline.terms(rec, hw), jroofline.terms(rec, jhw)
    assert set(mine) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert mine[k] == pytest.approx(v, rel=1e-12, abs=0), k
        else:
            assert mine[k] == v, k


def test_roofline_table_and_markdown(tmp_path):
    hw, jhw = _hw_pair()
    recs = [RECORD,
            {"arch": "granite-3-2b", "shape": "long_500k", "mesh": "h100x1",
             "status": "skipped", "reason": "quadratic"},
            {"arch": "granite-3-2b", "shape": "train_4k", "mesh": "h100x1",
             "status": "FAILED", "error": "boom"}]
    mine, ref = roofline.table(recs, hw), jroofline.table(recs, jhw)
    assert len(mine) == len(ref) == 3
    assert mine[1:] == ref[1:]
    assert mine[0] == pytest.approx(ref[0], rel=1e-12)
    md = roofline.markdown(mine)
    assert "skipped: quadratic" in md and "FAILED" in md
    assert md.splitlines()[2].endswith("| no |")       # 367 GB > 80 GB
    import json
    for r in recs:
        (tmp_path / f"{r['arch']}__{r['shape']}__h100x1.json").write_text(
            json.dumps(r))
    (tmp_path / "x__y__pod1.json").write_text(json.dumps(RECORD))
    assert len(roofline.load_records(str(tmp_path))) == 3
    assert len(roofline.load_records(str(tmp_path), None)) == 4


def test_profile_attribute_sums_to_the_record():
    rows = profile.attribute(RECORD, "hbm")
    assert [r[2] for r in rows] == ["blocks.*", "blocks.*.mlp"]
    assert sum(r[0] for r in rows) == pytest.approx(
        RECORD["hlo_rollup_per_device"]["hbm_bytes_est"], rel=1e-12)
    assert profile.attribute(RECORD, "collectives") == []
    with pytest.raises(ValueError):
        profile.attribute(RECORD, "flops")


def test_profile_attribute_of_a_dry_run_cell():
    rec = profile.dryrun.run_cell("granite-3-2b", "decode_32k")
    rows = profile.attribute(rec, "hbm")
    assert sum(b for b, _, _ in rows) == \
        rec["hlo_rollup_per_device"]["hbm_bytes_est"]
    assert sum(d["dot_flops"] for d in rec["by_module"].values()) == \
        rec["hlo_rollup_per_device"]["dot_flops"]
    assert {"blocks.*", "blocks.*.mlp", "(step)"} <= {p for _, _, p in rows}


# ---------------------------------------------------------------------------
# (g) placements on the reference's meshes, every leaf of all ten archs
# ---------------------------------------------------------------------------

def _stand_in_mesh(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_param_specs_equal_the_reference(multi_pod):
    """At full width: each port leaf's placement is the reference's for
    its stacked leaf without the layer axis (which no rule places)."""
    sizes = specs.mesh_sizes(multi_pod)
    for arch in registry.list_archs():
        ref = jspecs.param_specs(jregistry.get_arch(arch),
                                 _stand_in_mesh(sizes))
        flat = dict(convert._flatten(jax.tree.map(
            tuple, ref,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
        mine = specs.param_specs(registry.get_arch(arch), sizes)
        for name, got in mine.items():
            group, _, rest = name.partition(".")
            if group in specs.STACKS:
                want = flat[f"{group}.{rest.partition('.')[2]}"]
                if want:
                    assert want[0] is None, (arch, name)
                    want = want[1:]
            else:
                want = flat[name]
            assert got == tuple(want), (arch, name)
        stacked = {k for k in flat if k.partition(".")[0] in specs.STACKS}
        assert stacked == {f"{n.partition('.')[0]}."
                           f"{n.split('.', 2)[2]}"
                           for n in mine if n.partition(".")[0]
                           in specs.STACKS}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_cache_specs_equal_the_reference(multi_pod):
    """Every cache leaf of the decode_32k and long_500k caches (B = 128
    and B = 1: the sequence-sharded branch) of every arch."""
    from repro.models import api as japi
    sizes = specs.mesh_sizes(multi_pod)
    mesh = _stand_in_mesh(sizes)
    for arch in registry.list_archs():
        for shape_name in ("decode_32k", "long_500k"):
            shape = registry.get_shape(shape_name)
            jshape = jregistry.get_shape(shape_name)
            _, caches, _ = api.decode_inputs_specs(registry.get_arch(arch),
                                                   shape)
            _, jcaches, _ = japi.decode_inputs_specs(
                jregistry.get_arch(arch), jshape)
            ref = jspecs.cache_specs(jregistry.get_arch(arch), mesh, jcaches)
            flat = _named(ref)
            mine = specs.cache_specs(registry.get_arch(arch), sizes, caches)
            assert mine == flat, (arch, shape_name)


def _named(tree, prefix=""):
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_named(getattr(tree, f), f"{prefix}{f}."))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(tree)}


def test_mlp_and_moe_specs_equal_the_reference():
    from repro.models import layers as jlayers
    from repro.models import moe as jmoe
    from repro_torch.models import layers, moe
    assert layers.mlp_specs() == jlayers.mlp_specs()
    for arch in ("olmoe-1b-7b", "deepseek-moe-16b"):
        assert moe.moe_specs(registry.get_arch(arch)) == \
            jmoe.moe_specs(jregistry.get_arch(arch))


def test_shard_bytes_and_batch_spec():
    sizes = specs.mesh_sizes(True)
    assert specs.batch_spec(sizes, (64, 7)) == (("pod", "data"), None)
    assert specs.batch_spec(sizes, (1, 7)) == (None, None)
    assert specs.shard_bytes(1024, (("pod", "data"), "model"), sizes) == 2
    assert specs.shard_bytes(1024, (), sizes) == 1024


# ---------------------------------------------------------------------------
# the per-arch config modules
# ---------------------------------------------------------------------------

MODULES = ("deepseek_moe_16b", "gemma2_27b", "gemma2_9b", "granite_3_2b",
           "olmoe_1b_7b", "qwen2_vl_7b", "rwkv6_1_6b",
           "seamless_m4t_large_v2", "stablelm_12b", "zamba2_2_7b")


@pytest.mark.parametrize("name", MODULES)
def test_arch_config_module_equals_the_reference(name):
    mine = importlib.import_module(f"repro_torch.configs.{name}")
    ref = importlib.import_module(f"repro.configs.{name}")
    for attr in ("CONFIG", "REDUCED"):
        assert dataclasses.asdict(getattr(mine, attr)) == \
            dataclasses.asdict(getattr(ref, attr)), attr
    assert registry.get_arch(mine.CONFIG.name) == mine.CONFIG
