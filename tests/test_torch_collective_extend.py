"""The mesh dry run extended through its layer stacks equals the unrolled
trace (every arch's reduced decode step, on the port mesh (1, 4) of meta
devices, cut to 1 and 2 trips and extended to 3; the train steps in
`test_torch_collective_extend_train.py`), and the records it makes: collective bytes by kind,
raw bytes and ops, the per-device argument bytes equal to
`dryrun.argument_bytes_per_device`'s formula, `h100x1` records as before,
`profile --what collectives` summing to the total, and the roofline's
collective term charged at NVLink's rate."""
import pytest

from repro_torch.configs import registry
from repro_torch.configs.base import H100, ShapeConfig
from repro_torch.launch import dryrun, op_analysis, profile, roofline
from repro_torch.models import api, attention, specs
from test_torch_mesh_serving import one_thread  # noqa: F401

MESH = {"data": 1, "model": 4}
TRIPS = 3


def _deeper(cfg):
    return dryrun.cut(cfg, {a: TRIPS for a in dryrun.layer_axes(cfg)})


def _same(a, b) -> None:
    for f in ("collective_wire", "collective_raw", "collective_ops",
              "collective_by_module", "dot_flops", "hbm_bytes_est",
              "n_ops", "by_shard", "device_shard"):
        assert getattr(a, f) == getattr(b, f), f


def check_extended(kind: str, arch: str) -> None:
    cfg = _deeper(registry.reduced_arch(arch))
    shape = ShapeConfig("e", kind, 32, 4)
    mesh = dryrun.meta_mesh(MESH)
    got, n = dryrun.trace_cell(cfg, shape, mesh=mesh)
    assert dryrun.MESH_LO == 1
    want, _ = dryrun.trace_cell(cfg, shape, mesh=mesh, unrolled=True)
    _same(got, want)
    assert got.collective_wire
    # gemma2's pairs of 2 and 4 layers cut the stacked MLP's layer axis
    # over 'model' = 4 at one corner: traced unrolled instead
    if cfg.alt_local_global and cfg.sliding_window:
        assert n == 1
    else:
        assert n >= 2


@pytest.mark.parametrize("arch", registry.list_archs())
def test_decode_extended_equals_unrolled(arch, one_thread):
    check_extended("decode", arch)


@pytest.fixture(scope="module")
def records():
    """granite's reduced steps, 4 layers (the stacked MLP cut over 'model'
    by layers), on (2, 4): the records as `run_cell` makes them."""
    cfg = registry.reduced_arch("granite-3-2b").replace(num_layers=4)
    mesh = dryrun.meta_mesh({"data": 2, "model": 4})
    out = {}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("r", kind, 64, 4)
        counts, _ = dryrun.trace_cell(cfg, shape, mesh=mesh)
        rec = dryrun.analyze(counts, cfg, shape, mesh)
        rec["argument_bytes_per_device"] = {
            "data=2xmodel=4": dryrun.argument_bytes_per_device(
                cfg, shape, {"data": 2, "model": 4})}
        out[kind] = rec
    return out


def test_mesh_records(records, one_thread):
    for kind, rec in records.items():
        assert rec["mesh"] == "data=2xmodel=4" and rec["n_devices"] == 8
        roll = rec["hlo_rollup_per_device"]
        assert roll["collective_bytes"] and set(roll["collective_bytes"]) \
            == set(roll["collective_raw_bytes"]) == set(roll["collective_ops"])
        assert roll["collective_bytes_total"] == sum(
            roll["collective_bytes"].values())
        # the traced per-device argument bytes are the formula's, but for
        # a decode step's K/V cache: with 2 kv heads on 4 'model' shards
        # the reference's placement cuts the sequence over 'model' (its
        # 'seq_kv' policy, `specs.cache_specs`), the port's caches hold
        # every position on each 'model' shard (`attention.kv_placement`)
        extra = _cache_gap(kind)
        assert extra > 0 if kind == "decode" else extra == 0
        assert rec["memory_analysis"]["argument_size_in_bytes"] == \
            rec["argument_bytes_per_device"]["data=2xmodel=4"] + extra, kind
        assert 0 <= rec["per_device"]["shard"] < 8
        rows = profile.attribute(rec, "collectives")
        assert sum(b for b, _, _ in rows) == pytest.approx(
            roll["collective_bytes_total"], rel=1e-12)
        t = roofline.terms(rec, H100)
        assert t["collective_s"] == roll["collective_bytes_total"] / \
            H100.ici_bandwidth
        assert t["model_flops_per_dev"] == rec["model_flops_total"] / 8


def _cache_gap(kind: str) -> int:
    """The decode cache's bytes a device holds under the port's placement
    less under the reference's (0 for the other steps)."""
    if kind != "decode":
        return 0
    cfg = registry.reduced_arch("granite-3-2b").replace(num_layers=4)
    sizes = {"data": 2, "model": 4}
    _, caches, _ = api.decode_inputs_specs(cfg, ShapeConfig("r", kind, 64, 4))
    ref = specs.cache_specs(cfg, sizes, caches)
    mesh = dryrun.meta_mesh(sizes)
    return sum(
        specs.shard_bytes(op_analysis.nbytes(t), attention.kv_placement(
            mesh, t.shape), sizes) - specs.shard_bytes(
            op_analysis.nbytes(t), ref[path], sizes)
        for path, t in specs.cache_leaves(caches))


def test_one_card_records_keep_their_keys():
    rec = dryrun.run_cell("granite-3-2b", "decode_32k")
    roll = rec["hlo_rollup_per_device"]
    assert rec["mesh"] == "h100x1" and rec["n_devices"] == 1
    assert roll["collective_bytes"] == {}
    assert roll["collective_bytes_total"] == 0.0
    assert "collective_raw_bytes" not in roll and "per_device" not in rec
    assert profile.attribute(rec, "collectives") == []
    assert roofline.terms(rec)["collective_s"] == 0.0
