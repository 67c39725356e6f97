"""The collectives' counter (`repro_torch.models.sharding.
CollectiveCounter`) against the reference's ring formulas, and the dry
run's collective bytes against the counter of the live step.

The reference's formulas live in ``hlo_analysis.parse``: each collective
op of a made-up HLO module goes through its ``rollup`` and is held against
`sharding.wire_bytes` and the counter's raw bytes, kind by kind.  Then
for every arch's reduced decode step (this file) and train step
(`test_torch_collective_bytes_train.py`) on port meshes (2, 2) and (1, 4)
of "cpu": `dryrun.trace_cell` over a mesh of meta devices records the
same wire bytes, kind for kind (exact fractions), as a
`CollectiveCounter` around the same step run on the CPU mesh.
"""
import pytest
import torch

from repro.launch import hlo_analysis
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as lmesh
from repro_torch.models import lm, sharding, specs
from repro_torch.serving import serve_step
from test_torch_mesh_serving import one_thread  # noqa: F401

ARCHS = registry.list_archs()
MESHES = [(2, 2), (1, 4)]
BATCH, SEQ = 4, 32

_OPS = {   # kind: (in elems, out elems, HLO attributes)
    "all-gather": (1024, None, "dimensions={0}"),
    "reduce-scatter": (None, 1024, "dimensions={0}, to_apply=%add"),
    "all-reduce": (1024, 1024, "to_apply=%add"),
    "all-to-all": (1024, 1024, "dimensions={0}"),
    "collective-permute": (1024, 1024, ""),
}


def _module(kind: str, n: int) -> tuple:
    """(a one-op HLO module, bytes in, bytes out) of `kind` over groups of
    `n` of 8 devices (f32)."""
    i, o, attrs = _OPS[kind]
    i = i if i is not None else 1024 * n
    o = o if o is not None else 1024 * n
    groups = ("source_target_pairs={{0,1},{1,0}}"
              if kind == "collective-permute"
              else f"replica_groups=[{8 // n},{n}]<=[8]")
    text = f"""HloModule m, entry_computation_layout={{(f32[{i}]{{0}})->f32[{o}]{{0}}}}

ENTRY %main (p0: f32[{i}]) -> f32[{o}] {{
  %p0 = f32[{i}]{{0}} parameter(0)
  ROOT %c = f32[{o}]{{0}} {kind}(f32[{i}]{{0}} %p0), channel_id=1, {groups}, {attrs}
}}
"""
    return text, 4 * i, 4 * o


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", sharding.KINDS)
def test_ring_formulas_are_the_references(kind, n):
    text, in_b, out_b = _module(kind, n)
    roll = hlo_analysis.rollup(text)
    counter = sharding.CollectiveCounter()
    counter.record_collective(kind, 2 if kind == "collective-permute" else n,
                              in_b, out_b, "x")
    assert counter.bytes() == roll["collective_bytes"]
    assert {k: float(v) for k, v in counter.raw.items()} == \
        roll["collective_raw_bytes"]
    assert counter.ops == {kind: 1}


def test_counting_is_off_without_a_counter_and_changes_no_value():
    mesh = lmesh.model_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 8, generator=g) for _ in range(4)]
    plain = sharding.all_sum(parts, mesh, "model")
    gathered = sharding.all_gather(parts, mesh, "data", 0)
    assert not sharding._RECORDERS
    with sharding.CollectiveCounter() as c, sharding.scope("here"):
        counted = sharding.all_sum(parts, mesh, "model")
        again = sharding.all_gather(parts, mesh, "data", 0)
        sharding.all_sum(parts[:1], lmesh.model_mesh(
            (1, 1), ("data", "model"), "cpu"), "model")   # one shard: none
    assert not sharding._RECORDERS
    assert all(torch.equal(a, b) for a, b in zip(plain, counted))
    assert all(torch.equal(a, b) for a, b in zip(gathered, again))
    assert c.ops == {"all-reduce": 1, "all-gather": 1}
    # one device's bytes: 3 x 8 f32 in; 2 x in x 1/2, out x 1/2
    assert c.bytes() == {"all-gather": 96.0, "all-reduce": 96.0}
    assert set(c.by_path) == {"here"}


def _mesh_sizes(shape):
    return dict(zip(("data", "model"), shape))


def dry_bytes(cfg, kind: str, shape) -> dict:
    counts, _ = dryrun.trace_cell(cfg, ShapeConfig("c", kind, SEQ, BATCH),
                                  mesh=dryrun.meta_mesh(_mesh_sizes(shape)))
    assert counts.device_shard >= 0
    return counts.collective_wire


def live_decode_bytes(cfg, shape) -> dict:
    """A `CollectiveCounter` around one decode step (and its greedy token)
    on the CPU mesh, after the dry run's one-token prefill to SEQ."""
    mesh = lmesh.model_mesh(shape, ("data", "model"), "cpu")
    sp = specs.place_params(lm.init_params(torch.Generator().manual_seed(0),
                                           cfg), cfg, mesh)
    tok = torch.zeros((BATCH, 1), dtype=torch.int32)
    batch = {"tokens": tok}
    if cfg.is_encdec:
        batch["src_emb"] = torch.zeros(BATCH, SEQ // 2, cfg.d_model)
    with sharding.use_mesh(mesh):
        _, caches, pos = lm.prefill(sp, cfg, batch, SEQ)
        with sharding.CollectiveCounter() as c:
            logits, _ = lm.decode_step(sp, cfg, tok, caches, pos)
            serve_step.greedy(logits, cfg.vocab_size)
    return c.wire


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_dry_run_bytes_equal_the_live_step(arch, shape, one_thread):
    cfg = registry.reduced_arch(arch)
    want = live_decode_bytes(cfg, shape)
    assert want                # every reduced arch sums over 'model'
    assert dry_bytes(cfg, "decode", shape) == want


def test_a_dry_run_counts_a_collective_from_its_record():
    """Over a mesh of meta devices a collective's own adds and copies are
    not a device's work: each member's device is charged the bytes the
    collective reads and writes there (an op ``collective``), and its out
    is its shard's, so the op after it is charged to that shard."""
    from repro_torch.launch import op_analysis
    mesh = dryrun.meta_mesh({"data": 1, "model": 2})
    x = sharding.Placed(tuple(torch.empty(3, 8, device="meta")
                              for _ in range(2)), (None, None), mesh, (3, 8))

    def step(x):
        return [2 * t for t in sharding.all_sum(x.parts, mesh, "model")]

    counter = op_analysis.OpCounter(mesh)
    with sharding.use_mesh(mesh):
        counter.run(step, x)
    assert set(counter.counts.shards) == {0, 1}
    for c in counter.counts.shards.values():
        assert c.hbm_by_op["collective"] == 2 * 3 * 8 * 4   # in + out
        assert set(c.hbm_by_op) == {"collective", "aten.mul"}
        assert c.n_ops == 2
    assert counter.counts.collective_ops == {"all-reduce": 1}
