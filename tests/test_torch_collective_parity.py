"""The port's collective bytes against the reference's HLO rollup:
granite-3-2b's reduced train and decode steps (f32, 4 x 256 tokens) on
the (1, 2), (2, 1) and (2, 4) (data, model) meshes (olmoe-1b-7b's in
`test_torch_collective_parity_moe.py`).

The reference's steps are compiled by GSPMD over a ``jax.sharding.Mesh``
of eight CPU devices in a process of its own
(`tests/torch_collective_reference.py`), its bytes by ``rollup`` and by
op (``profile.attribute``); the port's are the dry run's over a mesh of
meta devices, by kind and by `sharding.scope` path.  Both packages' bytes
are pinned cell by cell.  They are equal where both compute the same
collective:
  * the forward sums over 'model' of a decode step (the attention's and
    the MLP's or experts' outputs, the vocab-cut embedding lookup);
  * granite's FSDP gathers of the weights over 'data' (a decode step's,
    and a train step's forward ones);
and every other difference of a kind's bytes is named in `CAUSES` (GSPMD
picks reshards of its own: all-to-all and collective-permute, gathers of
activations in place of weights, f32 all-reduces of whole FSDP gradients
where the port's transpose of a gather is a reduce-scatter).
"""
import json
import os
import re
import subprocess
import sys

import pytest

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from test_torch_mesh_serving import one_thread  # noqa: F401

ARCH = "granite-3-2b"
CELLS = [f"{k} {m}" for m in ("1x2", "2x1", "2x4") for k in ("train",
                                                              "decode")]
SEQ, BATCH = 256, 4
HERE = os.path.dirname(os.path.abspath(__file__))

# cell: (the reference's wire bytes by kind, the port's)
PINNED = {
    "train 1x2": ({"all-gather": 393216.0, "all-reduce": 8400928.0,
                   "all-to-all": 393216.0},
                  {"all-gather": 58.0, "all-reduce": 5265920.0,
                   "collective-permute": 786432.0}),
    "decode 1x2": ({"all-gather": 32.0, "all-reduce": 10240.0,
                    "all-to-all": 196608.0},
                   {"all-reduce": 10288.0, "collective-permute": 393216.0}),
    "train 2x1": ({"all-gather": 1705984.0, "all-reduce": 2230820.0,
                   "all-to-all": 262144.0},
                  {"all-gather": 1114186.0, "all-reduce": 2560.0,
                   "reduce-scatter": 1114112.0}),
    "decode 2x1": ({"all-gather": 1116200.0, "all-to-all": 512.0},
                   {"all-gather": 1114128.0}),
    "train 2x4": ({"all-gather": 1642496.0, "all-reduce": 6368840.0,
                   "all-to-all": 262144.0, "collective-permute": 133120.0},
                  {"all-gather": 328037.5, "all-reduce": 4050304.0,
                   "reduce-scatter": 327680.0}),
    "decode 2x4": ({"all-gather": 265816.0, "all-reduce": 15040.0,
                    "all-to-all": 512.0, "collective-permute": 32768.0},
                   {"all-gather": 327696.0, "all-reduce": 7716.0}),
}

LAYER_CUT = ("the reference reshards its stacked MLP leaves, whose layer "
             "axis is cut over 'model' (2 layers on 2 shards), by "
             "all-to-all inside its scan; the port's owner hands each "
             "reader its slice of the layer (collective-permute)")
GREEDY = ("the greedy token: the reference gathers each shard's (max, "
          "int32 index) pairs and reduces after (all-gather); the port "
          "all-reduces (max, int64 index) pairs, then gathers the batch "
          "blocks")
GRADS = ("gradients: GSPMD sums them over 'model' in f32 all-reduces of "
         "its own choosing (the transposes of its gathers and "
         "dynamic-slices); the port transposes each sum and gather it ran "
         "and sums replicated leaves' gradients (`replica_sum`)")
FSDP_GRADS = ("FSDP gradients: GSPMD all-reduces whole gradients over "
              "'data' (2 x in x (n-1)/n) and slices, the port's transpose "
              "of the gather is a reduce-scatter (in x (n-1)/n)")
REGATHER = ("GSPMD gathers the weights again for the backward, and the "
            "tied table for the unembedding; the port gathers each leaf "
            "once a step (no remat) and holds the table from the lookup")
LOOKUP = ("the embedding lookup: GSPMD reshards the FSDP-cut table by "
          "all-to-all; the port looks up in the gathered table")
MIXED = ("GSPMD's own reshards on a 2 x 4 mesh: collective-permutes and "
         "all-to-alls of slices, gathers of activations, sums of "
         "attention scores over 'data'")
CACHE = ("the K/V cache update: GSPMD gathers the token's K/V rows over "
         "'data' to scatter them; the port writes each block's rows on "
         "its shard")

# (cell, kind): why the kind's bytes differ between the packages
CAUSES = {
    ("train 1x2", "all-gather"): LAYER_CUT,
    ("train 1x2", "all-to-all"): LAYER_CUT,
    ("train 1x2", "collective-permute"): LAYER_CUT,
    ("train 1x2", "all-reduce"): GRADS,
    ("decode 1x2", "all-gather"): GREEDY,
    ("decode 1x2", "all-reduce"): GREEDY,
    ("decode 1x2", "all-to-all"): LAYER_CUT,
    ("decode 1x2", "collective-permute"): LAYER_CUT,
    ("train 2x1", "all-gather"): REGATHER,
    ("train 2x1", "all-reduce"): FSDP_GRADS,
    ("train 2x1", "reduce-scatter"): FSDP_GRADS,
    ("train 2x1", "all-to-all"): LOOKUP,
    ("decode 2x1", "all-gather"): CACHE,
    ("decode 2x1", "all-to-all"): LOOKUP,
    ("train 2x4", "all-gather"): MIXED,
    ("train 2x4", "all-reduce"): GRADS,
    ("train 2x4", "reduce-scatter"): FSDP_GRADS,
    ("train 2x4", "all-to-all"): LOOKUP,
    ("train 2x4", "collective-permute"): MIXED,
    ("decode 2x4", "all-gather"): MIXED,
    ("decode 2x4", "all-reduce"): MIXED,
    ("decode 2x4", "all-to-all"): LOOKUP,
    ("decode 2x4", "collective-permute"): MIXED,
}

# the reference's ops of the forward sums over 'model' (by op_name), and
# of the weights' gathers over 'data'
_SUMS = re.compile(r"(hkd->\.\.\.d|fd->\.\.\.d)/dot_general$|"
                   r"shard_map/psum$|^gather$")
_WEIGHTS = re.compile(r"dot_general$")
# the port's gathers of a leaf (its scope path: the leaf's name)
_LEAF = re.compile(r"^(embed\.table|head\.w|blocks\.\*\..+)$")


class Both:
    """One arch's cells in both packages: the reference's in a process of
    its own, started first, the port's traced meanwhile."""

    def __init__(self, arch: str, tmp):
        out = os.path.join(str(tmp), "reference.json")
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_collective_reference.py"),
             arch, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        cfg = registry.reduced_arch(arch).replace(dtype="float32")
        self.port = {}
        for cell in CELLS:
            kind, m = cell.split()
            sizes = dict(zip(("data", "model"), map(int, m.split("x"))))
            self.port[cell], _ = dryrun.trace_cell(
                cfg, ShapeConfig("p", kind, SEQ, BATCH),
                mesh=dryrun.meta_mesh(sizes))
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log.decode()[-3000:]
        with open(out) as f:
            self.ref = json.load(f)

    def port_wire(self, cell: str) -> dict:
        return {k: float(v) for k, v in
                self.port[cell].collective_wire.items()}

    def port_by_path(self, cell: str, kind: str, keep) -> float:
        return float(sum(d.get(kind, 0) for path, d in
                         self.port[cell].collective_by_module.items()
                         if keep(path)))

    def ref_wire(self, cell: str, kind: str, keep) -> float:
        """The reference's wire bytes of the ops of `kind` whose op_name
        `keep` takes (its out bytes times trips, by the ring formulas)."""
        total = 0.0
        for k, tag, out_b, n in self.ref[cell]["ops"]:
            if k == kind and keep(tag):
                total += out_b * (2 if kind == "all-reduce" else 1) * (
                    n - 1) / n
        return total


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return Both(ARCH, tmp_path_factory.mktemp("reference"))


def check_pinned(both: Both, pinned: dict, cell: str) -> None:
    ref, port = pinned[cell]
    assert both.ref[cell]["wire"] == ref
    assert both.port_wire(cell) == port


def check_causes(both: Both, pinned: dict, causes: dict, cell: str) -> None:
    """Every kind whose bytes differ between the packages has its named
    cause, and no cause is named for a kind that agrees."""
    ref, port = pinned[cell]
    differ = {k for k in set(ref) | set(port) if ref.get(k) != port.get(k)}
    assert differ == {k for c, k in causes if c == cell}


def check_same_collectives(both: Both, cell: str, fsdp: bool) -> None:
    kind, m = cell.split()
    data, model = map(int, m.split("x"))
    if kind == "decode" and model > 1:
        # the forward sums over 'model', bytes for bytes
        assert both.port_by_path(
            cell, "all-reduce", lambda p: p != "argmax") == both.ref_wire(
            cell, "all-reduce", lambda t: bool(_SUMS.search(t)) and
            "transpose" not in t)
    if data > 1 and model == 1:
        leaves = both.port_by_path(cell, "all-gather",
                                   lambda p: bool(_LEAF.match(p)))
        if kind == "train":
            # each leaf's gather and its transpose move the same bytes
            assert both.port_by_path(cell, "reduce-scatter",
                                     lambda p: True) == leaves
        if fsdp:
            assert leaves == both.ref_wire(
                cell, "all-gather", lambda t: bool(_WEIGHTS.search(t))
                and "transpose" not in t)


@pytest.mark.parametrize("cell", CELLS)
def test_bytes_pinned(both, cell, one_thread):
    check_pinned(both, PINNED, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_gap_named(both, cell):
    check_causes(both, PINNED, CAUSES, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_same_collectives_equal(both, cell):
    check_same_collectives(both, cell, fsdp=True)
