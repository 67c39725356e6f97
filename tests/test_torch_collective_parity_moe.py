"""`test_torch_collective_parity.py`'s parity for olmoe-1b-7b (expert
parallel over 'model'): its reduced train and decode steps (f32, 4 x 256
tokens) on the (1, 2), (2, 1) and (2, 4) meshes in both packages, pinned
cell by cell; the decode steps' forward sums over 'model' (the experts'
included) equal, and every other difference of a kind's bytes named."""
import pytest

from test_torch_collective_parity import (CELLS, FSDP_GRADS, GRADS, GREEDY,
                                          LOOKUP, MIXED, REGATHER, Both,
                                          check_causes, check_pinned,
                                          check_same_collectives)
from test_torch_mesh_serving import one_thread  # noqa: F401

ARCH = "olmoe-1b-7b"

PINNED = {
    "train 1x2": ({"all-gather": 32768.0, "all-reduce": 8417836.0},
                  {"all-gather": 86.0, "all-reduce": 5270528.0,
                   "collective-permute": 40960.0}),
    "decode 1x2": ({"all-gather": 96.0, "all-reduce": 10272.0},
                   {"all-reduce": 10288.0, "collective-permute": 192.0}),
    "train 2x1": ({"all-gather": 2267136.0, "all-reduce": 3284076.0,
                   "all-to-all": 262144.0},
                  {"all-gather": 1640606.0, "all-reduce": 3072.0,
                   "reduce-scatter": 1640448.0}),
    "decode 2x1": ({"all-gather": 991528.0, "all-to-all": 1536.0},
                   {"all-gather": 1640528.0}),
    "train 2x4": ({"all-gather": 1607680.0, "all-reduce": 6187530.0,
                   "all-to-all": 262144.0, "collective-permute": 137216.0,
                   "reduce-scatter": 98304.0},
                  {"all-gather": 461277.5, "all-reduce": 4054272.0,
                   "collective-permute": 10240.0,
                   "reduce-scatter": 460800.0}),
    "decode 2x4": ({"all-gather": 265992.0, "all-reduce": 15160.0,
                    "all-to-all": 512.0, "collective-permute": 33792.0},
                   {"all-gather": 460880.0, "all-reduce": 7716.0,
                    "collective-permute": 48.0}),
}

ROUTER = ("routing: GSPMD cuts the router's logits by experts over "
          "'model', gathers them for the top-k and sums the gates "
          "(all-gather, all-reduce); the port routes each data block on "
          "its first shard with the router whole and hands each expert "
          "shard its experts' slice (collective-permute)")
EXPERTS = ("GSPMD gathers the experts' activations over 'data' in place "
           "of their down-projection's weights, and the token's K/V rows "
           "for the cache update; the port gathers every weight leaf")

CAUSES = {
    ("train 1x2", "all-gather"): ROUTER,
    ("train 1x2", "collective-permute"): ROUTER,
    ("train 1x2", "all-reduce"): GRADS,
    ("decode 1x2", "all-gather"): GREEDY + "; " + ROUTER,
    ("decode 1x2", "all-reduce"): GREEDY + "; " + ROUTER,
    ("decode 1x2", "collective-permute"): ROUTER,
    ("train 2x1", "all-gather"): REGATHER + "; " + EXPERTS,
    ("train 2x1", "all-reduce"): FSDP_GRADS,
    ("train 2x1", "reduce-scatter"): FSDP_GRADS,
    ("train 2x1", "all-to-all"): LOOKUP,
    ("decode 2x1", "all-gather"): EXPERTS,
    ("decode 2x1", "all-to-all"): LOOKUP,
    ("train 2x4", "all-gather"): MIXED,
    ("train 2x4", "all-reduce"): GRADS,
    ("train 2x4", "reduce-scatter"): FSDP_GRADS,
    ("train 2x4", "all-to-all"): LOOKUP,
    ("train 2x4", "collective-permute"): MIXED + "; " + ROUTER,
    ("decode 2x4", "all-gather"): MIXED,
    ("decode 2x4", "all-reduce"): MIXED,
    ("decode 2x4", "all-to-all"): LOOKUP,
    ("decode 2x4", "collective-permute"): MIXED + "; " + ROUTER,
}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return Both(ARCH, tmp_path_factory.mktemp("reference"))


@pytest.mark.parametrize("cell", CELLS)
def test_bytes_pinned(both, cell, one_thread):
    check_pinned(both, PINNED, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_gap_named(both, cell):
    check_causes(both, PINNED, CAUSES, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_same_collectives_equal(both, cell):
    check_same_collectives(both, cell, fsdp=False)
