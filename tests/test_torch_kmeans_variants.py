"""Variant choice of the `kmeans_assign` kernel, on the CPU.

`kmeans_assign` has a ``wgmma`` variant (centroid stages through a TMA
ring, argmin folded from the accumulator, centroids split across clusters
when M is small) in two modes by depth (``resident``: a bf16 row tile held
for all of D, 2-block clusters; ``streamed``: 4-block clusters streaming
slabs of a 128-row tile) and a ``generic`` one.  The choice, the mode and
the split are pure functions of shapes, alignment and the card's SM count;
these tests pin them down, the order of the key that merges the blocks and
centroid slices, that CPU tensors still take the plain version, and that
an edited shared header rebuilds the kernel.
"""
import math
import re

import pytest
import torch

from repro_torch.configs.ame_paper import PAPER_1M
from repro_torch.kernels import build, ops, ref, scan_stream
from repro_torch.kernels import kmeans_assign as ka

A = 256          # a 16-byte-aligned address
C, D = PAPER_1M.n_clusters, PAPER_1M.dim
M_BUILD = 1_000_000                                   # build over the corpus
M_REBUILD = C * PAPER_1M.list_capacity + 4096         # rebuild over all slots
M_INSERT = 1024                                       # one insert batch
SERVE_D = 2048            # granite-3-2b's d_model: the serving memory's dim
M_SERVE_INSERT = 32       # the serve drivers' insert batch


@pytest.mark.parametrize("m,c,d,ptrs,fused,want", [
    # the main path at PAPER_1M: build, rebuild, insert
    (M_BUILD, C, D, (A, A), True, "wgmma"),
    (M_REBUILD, C, D, (A, A), True, "wgmma"),
    (M_INSERT, C, D, (A, A), True, "wgmma"),
    # the card tests' shapes
    (1000, 96, 128, (A, A), True, "wgmma"),
    (300, 1, 64, (A, A), True, "wgmma"),
    (70_000, 1024, 1024, (A, A), True, "wgmma"),
    (65, 300, 1280, (A, A), True, "wgmma"),       # 3 ring stages
    (100, 50, 68, (A, A), True, "wgmma"),         # a 272-byte row stride
    (777, 200, 130, (A, A), True, "generic"),     # D % 4 != 0
    (777, 200, 129, (A, A), True, "generic"),
    (4097, C, D, (A + 4, A), True, "generic"),    # misaligned x
    (4097, C, D, (A, A + 8), True, "generic"),    # misaligned centroids
    (4097, C, D, (A, A), False, "generic"),       # f32 products
    (4097, C, 1664, (A, A), True, "wgmma"),       # streamed: no row tile
    # the serving memory at granite-3-2b's and olmoe-1b-7b's d_model
    (M_BUILD, C, SERVE_D, (A, A), True, "wgmma"),
    (M_SERVE_INSERT, C, SERVE_D, (A, A), True, "wgmma"),
    (4097, C, 2560, (A, A), True, "wgmma"),
    (4097, C, 3584, (A, A), True, "wgmma"),
    (4097, C, 4608, (A, A), True, "wgmma"),
    (4097, C, 5120, (A, A), True, "wgmma"),
    (4097, C, 2050, (A, A), True, "generic"),     # D % 4 != 0
    (4097, C, SERVE_D, (A + 4, A), True, "generic"),
    (4097, C, SERVE_D, (A, A + 8), True, "generic"),
    (4097, C, SERVE_D, (A, A), False, "generic"),
    (2 ** 31 - 128, C, SERVE_D, (A, A), True, "generic"),   # past int rows
])
def test_variant_choice(m, c, d, ptrs, fused, want):
    assert ka.variant_for(m, c, d, *ptrs, fused_conversion=fused) == want


def test_every_aligned_depth_takes_wgmma():
    """Every D % 4 == 0 from 4 to 5120 takes wgmma with aligned pointers and
    fused conversion; every other D takes generic."""
    for d in range(1, 5121):
        want = "wgmma" if d % 4 == 0 else "generic"
        assert ka.variant_for(4097, C, d, A, A) == want, d
        assert ka.variant_for(4097, C, d, A, A,
                              fused_conversion=False) == "generic", d


@pytest.mark.parametrize("d,want", [(64, 4), (1024, 4), (1152, 3),
                                    (1280, 3), (1408, 2), (1536, 2),
                                    (1664, 1)])
def test_ring_stages(d, want):
    """At D = 1024 the first 256 of depth held in registers leave room for
    four 32 KB centroid stages beside the 96 KB bf16 row tile."""
    assert ka.ring_stages(d) == want


@pytest.mark.parametrize("d,want", [
    (4, "resident"), (64, "resident"), (D, "resident"),  # all four stages
    (1028, "streamed"), (1152, "streamed"), (1280, "streamed"),
    (1408, "streamed"), (1536, "streamed"),   # the resident kernel could
    (1540, "streamed"), (1664, "streamed"), (SERVE_D, "streamed"),
    (2560, "streamed"), (5120, "streamed"), (65_536, "streamed")])
def test_wgmma_mode(d, want):
    """The resident row tile where all MAX_STAGES ring stages fit beside it
    (D <= 1024), the streamed mode above: the measured crossover, though
    the resident kernel takes D up to 1536."""
    assert ka.wgmma_mode(d) == want


def test_wgmma_mode_follows_ring_stages():
    for d in range(4, 8193, 4):
        assert (ka.wgmma_mode(d) == "resident") == \
            (ka.ring_stages(d) == ka.MAX_STAGES), d
        if ka.wgmma_mode(d) == "streamed" and d <= 1536:
            assert ka.ring_stages(d) >= ka.MIN_STAGES, d


def test_streamed_rings_fill_shared_memory():
    """Six 16 KB x slots (128 rows x 32 f32) and four 32 KB centroid slots
    (256 x 64 bf16) fit in the 227 KB a block may have, at any D, and one
    more slot of either would not."""
    smem = (ka.ALIGN + ka.S_XSTAGES * ka.S_XSTAGE_BYTES
            + ka.S_CSTAGES * ka.STAGE_BYTES
            + 2 * (ka.S_XSTAGES + ka.S_CSTAGES) * 8 + ka.S_FLAG_BYTES)
    assert ka.S_XSTAGE_BYTES == 16_384 and ka.STAGE_BYTES == 32_768
    assert smem == 230_576 <= ka.SMEM_LIMIT
    assert smem + ka.S_XSTAGE_BYTES > ka.SMEM_LIMIT


def test_python_sizes_mirror_the_source():
    """The chooser's sizes are the ones the kernel is built with."""
    src = (build.CSRC / "kmeans_assign.cu").read_text()
    body = src[src.index("namespace wg {"):]
    for name in ("ROWS", "CTILE", "KSLAB", "REG_CHUNKS", "CLUSTER",
                 "MIN_STAGES", "MAX_STAGES", "ALIGN", "SMEM_LIMIT"):
        m = re.search(rf"constexpr int {name} = (\d+);", body)
        assert m, name
        assert int(m.group(1)) == getattr(ka, name), name
    assert "constexpr int XBOX = 32;" in body
    assert "constexpr int XCHUNK = 4 * XBOX;" in body and ka.XCHUNK == 128
    assert "STAGE_BYTES = CTILE * 128;" in body
    assert "BAR_BYTES = 2 * MAX_STAGES * 8;" in body
    assert "MERGE_BYTES = 2 * ROWS * 8;" in body


def test_python_streamed_sizes_mirror_the_source():
    """The streamed mode's sizes (stages, row tile, cluster, key counters)
    are the ones the kernel is built with."""
    src = (build.CSRC / "kmeans_assign.cu").read_text()
    body = src[src.index("namespace wg {"):]
    for name in ("S_CLUSTER", "S_XSTAGES", "S_CSTAGES", "S_FLAG_BYTES"):
        m = re.search(rf"constexpr int {name} = (\d+);", body)
        assert m, name
        assert int(m.group(1)) == getattr(ka, name), name
    assert "constexpr int S_ROWS = 2 * ROWS;" in body and ka.S_ROWS == 128
    assert "constexpr int HALF = CTILE / 2;" in body and ka.HALF == 128
    assert "S_XSTAGE_BYTES = S_ROWS * 128;" in body
    smem = re.search(r"constexpr int S_SMEM_BYTES = ([^;]+);", body)
    assert smem and " ".join(smem.group(1).split()) == (
        "ALIGN + S_XSTAGES * S_XSTAGE_BYTES + S_CSTAGES * STAGE_BYTES + "
        "2 * (S_XSTAGES + S_CSTAGES) * 8 + S_FLAG_BYTES")
    assert "return (M + S_ROWS - 1) / S_ROWS;" in body      # s_tiles
    assert ka._streamed_tiles(129) == 2 and ka._streamed_tiles(128) == 1


@pytest.mark.parametrize("m,c,sms,want", [
    (M_INSERT, C, 132, 4),      # 8 row-tile pairs: one slice per tile of C
    (4097, C, 132, 2),          # 33 pairs: two slices of two tiles each
    (8192, C, 132, 1),          # 64 pairs fill 66 clusters
    (M_BUILD, C, 132, 1),
    (M_REBUILD, C, 132, 1),
    (M_INSERT, 1000, 132, 4),   # a ragged last tile of C still counts
    (M_INSERT, 96, 132, 1),     # one tile of C: nothing to split
    (M_INSERT, 600, 132, 3),
    (M_INSERT, C, 16, 1),       # a small card: the pairs already fill it
    (64, C, 132, 4),
])
def test_c_split(m, c, sms, want):
    assert ka.c_split(m, c, sms) == want


@pytest.mark.parametrize("m,c,sms,want", [
    # the 32-row insert: one row tile; 128-centroid block tiles, so two
    # slices of four reach 8 SMs
    (M_SERVE_INSERT, C, 132, 2),
    (M_BUILD, C, 132, 1),       # 7813 row tiles fill the card
    (M_REBUILD, C, 132, 1),
    (4097, C, 132, 1),          # 33 row tiles x 4 blocks = 132
    (M_INSERT, C, 132, 2),      # 8 row tiles: 2 slices of 512 centroids
    (M_SERVE_INSERT, 4096, 132, 8),
    (M_SERVE_INSERT, 96, 132, 1),
    (M_SERVE_INSERT, C, 4, 1),  # a small card: one cluster already fills it
])
def test_c_split_streamed(m, c, sms, want):
    assert ka.c_split(m, c, sms, "streamed") == want


@pytest.mark.parametrize("m,sms,want", [(M_SERVE_INSERT, 132, 128),
                                        (M_INSERT, 132, 128),
                                        (4097, 132, 256),
                                        (M_BUILD, 132, 256),
                                        (M_SERVE_INSERT, 4, 256)])
def test_streamed_tile_width(m, sms, want):
    assert ka.tile_width(m, sms) == want


@pytest.mark.parametrize("m", [1, 32, 1024, 4097, 8192, M_BUILD])
@pytest.mark.parametrize("c", [1, 96, 300, C, 1100, 4096])
def test_streamed_slices_cover_c(m, c):
    """The kernel's slices (tiles per slice rounded up to a multiple of the
    cluster) cover every centroid tile once, and none is empty."""
    width = ka.tile_width(m, 132)
    nct = -(-c // ka.CTILE) * ka.CTILE // width     # the kernel's Cp / width
    split = ka.c_split(m, c, 132, "streamed")
    tps = -(-nct // split)
    tps = -(-tps // ka.S_CLUSTER) * ka.S_CLUSTER
    slices = [range(s * tps, min(s * tps + tps, nct)) for s in range(split)]
    assert all(len(r) for r in slices)
    assert sorted(t for r in slices for t in r) == list(range(nct))


@pytest.mark.parametrize("m", [1, 64, 1024, 2048, 4097, 6000, 8192])
def test_c_split_slices_are_even_and_cover_c(m):
    """Every slice gets the same number of centroid tiles (the last may be
    short) and no slice is empty."""
    n_tiles = math.ceil(C / ka.CTILE)
    split = ka.c_split(m, C, 132)
    per = math.ceil(n_tiles / split)
    assert 1 <= split <= n_tiles
    assert (split - 1) * per < n_tiles <= split * per


def test_merge_key_is_lexicographic_on_dist_then_index():
    pairs = [(-math.inf, 5), (-3.4e38, 0), (-2.0, 7), (-2.0, 9), (-1e-40, 1),
             (-0.0, 2), (0.0, 3), (1e-40, 0), (0.5, 0), (0.5, 4), (2.0, 1),
             (3.4e38, 2), (math.inf, 0), (math.inf, 6)]
    by_key = sorted(pairs, key=lambda p: ka.merge_key(*p))
    by_pair = sorted(pairs, key=lambda p: (p[0] + 0.0, p[1]))
    assert by_key == by_pair
    keys = [ka.merge_key(*p) for p in pairs]
    assert all(0 <= k < 2 ** 64 for k in keys)


def test_merge_key_ties_and_signed_zero():
    # -0.0 and +0.0 are one distance: the lower index wins either way
    assert ka.merge_key(-0.0, 4) == ka.merge_key(0.0, 4)
    assert ka.merge_key(-0.0, 3) < ka.merge_key(0.0, 4)
    assert ka.merge_key(0.0, 3) < ka.merge_key(-0.0, 4)
    # an exact tie goes to the lowest index, wherever its slice was
    assert min(ka.merge_key(-7.25, i) for i in (900, 5, 300)) == \
        ka.merge_key(-7.25, 5)
    # the index never outweighs the distance
    assert ka.merge_key(-1.0, 2 ** 31 - 1) < ka.merge_key(-0.99999994, 0)
    assert ka.merge_key(1.0, 2 ** 31 - 1) < ka.merge_key(1.0000001, 0)


def test_forcing_a_variant():
    check = scan_stream.check_forced
    assert check("k", None, "wgmma", ka.VARIANTS) == "wgmma"
    assert check("k", "generic", "wgmma", ka.VARIANTS) == "generic"
    assert check("k", "wgmma", "wgmma", ka.VARIANTS) == "wgmma"
    with pytest.raises(ValueError, match="cannot take the wgmma"):
        check("kmeans_assign", "wgmma", "generic", ka.VARIANTS)
    with pytest.raises(ValueError, match="_variant must be"):
        check("kmeans_assign", "stream", "wgmma", ka.VARIANTS)


def _counts():
    return [ka.launches.value,
            *(c.value for c in ka.launches_by_variant.values())]


@pytest.mark.parametrize("fused", [True, False])
def test_cpu_tensors_take_the_plain_version(fused):
    g = torch.Generator().manual_seed(0)
    x, cent = torch.randn(300, 64, generator=g), torch.randn(40, 64,
                                                            generator=g)
    before = _counts()
    want = ref.kmeans_assign_ref(x, cent, fused_conversion=fused)
    for variant in (None, "wgmma", "generic"):
        idx, dist = ka.kmeans_assign(x, cent, fused_conversion=fused,
                                     _variant=variant)
        assert torch.equal(idx, want[0]) and torch.equal(dist, want[1])
    idx, dist = ops.kmeans_assign(x, cent, fused_conversion=fused)
    assert torch.equal(idx, want[0]) and torch.equal(dist, want[1])
    assert _counts() == before


@pytest.mark.parametrize("mode", ["resident", "streamed"])
def test_cpu_tensors_ignore_the_mode(mode):
    g = torch.Generator().manual_seed(1)
    x, cent = torch.randn(70, 2048, generator=g), torch.randn(9, 2048,
                                                            generator=g)
    before = _counts()
    want = ref.kmeans_assign_ref(x, cent)
    idx, dist = ka.kmeans_assign(x, cent, _variant="wgmma", _mode=mode)
    assert torch.equal(idx, want[0]) and torch.equal(dist, want[1])
    assert _counts() == before


def test_the_kernel_includes_the_shared_header():
    src = (build.CSRC / "kmeans_assign.cu").read_text()
    assert '#include "scan_stream.cuh"' in src


def test_digest_follows_the_shared_header(tmp_path, monkeypatch):
    (tmp_path / "kmeans_assign.cu").write_text('#include "scan_stream.cuh"\n')
    hdr = tmp_path / "scan_stream.cuh"
    hdr.write_text("inline int encode_2d();\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("kmeans_assign")
    assert build.library_path("kmeans_assign") == first
    hdr.write_text("inline int encode_2d(int box_rows);\n")
    assert build.library_path("kmeans_assign") != first
    assert build.library_path("kmeans_assign").parent.name == build._digest()
