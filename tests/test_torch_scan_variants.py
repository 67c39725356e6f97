"""Variant choice of the two scan kernels, on the CPU.

`scan_scores` and `scan_scores_q8` each have a ``stream`` variant (TMA ring,
persistent grid, resident queries) and a ``generic`` one.  The choice is a
pure function of shapes and alignment; these tests pin it down, check that
CPU tensors still take the plain versions, and that an edited shared
header rebuilds the kernels.
"""
import re

import pytest
import torch

from repro_torch.configs.ame_paper import PAPER_1M
from repro_torch.kernels import build, ops, ref, scan_stream
from repro_torch.kernels import scan_scores as ss
from repro_torch.kernels import scan_scores_q8 as q8

A = 256          # a 16-byte-aligned address
N_FULL = PAPER_1M.n_clusters * PAPER_1M.list_capacity + 4096
N_PROBE = PAPER_1M.nprobe * PAPER_1M.list_capacity + 4096


@pytest.mark.parametrize("b,n,d,ptrs,want", [
    # the main path at PAPER_1M: full scan, probed slab, centroid scores
    (64, N_FULL, 1024, (A, A), "stream"),
    (1, N_PROBE, 1024, (A, A), "stream"),
    (1, PAPER_1M.n_clusters, 1024, (A, A), "stream"),
    (64, PAPER_1M.n_clusters, 1024, (A, A), "stream"),
    # the card tests' shapes
    (7, 100, 768, (A, A), "stream"),
    (65, 1000, 1024, (A, A), "stream"),
    (97, 3001, 1024, (A, A), "stream"),
    (200, 777, 256, (A, A), "stream"),
    # f32 rows need only D % 4 == 0: 68 floats are a 272-byte stride
    (2, 4099, 68, (A, A), "stream"),
    (5, 1000, 130, (A, A), "generic"),            # odd stride
    (5, 1000, 129, (A, A), "generic"),
    (64, 1000, 1024, (A + 4, A), "generic"),      # misaligned q
    (64, 1000, 1024, (A, A + 8), "generic"),      # misaligned db
    (64, 1000, 4096, (A, A), "generic"),          # query tile does not fit
    (8, 1000, 4096, (A, A), "stream"),            # a smaller tile does
])
def test_scan_scores_variant(b, n, d, ptrs, want):
    assert ss.variant_for(b, n, d, *ptrs) == want


@pytest.mark.parametrize("b,n,d,ptrs,want", [
    (64, N_FULL, 1024, (A, A), "stream"),
    (1, N_PROBE, 1024, (A, A), "stream"),
    (7, 100, 768, (A, A), "stream"),
    (200, 777, 256, (A, A), "stream"),
    (3, 50, 1040, (A, A), "stream"),              # ragged last box
    (97, 3001, 130, (A, A), "generic"),
    (5, 300, 68, (A, A), "generic"),              # 68 bytes: not % 16
    (64, 1000, 1024, (A, A + 1), "generic"),      # misaligned codes
    (64, 1000, 1024, (A + 3, A), "generic"),      # misaligned qc
    (64, 1000, 16384, (A, A), "generic"),         # query tile does not fit
])
def test_scan_scores_q8_variant(b, n, d, ptrs, want):
    assert q8.variant_for(b, n, d, *ptrs) == want


@pytest.mark.parametrize("b,want", [(1, 8), (8, 8), (9, 16), (16, 16),
                                    (17, 32), (33, 64), (64, 64), (200, 64)])
def test_query_tile(b, want):
    assert scan_stream.query_tile(b) == want


def test_python_sizes_mirror_the_header():
    """The chooser's sizes are the ones the kernels are built with."""
    src = (build.CSRC / "scan_stream.cuh").read_text()
    for name in ("GROUP_WARPS", "BOX_BYTES", "MAX_STAGES", "MIN_STAGES", "QPAD",
                 "ALIGN", "SMEM_LIMIT"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        assert int(m.group(1)) == getattr(scan_stream, name), name
    assert "TILE_ROWS = 32 * GROUP_WARPS;" in src
    assert "BARRIERS = 2 * MAX_STAGES + 2;" in src


def test_paper_1m_stream_keeps_a_deep_ring():
    """At D = 1024 the full scan's resident tile of 64 queries leaves room
    for 6 f32 stages and 8 int8 stages of 16 KB."""
    assert scan_stream.ring_stages(64, 2 * 1024, 0) == 6
    assert scan_stream.ring_stages(64, 1024, 8 * 64) == 8


def test_forcing_a_variant():
    assert scan_stream.check_forced("s", None, "stream") == "stream"
    assert scan_stream.check_forced("s", "generic", "stream") == "generic"
    assert scan_stream.check_forced("s", "stream", "stream") == "stream"
    with pytest.raises(ValueError, match="cannot take the stream"):
        scan_stream.check_forced("s", "stream", "generic")
    with pytest.raises(ValueError, match="_variant must be"):
        scan_stream.check_forced("s", "tma", "stream")


def _counts():
    return [c.value for m in (ss, q8)
            for c in (m.launches, *m.launches_by_variant.values())]


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_cpu_tensors_take_the_plain_versions(metric):
    g = torch.Generator().manual_seed(0)
    q, db = torch.randn(5, 64, generator=g), torch.randn(300, 64, generator=g)
    ids = torch.arange(300, dtype=torch.int32)
    ids[::7] = -1
    before = _counts()
    got = ops.scan_scores(q, db, ids, metric=metric)
    torch.testing.assert_close(got, ref.scan_scores_ref(q, db, ids,
                                                        metric=metric))
    codes, scales, zeros = (torch.randint(-127, 128, (300, 64), generator=g,
                                          dtype=torch.int8),
                            torch.rand(300, generator=g) * 1e-2,
                            torch.randn(300, generator=g) * 1e-2)
    norms = torch.rand(300, generator=g) if metric == "l2" else None
    got = ops.scan_scores_q8(q, codes, ids, scales, zeros, norms,
                             metric=metric)
    assert torch.equal(got, ref.scan_scores_q8_ref(q, codes, ids, scales,
                                                   zeros, norms,
                                                   metric=metric))
    # a forced variant means nothing to a CPU tensor
    qc, sq = ref.quantize_queries(q)
    got = q8.scan_scores_q8(qc, codes, ids, scales, zeros, sq,
                            ref.query_corr(qc, sq), norms, metric=metric,
                            _variant="stream")
    assert torch.equal(got, ref.scan_scores_q8_ref(q, codes, ids, scales,
                                                   zeros, norms,
                                                   metric=metric))
    got = ss.scan_scores(q, db, ids, metric=metric, _variant="generic")
    torch.testing.assert_close(got, ref.scan_scores_ref(q, db, ids,
                                                        metric=metric))
    assert _counts() == before


def test_digest_follows_the_shared_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "scan_stream.cuh"\n')
    hdr = tmp_path / "scan_stream.cuh"
    hdr.write_text("constexpr int TILE_ROWS = 128;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._digest()
    assert build._digest() == first
    hdr.write_text("constexpr int TILE_ROWS = 64;\n")
    assert build._digest() != first
    assert build.library_path("scan_scores").parent.name == build._digest()
