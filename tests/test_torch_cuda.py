"""The port's Hopper kernels and main path on the card (marker `cuda`).

These need an NVIDIA card with nvcc; without one every test skips.  Run them
on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.kernels import kmeans_assign as ka
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scan_scores as ss
from repro_torch.kernels import scan_scores_q8 as q8
from repro_torch.kernels import segsum_gemm as sg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


@pytest.mark.parametrize("b,n,d", [(1, 1000, 256), (33, 777, 192),
                                   (17, 129, 1024), (64, 4099, 130),
                                   (97, 3001, 1024)])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_scan_scores_kernel_matches_plain(dev, b, n, d, metric):
    q, db = _randn(dev, b, d, seed=1), _randn(dev, n, d, seed=2)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids[::5] = -1
    norms = (db ** 2).sum(1) if metric == "l2" else None
    before = ss.launches.value
    got = ss.scan_scores(q, db, ids, norms, metric=metric)
    assert ss.launches.value == before + 1
    want = ref.scan_scores_ref(q, db, ids, norms, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,n,d", [(1, 1000, 256), (5, 300, 130),
                                   (17, 129, 1024), (64, 4099, 1024),
                                   (97, 3001, 130)])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_scan_scores_q8_kernel_matches_plain(dev, b, n, d, metric):
    """Random int8 operands over the whole code range, ragged B/N/D and
    ~10 % tombstones: the integer accumulator is exact, so the scores agree
    to f32 epilogue rounding and the masks are identical."""
    g = torch.Generator(device=dev).manual_seed(9)
    qc = torch.randint(-127, 128, (b, d), generator=g, device=dev,
                       dtype=torch.int8)
    codes = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                          dtype=torch.int8)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids[torch.rand(n, generator=g, device=dev) < 0.1] = -1
    scales = torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4
    zeros = torch.randn(n, generator=g, device=dev) * 1e-2
    sq = torch.rand(b, generator=g, device=dev) * 1e-2 + 1e-3
    corr = ref.query_corr(qc, sq)
    norms = (torch.rand(n, generator=g, device=dev) * 2
             if metric == "l2" else None)
    before = q8.launches.value
    got = q8.scan_scores_q8(qc, codes, ids, scales, zeros, sq, corr, norms,
                            metric=metric)
    assert q8.launches.value == before + 1
    want = ref.scan_scores_q8_plain(qc, codes, ids, scales, zeros, sq, corr,
                                    norms, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


# (b, n, d): B across the query tiles (1, 7, 64, 65, 97, 200), N below one
# 128-row tile, not a multiple of it, and 1000; D the stream variant takes
# (1024, 768, 256) and two it cannot take for int8 codes (130, 68)
_STREAM_SHAPES = [(1, 1000, 1024), (7, 100, 768), (64, 3001, 1024),
                  (65, 1000, 256), (97, 777, 1024), (200, 3001, 768),
                  (1, 100, 256), (64, 1000, 768)]
_GENERIC_SHAPES = [(7, 1000, 130), (65, 3001, 68), (200, 100, 130),
                   (1, 777, 68)]


def _variant_cases(kernel):
    cases = [(shape, v) for shape in _STREAM_SHAPES
             for v in ("stream", "generic")]
    for shape in _GENERIC_SHAPES:
        legal = (shape[2] * (4 if kernel == "f32" else 1)) % 16 == 0
        cases += [(shape, v) for v in (("stream", "generic") if legal
                                       else ("generic",))]
    return cases


def _q8_operands(dev, b, n, d, metric, seed=9, codes=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    qc = torch.randint(-127, 128, (b, d), generator=g, device=dev,
                       dtype=torch.int8)
    if codes is None:
        codes = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                              dtype=torch.int8)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids[torch.rand(n, generator=g, device=dev) < 0.1] = -1
    sq = torch.rand(b, generator=g, device=dev) * 1e-2 + 1e-3
    norms = (torch.rand(n, generator=g, device=dev) * 2
             if metric == "l2" else None)
    return (qc, codes, ids, torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4,
            torch.randn(n, generator=g, device=dev) * 1e-2, sq,
            ref.query_corr(qc, sq), norms)


def _f32_operands(dev, b, n, d, metric, db=None):
    q = _randn(dev, b, d, seed=1)
    db = _randn(dev, n, d, seed=2) if db is None else db
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    ids[torch.rand(n, generator=g, device=dev) < 0.1] = -1
    norms = (db ** 2).sum(1) if metric == "l2" else None
    return q, db, ids, norms


def _check_f32(got, want):
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape,variant", _variant_cases("f32"))
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_scan_scores_variants_match_plain(dev, shape, variant, metric):
    q, db, ids, norms = _f32_operands(dev, *shape, metric)
    before = ss.launches_by_variant[variant].value
    got = ss.scan_scores(q, db, ids, norms, metric=metric, _variant=variant)
    assert ss.launches_by_variant[variant].value == before + 1
    torch.cuda.synchronize()
    _check_f32(got, ref.scan_scores_ref(q, db, ids, norms, metric=metric))


@pytest.mark.parametrize("shape,variant", _variant_cases("q8"))
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_scan_scores_q8_variants_bit_equal_plain(dev, shape, variant, metric):
    """The exact s32 accumulator and the epilogue's rounded steps in the
    reference's order: scores equal the plain version's bit for bit."""
    args = _q8_operands(dev, *shape, metric)
    before = q8.launches_by_variant[variant].value
    got = q8.scan_scores_q8(*args, metric=metric, _variant=variant)
    assert q8.launches_by_variant[variant].value == before + 1
    torch.cuda.synchronize()
    want = ref.scan_scores_q8_plain(*args, metric=metric)
    assert float((got - want).nan_to_num(0.0).abs().max()) == 0.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_misaligned_slices_take_generic(dev, metric):
    """A contiguous slice whose base is not 16-byte aligned cannot feed
    TMA: the wrappers pick generic, and the scores still match."""
    b, n, d = 9, 1000, 1024
    flat = _randn(dev, n * d + 1, seed=4)
    db = flat[1:].view(n, d)
    assert db.is_contiguous() and db.data_ptr() % 16 == 4
    q, db, ids, norms = _f32_operands(dev, b, n, d, metric, db=db)
    before = {v: c.value for v, c in ss.launches_by_variant.items()}
    got = ss.scan_scores(q, db, ids, norms, metric=metric)
    assert ss.launches_by_variant["generic"].value == before["generic"] + 1
    assert ss.launches_by_variant["stream"].value == before["stream"]
    _check_f32(got, ref.scan_scores_ref(q, db, ids, norms, metric=metric))
    with pytest.raises(ValueError, match="stream"):
        ss.scan_scores(q, db, ids, norms, metric=metric, _variant="stream")

    g = torch.Generator(device=dev).manual_seed(5)
    flat8 = torch.randint(-127, 128, (n * d + 3,), generator=g, device=dev,
                          dtype=torch.int8)
    args = _q8_operands(dev, b, n, d, metric, codes=flat8[3:].view(n, d))
    before = {v: c.value for v, c in q8.launches_by_variant.items()}
    got = q8.scan_scores_q8(*args, metric=metric)
    assert q8.launches_by_variant["generic"].value == before["generic"] + 1
    assert q8.launches_by_variant["stream"].value == before["stream"]
    assert torch.equal(got, ref.scan_scores_q8_plain(*args, metric=metric))


@pytest.mark.parametrize("b", [1, 64])
def test_d1024_scans_take_stream(dev, b):
    """At PAPER_1M's width every scan takes the stream variant."""
    q, db, ids, _ = _f32_operands(dev, b, 3000, 1024, "ip")
    args = _q8_operands(dev, b, 3000, 1024, "ip")
    for mod, call in ((ss, lambda: ss.scan_scores(q, db, ids)),
                      (q8, lambda: q8.scan_scores_q8(*args))):
        before = {v: c.value for v, c in mod.launches_by_variant.items()}
        call()
        assert mod.launches_by_variant["stream"].value == before["stream"] + 1
        assert mod.launches_by_variant["generic"].value == before["generic"]


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_q8_dispatch_on_quantized_rows(dev, metric):
    """The index's own operands: rows quantized by the int8 store, f32
    queries quantized by the dispatch; kernel against plain version."""
    from repro_torch.core import index as ivf
    rows, q = _randn(dev, 2000, 1024, seed=10), _randn(dev, 3, 1024, seed=11)
    ids = torch.arange(2000, dtype=torch.int32, device=dev)
    ids[::9] = -1
    codes, scales, zeros, norms = ivf._quantize_rows(rows, ids)
    norms = norms if metric == "l2" else None
    got = ops.scan_scores_q8(q, codes, ids, scales, zeros, norms,
                             metric=metric)
    want = ops.scan_scores_q8(q, codes, ids, scales, zeros, norms,
                              metric=metric, use_kernel=False)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,c,d", [(1000, 96, 128), (777, 200, 130),
                                   (300, 1, 64), (4097, 1024, 1024),
                                   (32, 1024, 2048), (4097, 1024, 2560)])
@pytest.mark.parametrize("fused", [True, False])
def test_kmeans_assign_kernel_matches_plain(dev, m, c, d, fused):
    x, cent = _randn(dev, m, d, seed=3), _randn(dev, c, d, seed=4)
    idx, dist = ka.kmeans_assign(x, cent, fused_conversion=fused)
    ridx, rdist = ref.kmeans_assign_ref(x, cent, fused_conversion=fused)
    torch.testing.assert_close(dist, rdist, rtol=3e-2, atol=3e-2)
    if c > 1:
        rnd = ref.round_bf16 if fused else (lambda t: t)
        dd = (cent ** 2).sum(1)[None, :] - 2 * (rnd(x) @ rnd(cent).T)
        two = torch.topk(dd, 2, dim=1, largest=False).values
        sure = (two[:, 1] - two[:, 0]) > 3e-2
        assert torch.equal(idx[sure], ridx[sure])
    assert int(idx.min()) >= 0 and int(idx.max()) < c


@pytest.mark.parametrize("fused", [True, False])
def test_kmeans_assign_ties_go_to_lowest_index(dev, fused):
    x = _randn(dev, 300, 64, seed=5)
    cent = torch.cat([x[:3], x[:3]])
    idx, _ = ka.kmeans_assign(x, cent, fused_conversion=fused)
    assert int(idx.max()) < 3
    assert idx[:3].tolist() == [0, 1, 2]


@pytest.mark.parametrize("m,c,d", [(4099, 1000, 1030), (129, 257, 33),
                                   (1, 3, 4), (130, 1, 2052),
                                   (1000, 300, 2048)])
def test_kmeans_assign_f32_rung_at_ragged_shapes(dev, m, c, d):
    """The f32-product rung (register-tiled SGEMM) at ragged M, C and D."""
    x, cent = _randn(dev, m, d, seed=21), _randn(dev, c, d, seed=22)
    before = ka.launches_by_variant["generic"].value
    idx, dist = ka.kmeans_assign(x, cent, fused_conversion=False)
    assert ka.launches_by_variant["generic"].value == before + 1
    ridx, rdist = ref.kmeans_assign_ref(x, cent, fused_conversion=False)
    torch.testing.assert_close(dist, rdist, rtol=1e-4, atol=1e-3)
    if c > 1:
        dd = (cent ** 2).sum(1)[None, :] - 2 * (x @ cent.T)
        two = torch.topk(dd, 2, dim=1, largest=False).values
        sure = (two[:, 1] - two[:, 0]) > 1e-2
        assert torch.equal(idx[sure], ridx[sure])
    assert int(idx.min()) >= 0 and int(idx.max()) < c


def _assign_cases():
    """(shape, variant) for both kmeans_assign variants where the shape
    takes wgmma (fresh tensors are 16-byte aligned), else generic only."""
    cases = []
    for shape in [(1000, 96, 128), (777, 200, 130), (300, 1, 64),
                  (4097, 1024, 1024), (1024, 1024, 1024),
                  (70_000, 1024, 1024), (65, 300, 1280), (100, 50, 68),
                  (32, 1024, 2048), (4097, 1024, 2048), (777, 200, 2048),
                  (100, 1000, 2560), (4097, 300, 2560)]:
        for v in ka.VARIANTS:
            if v == "generic" or ka.variant_for(*shape, 256, 256) == v:
                cases.append((shape, v))
    return cases


def _check_assign(x, cent, idx, dist, tol=3e-2):
    """dist within tol of the plain version; idx equal wherever the plain
    version's best-vs-second margin exceeds tol."""
    ridx, rdist = ref.kmeans_assign_ref(x, cent)
    torch.testing.assert_close(dist, rdist, rtol=tol, atol=tol)
    if cent.shape[0] > 1:
        dd = (cent ** 2).sum(1)[None, :] - 2 * (ref.round_bf16(x)
                                                @ ref.round_bf16(cent).T)
        two = torch.topk(dd, 2, dim=1, largest=False).values
        sure = (two[:, 1] - two[:, 0]) > tol
        assert torch.equal(idx[sure], ridx[sure])
    assert int(idx.min()) >= 0 and int(idx.max()) < cent.shape[0]


@pytest.mark.parametrize("shape,variant", _assign_cases())
def test_kmeans_assign_variants_match_plain(dev, shape, variant):
    m, c, d = shape
    x, cent = _randn(dev, m, d, seed=12), _randn(dev, c, d, seed=13)
    before = ka.launches_by_variant[variant].value
    idx, dist = ka.kmeans_assign(x, cent, _variant=variant)
    assert ka.launches_by_variant[variant].value == before + 1
    torch.cuda.synchronize()
    _check_assign(x, cent, idx, dist)


@pytest.mark.parametrize("m", [1024, 70_000])
@pytest.mark.parametrize("variant", ["wgmma", "generic"])
def test_kmeans_assign_far_apart_ties_go_to_lowest_index(dev, m, variant):
    """Copies of a row in every centroid tile (and, at M = 1024, in every
    C-slice): the lowest index wins, as one block doing all of C gives."""
    x, cent = _randn(dev, m, 1024, seed=14), _randn(dev, 1024, 1024, seed=15)
    for base in (1000, 700, 300, 5):
        cent[base:base + 3] = x[:3]
    idx, dist = ka.kmeans_assign(x, cent, _variant=variant)
    assert idx[:3].tolist() == [5, 6, 7]
    _check_assign(x, cent, idx, dist)


@pytest.mark.parametrize("m,d", [(32, 2048), (4097, 2048), (1024, 2560)])
@pytest.mark.parametrize("mode", ["streamed", "resident"])
def test_kmeans_assign_modes_ties_go_to_lowest_index(dev, m, d, mode):
    """Copies of a row in every block's centroid tile and every C slice of
    the streamed mode (and, forced at D = 1024, of the resident one): the
    lowest index wins, and a second call gives the same bits."""
    if mode == "resident":
        d = 1024
    x, cent = _randn(dev, m, d, seed=23), _randn(dev, 1024, d, seed=24)
    for base in (1000, 700, 300, 5):
        cent[base:base + 3] = x[:3]
    idx, dist = ka.kmeans_assign(x, cent, _variant="wgmma", _mode=mode)
    assert idx[:3].tolist() == [5, 6, 7]
    _check_assign(x, cent, idx, dist)
    again = ka.kmeans_assign(x, cent, _variant="wgmma", _mode=mode)
    assert torch.equal(idx, again[0]) and torch.equal(dist, again[1])


@pytest.mark.parametrize("m", [32, 4097])
def test_kmeans_assign_streamed_at_resident_depth(dev, m):
    """The streamed mode forced at D = 1024 (the profiler's crossover
    sweep) agrees with the plain version; the resident one refuses D =
    2048."""
    x, cent = _randn(dev, m, 1024, seed=25), _randn(dev, 1000, 1024, seed=26)
    idx, dist = ka.kmeans_assign(x, cent, _variant="wgmma", _mode="streamed")
    _check_assign(x, cent, idx, dist)
    x2 = _randn(dev, m, 2048, seed=27)
    with pytest.raises(ValueError, match="resident"):
        ka.kmeans_assign(x2, cent.repeat(1, 2), _mode="resident")


@pytest.mark.parametrize("m", [1024, 4097, 70_000])
def test_kmeans_assign_wgmma_is_deterministic(dev, m):
    """Two calls give bit-equal results, across the C-split merge too."""
    x, cent = _randn(dev, m, 1024, seed=16), _randn(dev, 1024, 1024, seed=17)
    a = ka.kmeans_assign(x, cent, _variant="wgmma")
    b = ka.kmeans_assign(x, cent, _variant="wgmma")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_kmeans_assign_main_path_shapes_take_wgmma(dev):
    """A misaligned slice or f32 products take generic; D = 1024 rows take
    wgmma, and forcing wgmma where it cannot run raises."""
    x, cent = _randn(dev, 2000, 1024, seed=18), _randn(dev, 300, 1024, seed=19)
    flat = _randn(dev, 2000 * 1024 + 1, seed=20)
    xm = flat[1:].view(2000, 1024)
    for args, kw, want in (((x, cent), {}, "wgmma"),
                           ((xm, cent), {}, "generic"),
                           ((x, cent), {"fused_conversion": False},
                            "generic")):
        before = {v: c.value for v, c in ka.launches_by_variant.items()}
        ka.kmeans_assign(*args, **kw)
        after = {v: c.value for v, c in ka.launches_by_variant.items()}
        assert {v: after[v] - before[v] for v in after} == \
            {v: int(v == want) for v in after}
    with pytest.raises(ValueError, match="wgmma"):
        ka.kmeans_assign(xm, cent, _variant="wgmma")


@pytest.mark.parametrize("m,c,d,lo", [(999, 64, 128, 0), (100, 8, 130, -1),
                                      (513, 100, 64, -3), (0, 4, 32, 0),
                                      (4000, 1024, 2048, -1)])
def test_segsum_kernel_matches_plain_and_is_deterministic(dev, m, c, d, lo):
    x = _randn(dev, m, d, seed=6)
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randint(lo, c + 5, (m,), generator=g, device=dev,
                      dtype=torch.int32)
    sums, counts = sg.segsum_gemm(x, a, n_clusters=c)
    rsums, rcounts = sg.segsum_gemm_plain(x, a, n_clusters=c)
    assert torch.equal(counts, rcounts)
    torch.testing.assert_close(sums, rsums, rtol=1e-4, atol=1e-3)
    assert torch.equal(sums, sg.segsum_gemm(x, a, n_clusters=c)[0])


def test_use_kernel_false_launches_nothing(dev):
    x = _randn(dev, 64, 128, seed=8)
    ids = torch.arange(64, dtype=torch.int32, device=dev)
    counts = [m.launches.value for m in (ss, q8, ka, sg)]
    ops.scan_scores(x[:2], x, ids, use_kernel=False)
    ops.scan_scores_q8(x[:2], torch.zeros((64, 128), dtype=torch.int8,
                                          device=dev), ids,
                       torch.ones(64, device=dev), torch.zeros(64, device=dev),
                       use_kernel=False)
    ops.kmeans_assign(x, x[:4], use_kernel=False)
    ops.segsum_gemm(x, ids % 4, n_clusters=4, use_kernel=False)
    assert [m.launches.value for m in (ss, q8, ka, sg)] == counts


def test_service_lifecycle_on_the_card(dev):
    from repro_torch.api import MemoryService
    cfg = EngineConfig(dim=256, n_clusters=128, list_capacity=32, nprobe=8,
                       k=4, kmeans_iters=3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 256)).astype(np.float32)
    before = [m.launches.value for m in (ss, ka, sg)]
    with MemoryService(maintenance=False) as svc:
        assert svc.device.type == "cuda"
        coll = svc.create_collection("m", cfg)
        svc.build("m", x)
        ids, _ = svc.query("m", x[:1] + 0.01)           # probed
        assert ids[0, 0] == 0
        ids, _ = svc.query("m", x[:8] + 0.01)           # full scan
        np.testing.assert_array_equal(ids[:, 0], np.arange(8))
        svc.insert("m", rng.standard_normal((64, 256)).astype(np.float32),
                   ids=np.arange(5000, 5064))
        assert svc.delete("m", np.arange(100)) == 100
        r = svc.rebuild("m")
        assert not r["aborted"]
        st = coll.snapshot()
        live = torch.cat([st.list_ids.reshape(-1), st.spill_ids])
        live = set(live[live >= 0].tolist())
        assert live == set(range(100, 2000)) | set(range(5000, 5064))
    after = [m.launches.value for m in (ss, ka, sg)]
    assert all(a > b for a, b in zip(after, before))


def test_int8_service_lifecycle_and_save_load_on_the_card(dev, tmp_path):
    from repro_torch.api import MemoryService
    cfg = EngineConfig(dim=256, n_clusters=128, list_capacity=32, nprobe=8,
                       k=4, kmeans_iters=3, store_dtype="int8", rescore_k=32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2000, 256)).astype(np.float32)
    before = [m.launches.value for m in (ss, q8, ka)]
    with MemoryService(maintenance=False) as svc:
        coll = svc.create_collection("m", cfg)
        svc.build("m", x)
        assert coll.snapshot().q_lists.is_cuda
        ids, _ = svc.query("m", x[:1] + 0.01)            # probed
        assert ids[0, 0] == 0
        ids, _ = svc.query("m", x[:8] + 0.01)            # full scan
        np.testing.assert_array_equal(ids[:, 0], np.arange(8))
        svc.insert("m", rng.standard_normal((64, 256)).astype(np.float32),
                   ids=np.arange(5000, 5064))
        assert svc.delete("m", np.arange(100)) == 100
        assert not svc.rebuild("m")["aborted"]
        want = svc.query("m", x[100:108] + 0.01)
        svc.save(str(tmp_path))
    after = [m.launches.value for m in (ss, q8, ka)]
    assert all(a > b for a, b in zip(after, before))
    back = MemoryService.load(str(tmp_path), maintenance=False)
    try:
        assert back.collection("m").snapshot().q_lists.is_cuda
        got = back.query("m", x[100:108] + 0.01)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    finally:
        back.shutdown()


# ---------------------------------------------------------------------------
# the lane axis: G same-shaped scans in one launch (fused queries)
# ---------------------------------------------------------------------------

# (g, b, n, d): ragged G, B across query tiles, N around the 128-row tile,
# D the stream variant takes for both kernels (1024, 256, 768), D = 1000
# (stream for f32 rows, generic for int8 codes) and D the stream variant
# cannot take (f32 130; int8 130 and 68)
_LANE_STREAM = [(3, 5, 1000, 1024), (2, 1, 777, 1024), (4, 16, 3001, 256),
                (3, 64, 129, 1024), (2, 97, 300, 768), (8, 1, 2000, 1024)]
_LANE_OTHER = [(3, 5, 1000, 1000), (3, 5, 1000, 130), (2, 7, 300, 68)]


def _lane_cases(kernel):
    cases = []
    for shape in _LANE_STREAM + _LANE_OTHER:
        legal = (shape[3] * (4 if kernel == "f32" else 1)) % 16 == 0
        cases += [(shape, v) for v in (("stream", "generic") if legal
                                       else ("generic",))]
    return cases


def _lane_ids(dev, g, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.arange(n, dtype=torch.int32, device=dev).repeat(g, 1)
    ids[torch.rand(g, n, generator=gen, device=dev) < 0.1] = -1
    return ids


def _lane_f32(dev, g, b, n, d, metric):
    q, db = _randn(dev, g, b, d, seed=21), _randn(dev, g, n, d, seed=22)
    norms = (db ** 2).sum(-1) if metric == "l2" else None
    return q, db, _lane_ids(dev, g, n, 23), norms


def _lane_q8(dev, g, b, n, d, metric):
    gen = torch.Generator(device=dev).manual_seed(24)
    qc = torch.randint(-127, 128, (g, b, d), generator=gen, device=dev,
                       dtype=torch.int8)
    codes = torch.randint(-127, 128, (g, n, d), generator=gen, device=dev,
                          dtype=torch.int8)
    sq = torch.rand(g, b, generator=gen, device=dev) * 1e-2 + 1e-3
    norms = (torch.rand(g, n, generator=gen, device=dev) * 2
             if metric == "l2" else None)
    return (qc, codes, _lane_ids(dev, g, n, 25),
            torch.rand(g, n, generator=gen, device=dev) * 1e-3 + 1e-4,
            torch.randn(g, n, generator=gen, device=dev) * 1e-2, sq,
            ref.query_corr(qc, sq), norms)


def _lane(args, i):
    return [None if a is None else a[i] for a in args]


@pytest.mark.parametrize("shape,variant", _lane_cases("f32"))
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_lane_scan_scores_matches_plain_and_2d_launches(dev, shape, variant,
                                                        metric):
    """One launch for G lanes, against the lane plain version; lane g
    equals the 2-D launch on lane g's operands bit for bit."""
    g = shape[0]
    args = _lane_f32(dev, *shape, metric)
    before = (ss.launches.value, ss.launches_by_lanes["G>1"].value)
    got = ss.scan_scores(*args, metric=metric, _variant=variant)
    assert (ss.launches.value, ss.launches_by_lanes["G>1"].value) == \
        (before[0] + 1, before[1] + (g > 1))
    torch.cuda.synchronize()
    assert got.shape == (g, shape[1], shape[2])
    _check_f32(got, ref.scan_scores_lanes_ref(*args, metric=metric))
    for i in range(g):
        one = ss.scan_scores(*_lane(args, i), metric=metric, _variant=variant)
        assert torch.equal(got[i], one), i


@pytest.mark.parametrize("shape,variant", _lane_cases("q8"))
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_lane_scan_scores_q8_bit_equal_plain_and_2d_launches(dev, shape,
                                                             variant, metric):
    g = shape[0]
    args = _lane_q8(dev, *shape, metric)
    before = q8.launches_by_lanes["G>1"].value
    got = q8.scan_scores_q8(*args, metric=metric, _variant=variant)
    assert q8.launches_by_lanes["G>1"].value == before + (g > 1)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.scan_scores_q8_lanes_plain(*args,
                                                           metric=metric))
    for i in range(g):
        one = q8.scan_scores_q8(*_lane(args, i), metric=metric,
                                _variant=variant)
        assert torch.equal(got[i], one), i


@pytest.mark.parametrize("variant", ["stream", "generic"])
@pytest.mark.parametrize("b", [1, 5, 16])
def test_lane_rows_do_not_depend_on_the_query_tile(dev, variant, b):
    """A padded lane launch (B = 40: query tile 64) and a launch of the
    first b queries alone (tile 8 or 16) give the same bits for those
    queries: the depth order of each output's sum ignores the tile."""
    q, db, ids, _ = _lane_f32(dev, 3, 40, 1000, 1024, "ip")
    got = ss.scan_scores(q, db, ids, _variant=variant)
    args = _lane_q8(dev, 3, 40, 1000, 1024, "ip")
    got8 = q8.scan_scores_q8(*args, _variant=variant)
    for i in range(3):
        one = ss.scan_scores(q[i, :b].contiguous(), db[i], ids[i],
                             _variant=variant)
        assert torch.equal(got[i, :b], one)
        a = _lane(args, i)
        one8 = q8.scan_scores_q8(a[0][:b].contiguous(), *a[1:5],
                                 a[5][:b].contiguous(), a[6][:b].contiguous(),
                                 _variant=variant)
        assert torch.equal(got8[i, :b], one8)


def test_lane_operands_are_checked(dev):
    q, db, ids, _ = _lane_f32(dev, 2, 3, 100, 256, "ip")
    with pytest.raises(ValueError, match="do not match"):
        ss.scan_scores(q, db[:1], ids)
    with pytest.raises(ValueError, match="contiguous"):
        ss.scan_scores(q.transpose(1, 2).contiguous().transpose(1, 2), db,
                       ids)
    args = list(_lane_q8(dev, 2, 3, 100, 256, "ip"))
    args[5] = args[5][:1]
    with pytest.raises(ValueError, match="sq"):
        q8.scan_scores_q8(*args)


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
@pytest.mark.parametrize("path", ["full_scan", "probed"])
def test_fused_window_equals_sync_on_the_card(dev, store_dtype, path):
    """query_many over three tenants: one lane launch per scan step, and
    the same ids and scores (1e-5) as the per-collection queries."""
    from repro_torch.api import MemoryService
    cfg = EngineConfig(dim=256, n_clusters=128, list_capacity=32, nprobe=8,
                       k=4, kmeans_iters=3, store_dtype=store_dtype,
                       rescore_k=32)
    rng = np.random.default_rng(2)
    with MemoryService(maintenance=False) as svc:
        xs = {}
        for i, name in enumerate(("a", "b", "c")):
            svc.create_collection(name, cfg, seed=i)
            xs[name] = rng.standard_normal((2000, 256)).astype(np.float32)
            svc.build(name, xs[name], ids=np.arange(2000) + 10_000 * i)
        reqs = [(n, xs[n][:b] + 0.01) for n, b in zip("abc", (1, 3, 6))]
        want = [svc.query(n, q, path=path) for n, q in reqs]
        scan = q8 if store_dtype == "int8" and path == "full_scan" else ss
        before = {m: (m.launches.value, m.launches_by_lanes["G>1"].value)
                  for m in (ss, q8)}
        got = svc.query_many(reqs, path=path)
        steps = 1 if path == "full_scan" else 1 + 6
        for m in (ss, q8):
            n_lanes = m.launches_by_lanes["G>1"].value - before[m][1]
            n_all = m.launches.value - before[m][0]
            assert n_lanes == n_all            # every scan a lane launch
            if m is scan and path == "full_scan":
                assert n_all == 1
        if path == "probed":
            probe = q8 if store_dtype == "int8" else ss
            assert (ss.launches.value - before[ss][0]) + (
                q8.launches.value - before[q8][0]) == steps
            assert probe.launches.value - before[probe][0] >= 6
        for (gi, gs), (wi, ws) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# residency tiers: HOT on the card, WARM in host memory, COLD on disk
# ---------------------------------------------------------------------------

def _resident_service(tmp_path, store_dtype, names=("a",)):
    from repro_torch.api import MemoryService
    cfg = EngineConfig(dim=256, n_clusters=128, list_capacity=32, nprobe=8,
                       k=4, kmeans_iters=3, store_dtype=store_dtype,
                       rescore_k=32)
    rng = np.random.default_rng(3)
    svc = MemoryService(maintenance=False, residency_dir=str(tmp_path))
    xs = {}
    for i, name in enumerate(names):
        svc.create_collection(name, cfg, seed=i)
        xs[name] = rng.standard_normal((2000, 256)).astype(np.float32)
        svc.build(name, xs[name], ids=np.arange(2000) + 10_000 * i)
    return svc, xs


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_warm_and_cold_round_trips_are_bitwise_on_the_card(dev, tmp_path,
                                                          store_dtype):
    svc, xs = _resident_service(tmp_path, store_dtype)
    try:
        coll = svc.collection("a")
        reqs = [(xs["a"][:1] + 0.01, "probed"), (xs["a"][:8] + 0.01, None)]
        want = [svc.query("a", q, path=p) for q, p in reqs]
        before = [None if t is None else t.clone() for t in coll.snapshot()]
        for tier in ("warm", "cold", "warm"):
            assert svc.demote("a", tier=tier) == tier
            assert coll.snapshot() is None
            for (q, p), (wi, ws) in zip(reqs, want):
                gi, gs = svc.query("a", q, path=p)    # promotes first
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gs, ws)
            after = coll.snapshot()
            for a, b in zip(after, before):
                assert (a is None) == (b is None)
                if b is not None:
                    assert a.is_cuda and a.dtype == b.dtype
                    assert a.is_contiguous() and torch.equal(a, b)
    finally:
        svc.shutdown()


def test_demote_frees_the_state_on_the_card(dev, tmp_path):
    svc, xs = _resident_service(tmp_path, "float32")
    try:
        coll = svc.collection("a")
        svc.query("a", xs["a"][:1] + 0.01)
        nb = coll.index_nbytes()
        for tier in ("warm", "cold"):
            svc.promote("a")
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            svc.demote("a", tier=tier)
            assert before - torch.cuda.memory_allocated() >= 0.95 * nb
    finally:
        svc.shutdown()


def test_warm_copy_is_page_locked(dev, tmp_path):
    """The design keeps a WARM state in page-locked host memory (PERF.md,
    residency): every leaf pinned, on the CPU, the same bytes."""
    svc, _ = _resident_service(tmp_path, "int8")
    try:
        coll = svc.collection("a")
        hot = [None if t is None else t.cpu() for t in coll.snapshot()]
        svc.demote("a")
        for h, t in zip(coll._host_state, hot):
            assert (h is None) == (t is None)
            if t is not None:
                assert h.device.type == "cpu" and h.is_pinned()
                assert torch.equal(h, t)
    finally:
        svc.shutdown()


def test_promotion_races_queries_on_another_tenant(dev, tmp_path):
    """Tenant a is demoted and promoted over and over on one scheduler
    worker while another worker serves queries on tenant b: every answer
    of both is exact."""
    import threading
    svc, xs = _resident_service(tmp_path, "float32", names=("a", "b"))
    try:
        qa, qb = xs["a"][:1] + 0.01, xs["b"][:1] + 0.01
        want_a, want_b = svc.query("a", qa), svc.query("b", qb)
        errors, stop = [], threading.Event()

        def churn():
            try:
                while not stop.is_set():
                    svc.demote("a")
                    assert svc.promote("a") == "hot"
                    got = svc.query("a", qa)
                    np.testing.assert_array_equal(got[0], want_a[0])
                    np.testing.assert_array_equal(got[1], want_a[1])
            except BaseException as e:   # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=churn)
        t.start()
        for _ in range(200):
            got = svc.query("b", qb)
            np.testing.assert_array_equal(got[0], want_b[0])
            np.testing.assert_array_equal(got[1], want_b[1])
        stop.set()
        t.join(timeout=120)
        assert not t.is_alive() and not errors, errors
        assert svc.stats()["residency"]["promotions"] > 0
    finally:
        svc.shutdown()


# ---------------------------------------------------------------------------
# recall-adaptive routing: the probe keeps its snapshot on the card
# ---------------------------------------------------------------------------

def _routing_service(cfg, n, seed=0):
    from repro_torch.api import MemoryService
    svc = MemoryService(maintenance=False)
    svc.create_collection("r", cfg)
    x = np.random.default_rng(seed).standard_normal((n, cfg.dim)) \
        .astype(np.float32)
    svc.build("r", x)
    return svc, x


@pytest.mark.parametrize("policy", ["ivf", "flat"])
@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_probe_never_copies_the_state_to_the_host(dev, monkeypatch, policy,
                                                  store_dtype):
    """The reference's probe brings the flat rows to the host; the port's
    keeps them, the oracle and the served path on the card."""
    from repro_torch.core import index as ivf

    def refuse(state):
        raise AssertionError("recall_probe copied the state to the host")

    cfg = EngineConfig(dim=256, n_clusters=128, list_capacity=32, nprobe=2,
                       k=8, kmeans_iters=3, target_recall=0.9,
                       index_policy=policy, store_dtype=store_dtype,
                       rescore_k=32)
    svc, _ = _routing_service(cfg, 2000)
    try:
        monkeypatch.setattr(ivf, "flat_rows_host", refuse)
        before = ss.launches.value + q8.launches.value
        out = svc.collection("r").recall_probe()
        assert out["recall"] is not None and out["sample"] == 64
        assert out["path"] == ("probed" if policy == "ivf" else "full_scan")
        assert ss.launches.value + q8.launches.value > before
    finally:
        svc.shutdown()


def test_oracle_ids_do_not_depend_on_tf32(dev):
    """Rows closer to the queries than TF32's 10 mantissa bits resolve:
    the oracle ranks them the same with TF32 on and off, and as on the
    CPU."""
    from repro_torch.core import metrics
    q = torch.nn.functional.normalize(_randn(dev, 16, 1024, seed=4), dim=1)
    noise = _randn(dev, 16, 512, 1024, seed=5) * 1e-4
    rows = (q[:, None, :] + noise).reshape(-1, 1024)
    ids = torch.arange(rows.shape[0], device=dev)
    got = {}
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got[tf32] = metrics.brute_force_topk(q, rows, ids, 32, device=dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    cpu = metrics.brute_force_topk(q.cpu(), rows.cpu(), ids.cpu(), 32,
                                   device="cpu")
    np.testing.assert_array_equal(got[True], got[False])
    np.testing.assert_array_equal(got[False], cpu)


@pytest.mark.parametrize("nprobe", [1, 3, 27, 48, 1024])
def test_probed_query_at_tuned_nprobe_matches_plain(dev, nprobe):
    """The probed template at the knob values the tuner visits (doubling,
    the 3/4 back-off's odd values, all of C) on the card, against the plain
    versions on the same state on the CPU."""
    from repro_torch.convert import ivf_state_from_numpy, ivf_state_to_numpy
    from repro_torch.core import index as ivf
    cfg = EngineConfig(dim=256, n_clusters=1024, list_capacity=8, nprobe=8,
                       k=16, kmeans_iters=2)
    x = _randn(dev, 6000, 256, seed=6)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = ivf.build(gen, x, torch.arange(6000, dtype=torch.int32,
                                              device=dev), cfg,
                         spill_capacity=512)
    host = ivf_state_from_numpy(ivf_state_to_numpy(state), device="cpu")
    q = x[:4] + 0.05 * _randn(dev, 4, 256, seed=7)
    before = ss.launches.value
    ids, scores = ivf.query_probed(state, q, cfg, cfg.k, nprobe)
    assert ss.launches.value - before == 1 + 4
    want_ids, want_scores = ivf.query_probed(host, q.cpu(), cfg, cfg.k,
                                             nprobe)
    np.testing.assert_array_equal(ids.cpu().numpy(), want_ids.numpy())
    torch.testing.assert_close(scores.cpu(), want_scores, rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# replication on the card
# ---------------------------------------------------------------------------

def _replicated(store_dtype, n_replicas=2):
    from repro_torch.api import MemoryService, ReplicaSet
    cfg = EngineConfig(dim=256, n_clusters=128, list_capacity=32, nprobe=8,
                       k=4, kmeans_iters=3, store_dtype=store_dtype,
                       rescore_k=32)
    rs = ReplicaSet(MemoryService(maintenance=False), n_replicas=n_replicas,
                    ship_batch=3)
    rs.create_collection("m", cfg, seed=5)
    return rs


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_caught_up_replicas_equal_the_primary_leaf_for_leaf(dev, store_dtype):
    rs = _replicated(store_dtype)
    try:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2000, 256)).astype(np.float32)
        before = ka.launches.value
        rs.build("m", x)
        rs.pump()
        for i in range(4):
            rs.insert("m", torch.randn(64, 256, device=dev),
                      ids=np.arange(5000 + 64 * i, 5064 + 64 * i))
        rs.delete("m", np.arange(0, 300, 3))
        rs.pump(max_batches=1)
        rs.insert("m", rng.standard_normal((32, 256)).astype(np.float32))
        rs.pump()
        # the replicas built with the card's kernels too
        assert ka.launches.value - before >= 3 * (1 + 4 + 1)
        prim = rs.primary.collection("m").snapshot()
        q = torch.from_numpy(x[1:9]).to(dev)
        want = [rs.primary.query("m", q[:1]), rs.primary.query("m", q)]
        for rep in rs.replicas:
            st = rep.service.collection("m").snapshot()
            for f, a, b in zip(st._fields, st, prim):
                assert (a is None) == (b is None), f
                assert a is None or (a.is_cuda and torch.equal(a, b)), f
            got = [rep.service.query("m", q[:1]), rep.service.query("m", q)]
            for (gi, gs), (wi, ws) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gs, ws)
    finally:
        rs.shutdown()


def test_ship_payload_is_one_private_host_copy_on_the_card(dev):
    rs = _replicated("float32", n_replicas=1)
    try:
        rng = np.random.default_rng(1)
        rs.build("m", rng.standard_normal((2000, 256)).astype(np.float32))
        coll = rs.primary.collection("m")
        log = rs._logs["m"]
        x = torch.randn(64, 256, device=dev)           # device rows: a D2H
        rs.insert("m", x, ids=torch.arange(9000, 9064, device=dev))
        h = rng.standard_normal((8, 256)).astype(np.float32)  # host rows
        rs.insert("m", h)
        (e1, e2) = log.tail(1)
        np.testing.assert_array_equal(e1.rows, x.cpu().numpy())
        np.testing.assert_array_equal(e1.ids, np.arange(9000, 9064))
        np.testing.assert_array_equal(e2.rows, h)
        assert not np.shares_memory(e2.rows, h)
        st = coll.snapshot()
        rows = torch.cat([st.lists.reshape(-1, 256), st.spill])
        slot = torch.isin(torch.cat([st.list_ids.reshape(-1), st.spill_ids]),
                          torch.from_numpy(e1.ids).to(dev))
        got = torch.sort(rows[slot].cpu(), 0).values     # lists and spill
        assert torch.equal(got, torch.sort(torch.from_numpy(e1.rows), 0).values)
        kept = (e1.rows.copy(), e2.rows.copy())
        x.zero_()                                      # the caller reuses
        h[:] = 0
        np.testing.assert_array_equal(e1.rows, kept[0])
        np.testing.assert_array_equal(e2.rows, kept[1])
        assert torch.equal(coll.snapshot().lists, st.lists)
        for e in (e1, e2):
            assert isinstance(e.rows, np.ndarray) and e.rows.flags.writeable
    finally:
        rs.shutdown()


def test_replica_services_sit_on_the_primary_card(dev):
    rs = _replicated("float32")
    try:
        assert rs.primary.device.type == "cuda"
        for rep in rs.replicas:
            assert rep.service.device == rs.primary.device
            assert rep.service.collection("m").device == rs.primary.device
        rs.build("m", np.random.default_rng(2).standard_normal(
            (2000, 256)).astype(np.float32))
        rs.pump()
        rs.kill_primary()
        out = rs.failover()
        assert out["replayed"] == 0
        assert rs.primary.collection("m").snapshot().lists.is_cuda
    finally:
        rs.shutdown()


# ---------------------------------------------------------------------------
# the mesh-sharded tier: S shards on the one card
# ---------------------------------------------------------------------------

def _sharded(n_shards=4, names=("a",), n=4000, **kw):
    from repro_torch.api import MemoryService
    from repro_torch.core.distributed import make_mesh
    mesh = make_mesh((n_shards,), ("shard",))
    cfg = EngineConfig(dim=256, n_clusters=128, list_capacity=32, nprobe=8,
                       k=8, kmeans_iters=3, shard_db=True, rescore_k=32,
                       **kw)
    rng = np.random.default_rng(4)
    svc = MemoryService(maintenance=False)
    xs = {}
    for i, name in enumerate(names):
        svc.create_collection(name, cfg, mesh=mesh, seed=i)
        xs[name] = rng.standard_normal((n, 256)).astype(np.float32)
        svc.build(name, xs[name], ids=np.arange(n) + 100_000 * i)
    return svc, mesh, xs


def test_sharded_answer_is_the_global_topk_of_the_kernel_scores(dev):
    """Each shard's full scan is one `scan_scores` launch; the merged answer
    equals a plain global top-k (ties to the lower position) over the
    per-shard kernel scores, concatenated in shard order."""
    from repro_torch.core import index as ivf
    svc, mesh, xs = _sharded()
    with svc:
        q = torch.from_numpy(xs["a"][:16] + 0.01).to(dev)
        before = ss.launches.value
        ids, scores = svc.query("a", q, k=8)
        assert ss.launches.value - before == mesh.size
        state = svc.collection("a").snapshot()
        assert all(st.device.type == "cuda" for st in state)
        assert all(st.centroids is state[0].centroids for st in state)
        sc, fid = [], []
        for st in state:
            rows, i = ivf._flat_rows(st)
            sc.append(ss.scan_scores(q, rows, i, None, metric="ip"))
            fid.append(i)
        sc, fid = torch.cat(sc, 1), torch.cat(fid)
        pos = torch.sort(sc, dim=1, descending=True, stable=True).indices[:, :8]
        np.testing.assert_array_equal(ids, fid[pos].cpu().numpy())
        np.testing.assert_array_equal(scores,
                                      sc.gather(1, pos).cpu().numpy())
        assert (ids[:, 0] == np.arange(16)).all()


def test_shard_rebuild_leaves_sibling_storage_untouched(dev):
    svc, mesh, xs = _sharded()
    with svc:
        coll = svc.collection("a")
        svc.delete("a", np.arange(0, 4000, 3))
        before = coll.snapshot()
        h = int(np.argmax([int(st.num_deleted) for st in before]))
        v0 = coll.shard_versions()
        out = svc.rebuild("a", shard=h)
        assert not out["aborted"]
        after = coll.snapshot()
        for s in range(mesh.size):
            if s == h:
                assert int(after[s].num_deleted) == 0
                continue
            assert coll.shard_versions()[s] == v0[s]
            for a, b in zip(before[s], after[s]):
                if a is not None:
                    assert a.data_ptr() == b.data_ptr() and torch.equal(a, b)


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_fused_sharded_window_is_bit_equal_on_the_card(dev, store_dtype):
    """Three sharded tenants in one window: one dispatch, every shard's
    scan one lane launch, each answer bit-equal to the tenant's own query.
    The path is named: the router would send B=1 elsewhere than B=3, which
    splits the signature, although the sharded tier full-scans both."""
    svc, mesh, xs = _sharded(names=("a", "b", "c"), n=2000,
                             store_dtype=store_dtype)
    with svc:
        reqs = [(n, xs[n][:b] + 0.01) for n, b in zip("abc", (1, 3, 6))]
        want = [svc.query(n, q, path="full_scan") for n, q in reqs]
        scan = q8 if store_dtype == "int8" else ss
        before = (scan.launches.value, scan.launches_by_lanes["G>1"].value)
        got = svc.query_many(reqs, path="full_scan")
        assert scan.launches.value - before[0] == mesh.size
        assert scan.launches_by_lanes["G>1"].value - before[1] == mesh.size
        for (gi, gs), (wi, ws) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gs, ws)


# ---------------------------------------------------------------------------
# the RAG serving path on the card
# ---------------------------------------------------------------------------

def _serving_model(dev, dtype="bfloat16", arch="granite-3-2b", **widths):
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.reduced_arch(arch).replace(dtype=dtype, **widths)
    return cfg, lm.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)


def test_serving_path_launches_the_stream_scan_and_no_f32_weights(dev):
    """RAG prefill + decode on the card: the retrieval is one `scan_scores`
    launch in its stream variant per turn, its ids equal the plain
    version's; the model holds bf16 matrices (f32 norm scales only) and
    no f32 master copy, and a decode step writes its caches in place and
    casts no weight matrix to f32 (its transient peak stays below the f32
    bytes of one MLP matrix)."""
    from repro_torch.launch import serve
    from repro_torch.models import api, lm
    from repro_torch.serving import rag, serve_step
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg, params = _serving_model(dev, num_layers=4, d_model=1024, d_ff=4096,
                                 num_heads=16, num_kv_heads=4, head_dim=64)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    for n, p in params.named_parameters():
        assert p.dtype == (torch.float32 if p.dim() == 1
                           else torch.bfloat16), n
    assert torch.cuda.memory_allocated() - base < weights + (1 << 20)

    batch = api.synth_batch(torch.Generator(device=dev).manual_seed(3), cfg,
                            "prefill", 4, 32)
    tok, caches, pos = serve_step.make_prefill(cfg, 48)(params, batch)
    decode = serve_step.make_decode(cfg)
    pos = pos + 1
    tok, caches = decode(params, tok, caches, pos)       # warm (workspace)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k_ptr = caches.k.data_ptr()
    for _ in range(3):
        pos = pos + 1
        tok, caches = decode(params, tok, caches, pos)
    torch.cuda.synchronize()
    assert caches.k.data_ptr() == k_ptr
    assert torch.cuda.memory_allocated() - held < (1 << 20)
    assert torch.cuda.max_memory_allocated() - held < 4 * cfg.d_model * cfg.d_ff
    del caches

    ecfg = EngineConfig(dim=cfg.d_model, n_clusters=128, list_capacity=64,
                        nprobe=16, k=4)
    corpus = torch.nn.functional.normalize(_randn(dev, 4096, cfg.d_model), 1)
    svc, mem, _ = serve.build_memory(ecfg, corpus, device=dev)
    checked = []

    def on_turn(turn, snap, batch, ids):
        q = rag.embed_query(params, cfg, batch["tokens"])
        plain = rag.retrieve(snap, q, dataclasses.replace(
            ecfg, use_kernel=False), 4)[0]
        assert torch.equal(plain, ids)
        checked.append(turn)

    try:
        before = ss.launches_by_variant["stream"].value
        out = serve.serve(cfg, ecfg, params, svc, mem, requests=4,
                          prompt_len=32, decode_steps=4, turns=2,
                          inserts=corpus[:64], on_turn=on_turn)
        assert ss.launches_by_variant["stream"].value - before == 2
        assert checked == [0, 1] and out["insert_rows"] == 64
    finally:
        serve.close(svc)


def test_decode_matches_forward_on_the_card(dev):
    """Decode logits == forward_train's at each position, float32, TF32
    off, at the reference's 2e-3, for the dense archs' flags."""
    from repro_torch.models import lm
    for arch in ("granite-3-2b", "stablelm-12b", "gemma2-9b"):
        cfg, params = _serving_model(dev, "float32", arch)
        tokens = torch.randint(0, cfg.vocab_size, (2, 8), device=dev,
                               dtype=torch.int32,
                               generator=torch.Generator(device=dev)
                               .manual_seed(2))
        full, _ = lm.forward_train(params, cfg, {"tokens": tokens})
        last, caches, pos = lm.prefill(params, cfg, {"tokens": tokens[:, :4]},
                                       16)
        torch.testing.assert_close(last, full[:, 3], rtol=2e-3, atol=2e-3)
        for t in range(4, 8):
            logits, caches = lm.decode_step(
                params, cfg, tokens[:, t: t + 1], caches,
                torch.full((2,), t, dtype=torch.int32, device=dev))
            torch.testing.assert_close(logits, full[:, t], rtol=2e-3,
                                       atol=2e-3)


def test_projected_rag_prefill_ids_equal_plain_on_the_card(dev):
    """dim != d_model: the projections live on the card and the kernel's
    retrieved ids equal the plain version's."""
    from repro_torch.core import index as ivf
    from repro_torch.serving import rag
    cfg, params = _serving_model(dev)
    ecfg = EngineConfig(dim=256, n_clusters=128, list_capacity=64, nprobe=16,
                        k=4)
    mem = torch.nn.functional.normalize(_randn(dev, 3000, 256, seed=5), 1)
    state, _ = ivf.build(torch.Generator(device=dev).manual_seed(1), mem,
                         torch.arange(3000, dtype=torch.int32, device=dev),
                         ecfg)
    step = rag.make_rag_prefill(cfg, ecfg, 40, k=4)
    assert step.proj.device.type == "cuda"
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), device=dev,
                           dtype=torch.int32)
    logits, caches, pos, ids = step(params, state, {"tokens": tokens})
    q = step.query(params, tokens)
    plain = ivf.query_full_scan_rows(
        state, q, dataclasses.replace(ecfg, use_kernel=False), 4)[0]
    assert torch.equal(plain, ids)
    assert bool(torch.isfinite(logits.float()).all())


def test_each_kernel_launch_lies_in_its_span(dev):
    """Under a profiler, each hand-written kernel's device work is launched
    inside its ``ame.kernel.<kernel>`` range on the calling thread."""
    from torch.profiler import ProfilerActivity, profile
    x = _randn(dev, 300, 256)
    c = _randn(dev, 128, 256, seed=1)
    ids = torch.arange(300, dtype=torch.int32, device=dev)
    codes = torch.randint(-127, 128, (300, 256), device=dev, dtype=torch.int8)
    ones = torch.ones(300, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ss.scan_scores(x[:4].contiguous(), x, ids)
        qc, sq = ref.quantize_queries(x[:4].contiguous())
        q8.scan_scores_q8(qc, codes, ids, ones, 0 * ones, sq,
                          ref.query_corr(qc, sq))
        assign, _ = ka.kmeans_assign(x, c)
        sg.segsum_gemm(x, assign, n_clusters=128)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    kernels = {e.correlation_id() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()}
    for name in ("scan_scores", "scan_scores_q8", "kmeans_assign",
                 "segsum_gemm"):
        rng = [e for e in events if e.name() == f"ame.kernel.{name}"
               and e.device_type() == torch.autograd.DeviceType.CPU]
        assert len(rng) == 1, name
        r = rng[0]
        inside = [e for e in events if e.name().startswith(("cuda", "cu"))
                  and e.start_thread_id() == r.start_thread_id()
                  and r.start_ns() <= e.start_ns()
                  <= r.start_ns() + r.duration_ns()]
        assert any(e.correlation_id() in kernels for e in inside), name


# ---------------------------------------------------------------------------
# the full scan over the store in place: rows in two segments

# (g, n1, n2, d): PAPER_1M's list tier (1024 x 1464 slots) and spill tier,
# a ragged list tier (N1 not a multiple of the 128-row tile) beside a
# spill under one tile, one under a tile on each side, and lanes
_SEGMENTS = [(1, 1_499_136, 4096, 1024), (1, 1000, 300, 1024),
             (1, 15, 7, 256), (3, 1000, 130, 1024), (2, 11_712, 4096, 1024)]


def _segments(dev, g, b, n1, n2, d, metric):
    """q, each segment's (rows, ids, l2 norms) in allocations of its own,
    and the flat (rows, ids, norms) over their N1 + N2 slots (~10 %
    holes)."""
    lead = (g,) if g > 1 else ()
    q = _randn(dev, *lead, b, d, seed=31)
    gen = torch.Generator(device=dev).manual_seed(34)
    segs = []
    for n, seed in ((n1, 32), (n2, 33)):
        rows = _randn(dev, *lead, n, d, seed=seed)
        ids = torch.arange(n, dtype=torch.int32, device=dev).repeat(*lead, 1)
        ids += seed * 100_000
        ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.1] = -1
        segs.append((rows, ids, (rows ** 2).sum(-1) if metric == "l2"
                     else None))
    (db, ids, norms), (db2, ids2, norms2) = segs
    flat = (torch.cat([db, db2], dim=-2), torch.cat([ids, ids2], dim=-1),
            None if norms is None else torch.cat([norms, norms2], dim=-1))
    return q, segs, flat


def _two_segment(q, segs, metric, **kw):
    (db, ids, norms), (db2, ids2, norms2) = segs
    return ss.scan_scores(q, db, ids, norms, metric=metric, db2=db2,
                          ids2=ids2, db2_norms=norms2, **kw)


@pytest.mark.parametrize("shape", _SEGMENTS)
@pytest.mark.parametrize("b", [2, 8, 64])
@pytest.mark.parametrize("variant", ["stream", "generic"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_two_segment_scan_bit_equals_the_flat_launch(dev, shape, b, variant,
                                                     metric):
    """A launch over the two segments gives the bits of a launch over their
    concatenation, in both variants, and counts as one two-segment
    launch."""
    g, n1, n2, d = shape
    q, segs, flat = _segments(dev, g, b, n1, n2, d, metric)
    want = ss.scan_scores(q, *flat, metric=metric, _variant=variant)
    del flat
    before = (ss.launches_by_variant[variant].value,
              ss.launches_two_segment.value)
    got = _two_segment(q, segs, metric, _variant=variant)
    assert (ss.launches_by_variant[variant].value,
            ss.launches_two_segment.value) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _scan_grids(fn):
    """(grid x, y, z) of each scan kernel that fn() launches, read from the
    profiler's trace."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        trace = json.load(open(f.name))
    return [tuple(e["args"]["grid"]) for e in trace["traceEvents"]
            if e.get("cat") == "kernel" and "scan_scores" in e["name"]]


def test_one_segment_launch_keeps_its_grid(dev):
    """An empty second segment is the one-segment launch (no two-segment
    count, the same bits), and the persistent grid covers each segment's
    own tiles: min(the card's width, T1 + T2) blocks."""
    q, segs, flat = _segments(dev, 1, 8, 1000, 130, 1024, "ip")
    (db, ids, _), (db2, ids2, _) = segs
    wide = _randn(dev, 200_000, 1024, seed=35)
    wide_ids = torch.arange(200_000, dtype=torch.int32, device=dev)
    (width, *_), = _scan_grids(lambda: ss.scan_scores(q, wide, wide_ids))
    assert width < 200_000 // 128
    before = ss.launches_two_segment.value
    grids = _scan_grids(lambda: (
        ss.scan_scores(q, db, ids),
        ss.scan_scores(q, db, ids, db2=db2[:0], ids2=ids2[:0]),
        ss.scan_scores(q, db, ids, db2=db2, ids2=ids2),
        ss.scan_scores(q, flat[0], flat[1])))
    assert ss.launches_two_segment.value == before + 1
    t1, t2 = -(-1000 // 128), -(-130 // 128)
    assert [x for x, _, _ in grids] == [min(width, t1), min(width, t1),
                                        min(width, t1 + t2),
                                        min(width, -(-1130 // 128))]
    assert len(set(grids[:2])) == 1
    assert torch.equal(
        ss.scan_scores(q, db, ids, db2=db2[:0], ids2=ids2[:0]),
        ss.scan_scores(q, db, ids))


@pytest.mark.parametrize("b", [8, 64])
def test_full_scan_allocates_no_flat_copy(dev, b):
    """query_full_scan at PAPER_1M raises the peak of allocated memory by
    less than a tenth of the store's rows: no [C*L + S, D] temporary."""
    from repro_torch.configs.ame_paper import PAPER_1M
    from repro_torch.core import index as ivf
    c, l = PAPER_1M.n_clusters, PAPER_1M.list_capacity
    st = ivf.empty_state(PAPER_1M, 4096, device=dev)
    st.lists.normal_()
    st.spill.normal_()
    st.list_ids.copy_(torch.arange(c * l, dtype=torch.int32,
                                   device=dev).view(c, l))
    q = _randn(dev, b, PAPER_1M.dim, seed=36)
    ivf.query_full_scan(st, q, PAPER_1M, 10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ids, _ = ivf.query_full_scan(st, q, PAPER_1M, 10)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert rise < 0.1 * (st.lists.nbytes + st.spill.nbytes), rise
    assert bool((ids >= 0).all())


def test_two_segment_counter_counts_full_scans_only(dev):
    """``launches.scan_scores.two_segment`` moves by one a full scan and
    not for a probed query's centroid and slab scans."""
    from repro_torch.api import MemoryService
    cfg = EngineConfig(dim=256, n_clusters=128, list_capacity=32, nprobe=8,
                       k=4, kmeans_iters=3)
    x = np.random.default_rng(1).standard_normal((2000, 256)).astype(
        np.float32)
    key = "launches.scan_scores.two_segment"
    with MemoryService(maintenance=False) as svc:
        svc.create_collection("m", cfg)
        svc.build("m", x)
        c0, s0 = svc.counters()[key], ss.launches.value
        svc.query("m", x[:1] + 0.01)                    # probed
        c1, s1 = svc.counters()[key], ss.launches.value
        assert (c1, s1) == (c0, s0 + 2)                 # centroids + slab
        for _ in range(3):
            svc.query("m", x[:8] + 0.01)                # full scan
        c2, s2 = svc.counters()[key], ss.launches.value
        assert (c2, s2) == (c1 + 3, s1 + 3)


def _in_a_fresh_thread(fn):
    """fn() on a new thread, which has done no CUDA work before it."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in out, out["error"]
    return out["value"]


@pytest.mark.parametrize("segments", [1, 2])
def test_scan_launches_from_a_thread_that_launched_nothing(dev, segments):
    """A stream launch encodes its tensor maps on the calling thread, which
    may have no current context yet: a service worker whose first task is
    a full scan over views of the store launches nothing before the scan.
    With the output's block in the allocator's cache, the scan is that
    thread's first CUDA work; it must run, and give the main thread's
    bits (both scans)."""
    q, segs, _ = _segments(dev, 1, 8, 3000, 300, 1024, "ip")
    (db, ids, _), (db2, ids2, _) = segs
    kw = dict(db2=db2, ids2=ids2) if segments == 2 else {}
    args = _q8_operands(dev, 8, 3000, 1024, "ip")
    for fn in (lambda: ss.scan_scores(q, db, ids, **kw),
               lambda: q8.scan_scores_q8(*args)):
        want = fn()
        torch.cuda.synchronize()
        spare = torch.empty_like(want)
        del spare                 # cached: the fresh thread allocates nothing
        assert torch.equal(_in_a_fresh_thread(fn), want)
