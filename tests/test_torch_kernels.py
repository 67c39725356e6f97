"""Port parity: the plain versions of the Hopper kernels (what a CPU tensor
runs in `repro_torch`) against the JAX package's Pallas kernels in interpret
mode, on the shapes and with the tolerances of tests/test_kernels.py.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import kmeans_assign as t_assign
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scan_scores as t_scan
from repro_torch.kernels import segsum_gemm as t_segsum

jax.config.update("jax_platform_name", "cpu")

BLOCKS = dict(block_m=8, block_n=128, block_k=128)


def _randn(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# scan_scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,d", [
    (4, 100, 64), (128, 512, 512), (1, 1000, 256), (33, 777, 192),
    (5, 300, 130),
])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_scan_scores_plain_matches_pallas(b, n, d, metric):
    q, db = _randn(0, (b, d)), _randn(1, (n, d))
    ids = np.arange(n, dtype=np.int32)
    ids[::7] = -1                                     # tombstoned slots
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    norms = norms if metric == "l2" else None
    want = jops.scan_scores(*map(jnp.asarray, (q, db, ids)),
                            None if norms is None else jnp.asarray(norms),
                            metric=metric, use_kernel=True, interpret=True,
                            **BLOCKS)
    got = t_scan.scan_scores(torch.from_numpy(q), torch.from_numpy(db),
                             torch.from_numpy(ids),
                             None if norms is None else torch.from_numpy(norms),
                             metric=metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_scan_scores_masks_tombstones():
    q, db = _randn(2, (8, 128)), _randn(3, (256, 128))
    ids = np.where(np.arange(256) % 3 == 0, -1, np.arange(256)).astype(np.int32)
    for metric, masked in (("ip", -np.inf), ("l2", np.inf)):
        got = tops.scan_scores(torch.from_numpy(q), torch.from_numpy(db),
                               torch.from_numpy(ids), metric=metric).numpy()
        assert np.all(got[:, ::3] == masked)
        assert np.all(np.isfinite(got[:, 1::3]))
        want = np.asarray(jref.scan_scores_ref(
            jnp.asarray(q), jnp.asarray(db), jnp.asarray(ids), metric=metric))
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_scan_scores_unfused_baseline_matches(use_kernel):
    """fused_conversion=False materialises the bf16 copy first; the port's
    dispatch agrees with the reference's on both sides of use_kernel."""
    q, db = _randn(4, (16, 256)), _randn(5, (512, 256))
    ids = np.arange(512, dtype=np.int32)
    want = jops.scan_scores(*map(jnp.asarray, (q, db, ids)),
                            fused_conversion=False, use_kernel=use_kernel,
                            interpret=True, **BLOCKS)
    got = tops.scan_scores(*map(torch.from_numpy, (q, db, ids)),
                           fused_conversion=False, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# kmeans_assign
# ---------------------------------------------------------------------------

def _margin(x, cent):
    """best-vs-second distance margin per row in the kernel's arithmetic."""
    dots =tref.round_bf16(torch.from_numpy(x)) @ tref.round_bf16(
        torch.from_numpy(cent)).T
    d = (torch.from_numpy(cent) ** 2).sum(1)[None, :] - 2.0 * dots
    two = torch.topk(d, min(2, d.shape[1]), dim=1, largest=False).values
    if two.shape[1] == 1:
        return np.full(x.shape[0], np.inf)
    return (two[:, 1] - two[:, 0]).numpy()


@pytest.mark.parametrize("m,c,d", [(64, 8, 64), (500, 128, 256),
                                   (1000, 96, 128), (77, 130, 96),
                                   (40, 136, 2048)])    # the serving dim
def test_kmeans_assign_plain_matches_pallas(m, c, d):
    x, cent = _randn(6, (m, d)), _randn(7, (c, d))
    jidx, jdist = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(cent),
                                     use_kernel=True, interpret=True,
                                     block_m=8, block_c=128, block_k=128)
    idx, dist = t_assign.kmeans_assign(torch.from_numpy(x),
                                       torch.from_numpy(cent))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                               rtol=3e-2, atol=3e-2)
    sure = _margin(x, cent) > 3e-2
    np.testing.assert_array_equal(idx.numpy()[sure], np.asarray(jidx)[sure])
    assert np.all((idx.numpy() >= 0) & (idx.numpy() < c))


def test_kmeans_assign_exact_on_separated_clusters():
    c, d, per = 16, 128, 32
    cent = _randn(8, (c, d), scale=20.0)
    x = np.repeat(cent, per, axis=0) + _randn(9, (c * per, d), scale=0.05)
    idx, _ = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cent))
    jidx, _ = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(cent),
                                 interpret=True, block_m=8, block_c=128,
                                 block_k=128)
    want = np.repeat(np.arange(c, dtype=np.int32), per)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jidx), want)


def test_kmeans_assign_ties_go_to_lowest_index():
    x = _randn(10, (40, 64))
    cent = np.concatenate([x[:3], x[:3]])       # centroids 3..5 repeat 0..2
    idx, _ = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cent))
    assert np.all(idx.numpy() < 3)
    np.testing.assert_array_equal(idx.numpy()[:3], [0, 1, 2])


# ---------------------------------------------------------------------------
# segsum_gemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,c,d", [(100, 8, 64), (512, 128, 256),
                                   (999, 64, 128)])
def test_segsum_plain_matches_pallas(m, c, d):
    x = _randn(11, (m, d))
    a = np.random.default_rng(12).integers(0, c, m).astype(np.int32)
    jsums, jcounts = jops.segsum_gemm(jnp.asarray(x), jnp.asarray(a),
                                      n_clusters=c, interpret=True,
                                      block_m=8, block_c=128, block_d=128)
    sums, counts = t_segsum.segsum_gemm(torch.from_numpy(x),
                                        torch.from_numpy(a), n_clusters=c)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    # the Pallas kernel sums bf16-rounded rows in f32, as the plain version
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums),
                               rtol=1e-4, atol=1e-4)
    # against the f32 oracle only within the bf16 rounding
    rsums, rcounts = jref.segsum_gemm_ref(jnp.asarray(x), jnp.asarray(a),
                                          n_clusters=c)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(rsums),
                               rtol=3e-2, atol=3e-2)


def test_segsum_ignores_out_of_range_assignments():
    x = _randn(13, (300, 64))
    a = np.random.default_rng(14).integers(-3, 40, 300).astype(np.int32)
    jsums, jcounts = jops.segsum_gemm(jnp.asarray(x), jnp.asarray(a),
                                      n_clusters=32, interpret=True,
                                      block_m=8, block_c=128, block_d=128)
    sums, counts = tops.segsum_gemm(torch.from_numpy(x), torch.from_numpy(a),
                                    n_clusters=32)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.sum() == int(((a >= 0) & (a < 32)).sum())
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_segsum_use_kernel_switch_matches_reference(use_kernel):
    """use_kernel=False is the reference's f32 oracle on both sides."""
    x = _randn(15, (200, 128))
    a = np.random.default_rng(16).integers(-1, 16, 200).astype(np.int32)
    jsums, jcounts = jops.segsum_gemm(jnp.asarray(x), jnp.asarray(a),
                                      n_clusters=16, use_kernel=use_kernel,
                                      interpret=True, block_m=8,
                                      block_c=128, block_d=128)
    sums, counts = tops.segsum_gemm(torch.from_numpy(x), torch.from_numpy(a),
                                    n_clusters=16, use_kernel=use_kernel)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# wrappers: device dispatch and launch counters
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    for mod in (t_scan, t_assign, t_segsum):
        mod.launches.reset()
    x = torch.from_numpy(_randn(17, (50, 64)))
    ids = torch.arange(50, dtype=torch.int32)
    t_scan.scan_scores(x[:3], x, ids)
    t_assign.kmeans_assign(x, x[:5])
    t_segsum.segsum_gemm(x, ids % 4, n_clusters=4)
    assert [m.launches.value for m in (t_scan, t_assign, t_segsum)] == [0, 0, 0]


def test_plain_versions_match_their_definition_exactly():
    """The plain versions are the reference's arithmetic in PyTorch: f32
    products of bf16-rounded operands (not bf16 @ bf16, which returns bf16)."""
    q, db = _randn(18, (3, 64)), _randn(19, (20, 64))
    qb = torch.from_numpy(q).to(torch.bfloat16).float()
    dbb = torch.from_numpy(db).to(torch.bfloat16).float()
    got = tref.scan_scores_ref(torch.from_numpy(q), torch.from_numpy(db),
                               torch.arange(20, dtype=torch.int32))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, qb @ dbb.T, rtol=0, atol=0)
