"""Port parity for the int8 store policy: `repro_torch` against the JAX
package on the same numpy inputs, at tests/test_quantized.py's size (D=128,
C=128, L=16), plus the reference's own int8 contracts run on the port.

The JAX side runs its jnp oracles (use_kernel=False) except where the Pallas
q8 kernel itself is the counterpart (interpret mode); the port runs its
kernels' plain versions on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JConfig
from repro.core import index as jivf
from repro.core import kmeans as jkmeans
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.api import MemoryService
from repro_torch.configs.base import EngineConfig
from repro_torch.convert import ivf_state_from_numpy, ivf_state_to_numpy
from repro_torch.core import index as ivf
from repro_torch.core import metrics
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scan_scores_q8 as t_q8

jax.config.update("jax_platform_name", "cpu")

DIM = 128
ARGS = dict(dim=DIM, n_clusters=128, list_capacity=16, nprobe=8, k=4,
            kmeans_iters=2, store_dtype="int8", rescore_k=32)
QCFG = EngineConfig(**ARGS)
FCFG = dataclasses.replace(QCFG, store_dtype="float32")
JQCFG = JConfig(use_kernel=False, **ARGS)
BLOCKS = dict(block_m=8, block_n=128, block_k=128)
Q_FIELDS = ivf._Q_FIELDS


def _corpus(n, seed=0, dim=DIM):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _built(cfg, n=256, seed=0):
    x = torch.from_numpy(_corpus(n, seed=seed))
    ids = torch.arange(n, dtype=torch.int32)
    state, _ = ivf.build(torch.Generator().manual_seed(seed), x, ids, cfg)
    return state, x, ids


def _assert_q_fields(tstate, jstate):
    """The int8 store of two states: codes exact, scalars to f32 rounding."""
    for f in Q_FIELDS:
        got, want = getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f))
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=f)
        elif "norms" in f:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f)


def _assert_f32_fields(tstate, jstate):
    for f in ivf.IVFState._fields[:8]:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def test_quantize_queries_matches_reference():
    q = np.random.default_rng(1).standard_normal((64, DIM)).astype(np.float32)
    q[3] = 0.0                                   # all-zero query: sq floor
    jc, jsq = jref.quantize_queries(jnp.asarray(q))
    tc, tsq = tref.quantize_queries(torch.from_numpy(q))
    assert tc.dtype == torch.int8 and tsq.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tsq.numpy(), np.asarray(jsq))


@pytest.mark.parametrize("tier", ["lists", "rows"])
def test_affine_quantizers_match_reference(tier):
    """Same codes bit for bit (the same f32 operations; no .5 ties differ
    on these inputs), scale/zero to 1e-6 and the dequantized norms to the
    reference's 1e-5 (the norms' sums run in another order)."""
    rng = np.random.default_rng(2)
    if tier == "lists":
        x = rng.standard_normal((128, 16, DIM)).astype(np.float32)
        ids = np.arange(128 * 16, dtype=np.int32).reshape(128, 16)
        ids[:, 11:] = -1
        ids[::3, 2] = -1
        jfn, tfn = jax.jit(jivf._quantize_lists), ivf._quantize_lists
    else:
        x = rng.standard_normal((4096, DIM)).astype(np.float32)
        ids = np.arange(4096, dtype=np.int32)
        ids[::5] = -1
        jfn, tfn = jax.jit(jivf._quantize_rows), ivf._quantize_rows
    jc, js, jz, jn = jfn(jnp.asarray(x), jnp.asarray(ids))
    tc, ts, tz, tn = tfn(torch.from_numpy(x), torch.from_numpy(ids))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the q8 scan: plain version vs the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,d", [(5, 300, 128), (33, 777, 130)])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_q8_scan_plain_matches_pallas_and_oracle(b, n, d, metric):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    ids[::7] = -1                                 # tombstones
    codes, scales, zeros, norms = [np.array(a) for a in jivf._quantize_rows(
        jnp.asarray(rows), jnp.asarray(ids))]
    norms = norms if metric == "l2" else None
    jargs = [jnp.asarray(a) for a in (q, codes, ids, scales, zeros)]
    jn = None if norms is None else jnp.asarray(norms)
    pallas = jops.scan_scores_q8(*jargs, jn, metric=metric, use_kernel=True,
                                 interpret=True, **BLOCKS)
    oracle = jref.scan_scores_q8_ref(*jargs, jn, metric=metric)
    targs = [torch.from_numpy(a) for a in (q, codes, ids, scales, zeros)]
    tn = None if norms is None else torch.from_numpy(norms)
    qc, sq = tref.quantize_queries(targs[0])
    plain = t_q8.scan_scores_q8(qc, *targs[1:], sq, tref.query_corr(qc, sq),
                                tn, metric=metric)
    for got in (plain,
                tops.scan_scores_q8(*targs, tn, metric=metric),
                tops.scan_scores_q8(*targs, tn, metric=metric,
                                    use_kernel=False)):
        assert got.shape == (b, n) and got.dtype == torch.float32
        for want in (pallas, oracle):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_q8_accumulator_is_exact_at_the_extremes():
    """All-127 codes against all-(-127) queries at D = 1024: |acc| is the
    largest this repo meets, and the f64 product holds it exactly."""
    d = 1024
    qc = torch.full((2, d), -127, dtype=torch.int8)
    codes = torch.full((3, d), 127, dtype=torch.int8)
    one = torch.ones(3)
    s = t_q8.scan_scores_q8(qc, codes, torch.arange(3, dtype=torch.int32),
                            one, torch.zeros(3), torch.ones(2), torch.zeros(2))
    assert torch.equal(s, torch.full((2, 3), float(-127 * 127 * d)))


def test_q8_l2_scan_needs_norms():
    x = torch.zeros((2, DIM), dtype=torch.int8)
    with pytest.raises(ValueError, match="norms"):
        t_q8.scan_scores_q8(x, x, torch.zeros(2, dtype=torch.int32),
                            torch.ones(2), torch.zeros(2), torch.ones(2),
                            torch.zeros(2), metric="l2")


# ---------------------------------------------------------------------------
# an int8 state carried across, written on both sides
# ---------------------------------------------------------------------------

def _jax_built(n=600, seed=26):
    x = _corpus(n, seed=seed)
    ids = jnp.arange(n, dtype=jnp.int32)
    st, _ = jivf.build(jax.random.PRNGKey(seed), jnp.asarray(x), ids, JQCFG,
                       spill_capacity=256)
    st = jax.device_get(st)
    return st, ivf_state_from_numpy(st, device="cpu"), x


def test_carried_int8_state_writes_match_reference():
    jstate, tstate, x = _jax_built()
    assert tstate.quantized
    rows = _corpus(48, seed=27)
    new_ids = np.arange(1000, 1048, dtype=np.int32)
    js, jsp = jivf.insert_shared(jstate, jnp.asarray(rows),
                                 jnp.asarray(new_ids), JQCFG)
    ts, tsp = ivf.insert_shared(tstate, torch.from_numpy(rows),
                                torch.from_numpy(new_ids), QCFG)
    js = jax.device_get(js)
    assert int(tsp) == int(jsp)
    _assert_f32_fields(ts, js)
    _assert_q_fields(ts, js)

    gone = np.asarray([0, 5, 1003, 9999], np.int32)
    js, _ = jivf.delete_shared(js, jnp.asarray(gone))
    ts, _ = ivf.delete_shared(ts, torch.from_numpy(gone))
    js = jax.device_get(js)
    _assert_f32_fields(ts, js)
    _assert_q_fields(ts, js)

    # a rebuild is k-means then _pack: fed the reference's clustering (the
    # k-means of its rebuild, same key), the port packs and quantizes the
    # state the reference's rebuild gives
    js = jax.tree.map(jnp.asarray, js)
    jr, _ = jivf.rebuild(jax.random.PRNGKey(8), js, JQCFG)
    frows, fids = jivf._flat_rows(js)
    cent, assign = jkmeans.kmeans(jax.random.PRNGKey(8), frows, fids >= 0,
                                  JQCFG)
    tempty = ivf.empty_state(QCFG, 256, device="cpu")._replace(
        centroids=torch.from_numpy(np.array(cent)))
    tr, _ = ivf._pack(tempty, *(torch.from_numpy(np.array(a))
                                for a in (frows, fids, assign)), QCFG)
    jr = jax.device_get(jr)
    _assert_f32_fields(tr, jr)
    _assert_q_fields(tr, jr)

    log_rows = _corpus(24, seed=28)
    jlog = [jivf.DeltaOp("insert", jnp.asarray(log_rows),
                         jnp.arange(2000, 2024, dtype=jnp.int32)),
            jivf.DeltaOp("delete", None, jnp.asarray([1, 2, 2005],
                                                     jnp.int32))]
    tlog = [ivf.DeltaOp("insert", torch.from_numpy(log_rows),
                        torch.arange(2000, 2024, dtype=torch.int32)),
            ivf.DeltaOp("delete", None,
                        torch.tensor([1, 2, 2005], dtype=torch.int32))]
    jr, jsp, jtomb = jivf.replay(jax.tree.map(jnp.asarray, jr), jlog, JQCFG)
    tr, tsp, ttomb = ivf.replay(tr, tlog, QCFG)
    assert (tsp, ttomb) == (jsp, jtomb)
    jr = jax.device_get(jr)
    _assert_f32_fields(tr, jr)
    _assert_q_fields(tr, jr)
    back = ivf_state_to_numpy(tr)
    assert back.q_lists.dtype == np.int8 and back.q_spill.dtype == np.int8


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("path", ["full_scan", "probed"])
def test_int8_queries_on_carried_state_match_reference(metric, path):
    jcfg = dataclasses.replace(JQCFG, metric=metric)
    tcfg = dataclasses.replace(QCFG, metric=metric)
    jstate, tstate, x = _jax_built()
    q = x[:6] + 0.05 * _corpus(6, seed=30)
    if path == "full_scan":
        jids, jsc = jivf.query_full_scan(jstate, jnp.asarray(q), jcfg, 5)
        tids, tsc = ivf.query_full_scan(tstate, torch.from_numpy(q), tcfg, 5)
    else:
        jids, jsc = jivf.query_probed(jstate, jnp.asarray(q), jcfg, 5, 8)
        tids, tsc = ivf.query_probed(tstate, torch.from_numpy(q), tcfg, 5, 8)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tids.numpy()[:, 0], np.arange(6))


# ---------------------------------------------------------------------------
# the reference's int8 contracts (tests/test_quantized.py) on the port
# ---------------------------------------------------------------------------

def test_affine_roundtrip_error_bound():
    state, _, _ = _built(QCFG, n=300, seed=1)
    lists = state.lists.numpy()
    live = state.list_ids.numpy() >= 0
    scales = state.q_scales.numpy()[:, None, None]
    deq = (state.q_lists.numpy().astype(np.float32) * scales
           + state.q_zeros.numpy()[:, None, None])
    err = np.abs(deq - lists)[live]
    assert (err <= np.broadcast_to(scales / 2 + 1e-6, lists.shape)[live]).all()
    np.testing.assert_allclose(state.q_norms.numpy()[live],
                               np.sum(deq * deq, axis=-1)[live],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_recall_at_10_matches_f32(metric):
    n, k = 2048, 10
    qcfg = dataclasses.replace(QCFG, metric=metric, k=k, rescore_k=64)
    fcfg = dataclasses.replace(qcfg, store_dtype="float32")
    x = torch.from_numpy(_corpus(n, seed=3))
    ids = torch.arange(n, dtype=torch.int32)
    qs, fs = (ivf.build(torch.Generator().manual_seed(3), x, ids, c)[0]
              for c in (qcfg, fcfg))
    q = _corpus(64, seed=4)
    true_ids = metrics.brute_force_topk(q, x.numpy(), ids.numpy(), k,
                                        metric=metric, device="cpu")
    got_q, _ = ivf.query_full_scan(qs, torch.from_numpy(q), qcfg, k)
    got_f, _ = ivf.query_full_scan(fs, torch.from_numpy(q), fcfg, k)
    r_q = metrics.recall_at_k(got_q.numpy(), true_ids)
    r_f = metrics.recall_at_k(got_f.numpy(), true_ids)
    assert r_q >= 0.95 * r_f, (r_q, r_f)
    assert r_f >= 0.99


def test_rescored_rows_are_exact_f32():
    """Exact f32 rows of the winners, even with TF32 allowed globally: the
    rescore is an elementwise product and a sum, not a matrix product."""
    state, x, ids = _built(QCFG, n=256, seed=5)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got_ids, scores, rows = ivf.query_full_scan_rows(state, x[:8], QCFG, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    np.testing.assert_array_equal(got_ids[:, 0].numpy(), ids[:8].numpy())
    np.testing.assert_allclose(rows[:, 0].numpy(), x[:8].numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(scores[:, 0].numpy(),
                               (x[:8].double() ** 2).sum(1).numpy(),
                               rtol=1e-6)


def test_quantized_store_coherent_through_insert_delete_rebuild():
    state, _, _ = _built(QCFG, n=256, seed=6)
    x2 = torch.from_numpy(_corpus(16, seed=7))
    ids2 = torch.arange(1000, 1016, dtype=torch.int32)
    state, _ = ivf.insert(state, x2, ids2, QCFG)
    got, _ = ivf.query_full_scan(state, x2, QCFG, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), ids2.numpy())
    # every touched list is re-derived exactly as a full requantization
    full = ivf._quantize_lists(state.lists, state.list_ids)
    assert torch.equal(state.q_lists, full[0])
    assert torch.equal(state.q_scales, full[1])
    state, n_del = ivf.delete(state, ids2[:8])
    assert int(n_del) == 8
    got, _ = ivf.query_full_scan(state, x2[:8], QCFG, 1)
    assert not np.isin(got[:, 0].numpy(), ids2[:8].numpy()).any()
    state, _ = ivf.rebuild(torch.Generator().manual_seed(8), state, QCFG)
    assert state.quantized
    got, _ = ivf.query_full_scan(state, x2[8:], QCFG, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), ids2[8:].numpy())


def test_requantization_in_chunks_gives_the_same_bits(monkeypatch):
    """The port re-derives lists a chunk at a time: a chunk of one list
    gives the bits of one pass over every list."""
    state, _, _ = _built(QCFG, n=300, seed=12)
    want = [getattr(state, f).clone() for f in Q_FIELDS]
    monkeypatch.setattr(ivf, "_QUANT_CHUNK_BYTES", 1)
    ivf._quantize_state(state)
    for f, w in zip(Q_FIELDS, want):
        assert torch.equal(getattr(state, f), w), f


def test_probed_path_matches_full_scan_top1():
    state, x, ids = _built(QCFG, n=256, seed=9)
    got, _ = ivf.query_probed(state, x[:16], QCFG, 1, QCFG.nprobe)
    np.testing.assert_array_equal(got[:, 0].numpy(), ids[:16].numpy())
    full, _ = ivf.query_full_scan(state, x[:16], QCFG, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), full[:, 0].numpy())


def test_snapshot_before_insert_shared_keeps_its_int8_store():
    state, _, _ = _built(QCFG, n=256, seed=10)
    before = {f: getattr(state, f).clone() for f in Q_FIELDS}
    new, _ = ivf.insert_shared(state, torch.from_numpy(_corpus(64, seed=11)),
                               torch.arange(500, 564, dtype=torch.int32), QCFG)
    for f in Q_FIELDS:
        assert torch.equal(getattr(state, f), before[f]), f
    assert not torch.equal(new.q_lists, state.q_lists)


def test_int8_stats_and_bytes():
    with MemoryService(device="cpu", maintenance=False) as svc:
        for name, cfg in (("q0", QCFG), ("f0", FCFG)):
            svc.create_collection(name, cfg)
            svc.build(name, _corpus(256, seed=13))
        st = svc.stats()["collections"]
    assert st["q0"]["bytes_per_row"] == 5 * DIM
    assert st["q0"]["scan_bytes_per_row"] == DIM
    assert st["q0"]["store_dtype"] == "int8"
    assert st["f0"]["bytes_per_row"] == st["f0"]["scan_bytes_per_row"] == 4 * DIM
    assert st["q0"]["index_bytes"] == ivf.state_nbytes(QCFG) == \
        jivf.state_nbytes(JQCFG)
    assert st["f0"]["index_bytes"] == ivf.state_nbytes(FCFG)
