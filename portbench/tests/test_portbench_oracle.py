"""The plain reference against a brute force in numpy, at a tiny size."""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.lib import oracle  # noqa: E402

N, D, V, K = 3000, 64, 12, 5


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = rows[rng.integers(0, N, V)] + 0.05 * rng.standard_normal(
        (V, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # ids 0..999 acknowledged at time 0, 1000..1999 at time 5, the rest
    # never; ids 0..499 deleted (sent) at time 3
    ack = np.where(np.arange(N) < 1000, 0.0,
                   np.where(np.arange(N) < 2000, 5.0, math.inf))
    gone = np.where(np.arange(N) < 500, 3.0, math.inf)
    t_sub = np.where(np.arange(V) % 2 == 0, 1.0, 6.0)
    t_done = t_sub + 0.5
    return rows, q, ack, gone, t_sub, t_done


def _judge(rows, q, ack, gone, t_sub, t_done, returned, control=None,
           block=700):
    rt = torch.from_numpy(rows)
    ack_t, gone_t = torch.from_numpy(ack), torch.from_numpy(gone)
    return oracle.judge(
        torch.from_numpy(q), returned, t_sub, t_done, (0, N),
        lambda lo, hi: rt[lo:hi],
        lambda ids: (ack_t[ids], gone_t[ids]), K, control=control,
        block=block)


def test_best_and_returned_scores_are_exact():
    rows, q, ack, gone, t_sub, t_done = _setup()
    exact = q.astype(np.float64) @ rows.astype(np.float64).T
    live = (ack[None, :] < t_sub[:, None]) & (gone[None, :] > t_done[:, None])
    want = -np.sort(-np.where(live, exact, -np.inf), axis=1)[:, :K]
    returned = np.argsort(-exact, axis=1)[:, :K]
    v = _judge(rows, q, ack, gone, t_sub, t_done, returned)
    np.testing.assert_allclose(v.best, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        v.exact_returned, np.take_along_axis(exact, returned, 1),
        rtol=0, atol=1e-12)
    # the early requests may not see rows acknowledged later
    assert (v.best[0] <= np.sort(exact[0])[::-1][:K] + 1e-12).all()


def test_a_returned_id_outside_the_rows_has_no_score():
    rows, q, ack, gone, t_sub, t_done = _setup()
    returned = np.full((V, K), N + 7)
    v = _judge(rows, q, ack, gone, t_sub, t_done, returned)
    assert np.isnan(v.exact_returned).all()
    assert oracle.score_err(np.zeros((V, K), np.float32),
                            v.exact_returned) == math.inf


def test_exact_answers_read_zero_and_a_swap_reads_its_gap():
    rows, q, ack, gone, t_sub, t_done = _setup()
    exact = q.astype(np.float64) @ rows.astype(np.float64).T
    live = (ack[None, :] < t_sub[:, None]) & (gone[None, :] > t_done[:, None])
    order = np.argsort(-np.where(live, exact, -np.inf), axis=1)
    returned = order[:, :K]
    v = _judge(rows, q, ack, gone, t_sub, t_done, returned)
    assert oracle.rank_gap(v.best, v.exact_returned) == 0.0
    assert oracle.score_err(v.exact_returned.astype(np.float32),
                            v.exact_returned) < 1e-7
    # the k-th answer replaced by the (k+1)-th best live row
    swapped = returned.copy()
    swapped[:, K - 1] = order[:, K]
    v2 = _judge(rows, q, ack, gone, t_sub, t_done, swapped)
    gap = np.take_along_axis(exact, order[:, K - 1:K], 1) - \
        np.take_along_axis(exact, order[:, K:K + 1], 1)
    assert oracle.rank_gap(v2.best, v2.exact_returned) == pytest.approx(
        float(gap.max()), abs=1e-12)


def test_miss_counts_the_exact_best_left_out():
    rows, q, ack, gone, t_sub, t_done = _setup(2)
    exact = q.astype(np.float64) @ rows.astype(np.float64).T
    live = (ack[None, :] < t_sub[:, None]) & (gone[None, :] > t_done[:, None])
    order = np.argsort(-np.where(live, exact, -np.inf), axis=1)
    v = _judge(rows, q, ack, gone, t_sub, t_done, order[:, :K])
    assert oracle.miss(v.best, v.exact_returned) == 0.0
    # two of the k best replaced by lower live rows in every answer, and
    # one answer's row named outside the rows
    worse = order[:, :K].copy()
    worse[:, K - 2:] = order[:, K + 3:K + 5]
    worse[0, 0] = N + 1
    v2 = _judge(rows, q, ack, gone, t_sub, t_done, worse)
    want = (2 * V + 1) / (V * K)
    assert oracle.miss(v2.best, v2.exact_returned) == pytest.approx(want)
    assert oracle.miss(v2.best[:0], v2.exact_returned[:0]) == 0.0


@pytest.mark.parametrize("control", ["fp8", "bf16"])
def test_the_control_rounds_its_scores(control):
    rows, q, ack, gone, t_sub, t_done = _setup(1)
    exact = q.astype(np.float64) @ rows.astype(np.float64).T
    returned = np.argsort(-exact, axis=1)[:, :K]
    v = _judge(rows, q, ack, gone, t_sub, t_done, returned, control=control)
    err = oracle.score_err(v.control_scores, v.control_exact)
    assert err > (1e-3 if control == "fp8" else 1e-4)
    # its picks are live rows and their exact scores are theirs
    got = np.take_along_axis(exact, v.control_ids, 1)
    np.testing.assert_allclose(v.control_exact, got, rtol=0, atol=1e-12)
    live = (ack[v.control_ids] < t_sub[:, None]) & (
        gone[v.control_ids] > t_done[:, None])
    assert live.all()


def test_lower_precision_rounds_as_named():
    x = torch.randn(4, 32, dtype=torch.float32)
    b = oracle.lower_precision(x, "bf16")
    assert torch.equal(b, x.to(torch.bfloat16).to(torch.float64))
    f = oracle.lower_precision(x, "fp8")
    rel = ((f - x.double()).abs() / x.double().abs().amax(1, keepdim=True))
    assert 0 < float(rel.max()) < 2 ** -4
    with pytest.raises(ValueError):
        oracle.lower_precision(x, "int4")
