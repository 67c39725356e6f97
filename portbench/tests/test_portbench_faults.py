"""The whole run on the CPU at a tiny size, with the timed path broken
underneath: each fault that a cell of one card can have must make
`correct` come out false (the exchange between chips does not exist on
one card).  The harness's look for a card is skipped: the run is handed
the CPU."""
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench.lib import harness, tiny  # noqa: E402
from repro_torch.core import index as ivf  # noqa: E402

SEED = 2 ** 33 + 12345


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, seconds=1.0, **kw):
    return harness.run(tiny.cell(name, ROOT), SEED, seconds, False,
                       t_process=time.perf_counter(), device="cpu", **kw)


def _failed(r):
    def bad(v):
        if v["op"] == "<=":
            return v["value"] > v["limit"]
        return v["value"] < v["limit"]
    return {k for k, v in r["checks"].items() if bad(v)}


def test_a_sound_run_is_correct():
    r = _run("f32-hybrid", 1.5)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["notes"]["sampled_requests"] > 0
    assert set(r["metrics"]) == {"queries_per_s", "insert_rows_per_s",
                                 "setup_s"}
    assert r["notes"]["query_p95_ms"] > 0


def test_an_insert_that_returns_its_state_unchanged(monkeypatch):
    def unchanged(state, x, ids, cfg):
        return state, torch.zeros((), dtype=torch.int32)
    monkeypatch.setattr(ivf, "insert_shared", unchanged)
    r = _run("f32-hybrid")
    assert not r["correct"]
    assert "lost_ids" in _failed(r)


def test_half_of_the_batch_left_out(monkeypatch):
    real = ivf.query_full_scan

    def half(state, q, cfg, k):
        m = (q.shape[0] + 1) // 2
        ids, scores = real(state, q[:m], cfg, k)
        rep = torch.arange(q.shape[0]) % m
        return ids[rep], scores[rep]
    monkeypatch.setattr(ivf, "query_full_scan", half)
    r = _run("f32-recall")
    assert not r["correct"]
    assert {"score_err", "self_miss"} & _failed(r)


def test_half_of_the_batch_left_out_under_writes(monkeypatch):
    real = ivf.query_full_scan

    def half(state, q, cfg, k):
        m = (q.shape[0] + 1) // 2
        ids, scores = real(state, q[:m], cfg, k)
        rep = torch.arange(q.shape[0]) % m
        return ids[rep], scores[rep]
    monkeypatch.setattr(ivf, "query_full_scan", half)
    r = _run("f32-hybrid")
    assert not r["correct"]
    assert {"score_err", "self_miss"} & _failed(r)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    real = ivf.query_probed

    def altered(state, q, cfg, k, nprobe):
        ids, scores = real(state, q, cfg, k, nprobe)
        return ids, scores + 0.05
    monkeypatch.setattr(ivf, "query_probed", altered)
    r = _run("int8-hybrid")
    assert not r["correct"]
    assert "score_err" in _failed(r)


def test_an_answer_altered_where_it_is_produced_in_the_f32_store(
        monkeypatch):
    real = ivf.query_probed

    def altered(state, q, cfg, k, nprobe):
        ids, scores = real(state, q, cfg, k, nprobe)
        return ids, scores + 0.05
    monkeypatch.setattr(ivf, "query_probed", altered)
    r = _run("f32-hybrid")
    assert not r["correct"]
    assert "score_err" in _failed(r)


def test_a_probed_path_that_scans_fewer_lists(monkeypatch):
    real = ivf.query_probed

    def fewer(state, q, cfg, k, nprobe):
        return real(state, q, cfg, k, max(1, nprobe // 8))
    monkeypatch.setattr(ivf, "query_probed", fewer)
    r = _run("f32-recall")
    assert not r["correct"]
    assert "probed_miss" in _failed(r)


def test_the_own_row_and_nine_lower_rows_with_their_scores(monkeypatch):
    real = ivf.query_probed

    def lower(state, q, cfg, k, nprobe):
        ids, scores = real(state, q, cfg, 2 * k - 1, nprobe)
        keep = [0] + list(range(k, 2 * k - 1))
        return ids[..., keep], scores[..., keep]
    monkeypatch.setattr(ivf, "query_probed", lower)
    r = _run("f32-recall")
    assert not r["correct"]
    assert _failed(r) == {"probed_miss"}
