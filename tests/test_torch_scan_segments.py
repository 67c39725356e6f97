"""The full scan over the store in place, on the CPU.

`scan_scores` takes its rows in two segments (``db`` with ``ids``, then
``db2`` with ``ids2``) and scores them as the scan of the two
concatenated; `query_full_scan` and `query_full_scan_rows` read the list
tier and the spill tier that way instead of concatenating them first.  These tests hold both to the flat
path they replace, bit for bit: the plain versions here, the kernel on the
card (`tests/test_torch_cuda.py`).
"""
import pytest
import torch

from repro_torch.configs.ame_paper import PAPER_1M
from repro_torch.configs.base import EngineConfig
from repro_torch.core import index as ivf
from repro_torch.kernels import ops
from repro_torch.kernels import scan_scores as ss

D = 64
G = 3
K = 10
# (C, L, S): a ragged list tier (15 slots, under one 128-row tile), an
# empty spill tier, and a list tier past one tile with a small spill
SHAPES = [(3, 5, 7), (3, 5, 0), (4, 40, 16)]


def _cfg(c, l, metric, **kw):
    return EngineConfig(dim=D, n_clusters=c, list_capacity=l, nprobe=2,
                        k=K, metric=metric, aligned=False, **kw)


def _state(c, l, s, seed, spill_live=True):
    """A store of random rows with ~20 % of its list slots empty, and a
    spill tier whose rows are all live or all dead."""
    g = torch.Generator().manual_seed(seed)
    st = ivf.empty_state(_cfg(c, l, "ip"), s, device="cpu")
    list_ids = torch.arange(c * l, dtype=torch.int32).view(c, l)
    list_ids[torch.rand(c, l, generator=g) < 0.2] = -1
    spill_ids = (torch.arange(s, dtype=torch.int32) + 10_000 if spill_live
                 else torch.full((s,), -1, dtype=torch.int32))
    return st._replace(lists=torch.randn(c, l, D, generator=g),
                       list_ids=list_ids, spill=torch.randn(s, D, generator=g),
                       spill_ids=spill_ids)


def _store(shape, lanes, spill_live):
    c, l, s = shape
    if lanes:
        return ivf.stack_states([_state(c, l, s, seed, spill_live)
                                 for seed in range(G)])
    return _state(c, l, s, 0, spill_live)


def _queries(b, lanes):
    g = torch.Generator().manual_seed(99)
    return torch.randn(*((G,) if lanes else ()), b, D, generator=g)


def _flat_full_scan(state, q, cfg, k):
    """The full scan as it was: the flat copy of the rows, then one
    segment."""
    rows, ids = ivf._flat_rows(state)
    scores = ivf._scan(q, rows, ids, cfg)
    top, idx = torch.topk(ivf._order_scores(scores, cfg.metric), k, dim=-1)
    return ivf._take(state, ids, idx), top, ivf._take(state, rows, idx)


CASES = [(shape, spill_live) for shape in SHAPES
         for spill_live in ((True, False) if shape[2] else (True,))]


@pytest.mark.parametrize("shape,spill_live", CASES)
@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("b", [2, 8, 64])
@pytest.mark.parametrize("path", ["kernel", "plain", "unfused"])
def test_two_segment_scan_is_the_flat_scan(shape, spill_live, lanes, metric,
                                           b, path):
    """ops.scan_scores over the two tiers, rows and ids each, equals it over
    their concatenation, bit for bit, on every dispatch path: the wrapper
    (the plain version on the CPU), ``use_kernel=False`` and the unfused
    conversion rung."""
    st = _store(shape, lanes, spill_live)
    q = _queries(b, lanes)
    lists, list_ids = st.lists.flatten(-3, -2), st.list_ids.flatten(-2)
    flat, ids = ivf._flat_rows(st)
    norms = (flat ** 2).sum(-1) if metric == "l2" else None
    n1 = lists.shape[-2]
    kw = dict(metric=metric, use_kernel=path != "plain",
              fused_conversion=path != "unfused")
    got = ops.scan_scores(
        q, lists, list_ids, None if norms is None else norms[..., :n1],
        db2=st.spill, ids2=st.spill_ids,
        db2_norms=None if norms is None else norms[..., n1:], **kw)
    want = ops.scan_scores(q, flat, ids, norms, **kw)
    assert got.shape == (*q.shape[:-1], flat.shape[-2])
    assert torch.equal(got, want)
    if not spill_live and shape[2]:
        masked = float("inf") if metric == "l2" else float("-inf")
        assert bool((got[..., -shape[2]:] == masked).all())


@pytest.mark.parametrize("shape,spill_live", CASES)
@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("b", [2, 8, 64])
def test_full_scan_reads_the_store_in_place(shape, spill_live, lanes, metric,
                                            b):
    """query_full_scan gives the flat path's ids and scores; on a single
    store query_full_scan_rows also gives its rows, gathered from the two
    tiers in `_flat_rows` order."""
    c, l, s = shape
    cfg = _cfg(c, l, metric)
    st = _store(shape, lanes, spill_live)
    q = _queries(b, lanes)
    k = min(K, c * l + s)
    want_ids, want_top, want_rows = _flat_full_scan(st, q, cfg, k)
    got_ids, got_top = ivf.query_full_scan(st, q, cfg, k)
    assert torch.equal(got_ids, want_ids)
    assert torch.equal(got_top, want_top)
    if not lanes:
        ids, top, rows = ivf.query_full_scan_rows(st, q, cfg, k)
        assert torch.equal(ids, want_ids)
        assert torch.equal(top, want_top)
        assert torch.equal(rows, want_rows)


def test_full_scan_makes_no_flat_copy(monkeypatch):
    """Neither template concatenates the store: `_flat_rows` and
    `_flat_ids` are not called, and the scan gets both tiers' rows and
    ids as views of the store."""
    cfg = _cfg(4, 40, "ip")
    st = _state(4, 40, 16, 0)
    q = _queries(8, False)
    monkeypatch.setattr(ivf, "_flat_rows", None)
    monkeypatch.setattr(ivf, "_flat_ids", None)
    seen = []
    real = ops.scan_scores

    def spy(q, db, ids, db_norms=None, **kw):
        seen.append(tuple(t.data_ptr() for t in (db, ids, kw["db2"],
                                                 kw["ids2"])))
        return real(q, db, ids, db_norms, **kw)

    monkeypatch.setattr(ops, "scan_scores", spy)
    ivf.query_full_scan(st, q, cfg, K)
    ivf.query_full_scan_rows(st, q, cfg, K)
    assert seen == [tuple(t.data_ptr() for t in (
        st.lists, st.list_ids, st.spill, st.spill_ids))] * 2


A = 256          # a 16-byte-aligned address
N_FULL = PAPER_1M.n_clusters * PAPER_1M.list_capacity + 4096


@pytest.mark.parametrize("b,ptrs,want", [
    (64, (A, A, A), "stream"),                 # PAPER_1M's full scan
    (2, (A, A, A), "stream"),
    (64, (A, A, A + 8), "generic"),            # misaligned spill tier
    (64, (A, A + 4, A), "generic"),            # misaligned list tier
    (64, (A + 4, A, A), "generic"),            # misaligned queries
])
def test_variant_checks_both_segments(b, ptrs, want):
    """The 16-byte rule of TMA holds for each segment's base."""
    assert ss.variant_for(b, N_FULL, PAPER_1M.dim, *ptrs) == want


def test_launch_counts_report_two_segment_launches():
    """`scan_scores.two_segment` sits beside the variants in
    `launch_counts` (and so in `MemoryService.counters()` as
    ``launches.scan_scores.two_segment``); the plain version on the CPU
    launches nothing."""
    before = ops.launch_counts()
    assert "scan_scores.two_segment" in before
    st = _state(3, 5, 7, 0)
    ivf.query_full_scan(st, _queries(2, False), _cfg(3, 5, "ip"), K)
    assert ops.launch_counts() == before
