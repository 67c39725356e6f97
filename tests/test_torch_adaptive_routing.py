"""Recall-adaptive routing of the port on the CPU: the recall probe, the
nprobe/ef knob tuners, the index policies (flat / ivf / hnsw / auto) and the
derived HNSW graph tier.

The first part is the reference's `tests/test_adaptive_routing.py` run
against `repro_torch` at a smaller size: the tuner's state machine, the
oracle's edge cases, the size-based policy, the probe's lifecycle, the
drift scenario (probed recall drops, the probe walks nprobe back up), the
fusion-group split by tuned nprobe, and the graph tier's lifecycle.  Graph
tenants run at a small degree and beam (`hnsw_m=4`, `hnsw_ef=16`): the
graph is the paper's serial host baseline, tens of milliseconds a row at
the reference test's defaults.

The rest holds the port to the JAX package.  Tolerances: tuner
trajectories, HNSW graphs and search results, and the probe's path,
sample, seq, selected rows, knob and retune flag are compared exactly;
recall to 1e-6.  A state is carried across with `repro_torch.convert`, and
saved tuner metadata cross-loads both ways.
"""
import dataclasses
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.api import Collection as JCollection
from repro.configs.base import EngineConfig as JConfig
from repro.core import hnsw as jhnsw
from repro.core import metrics as jmetrics
from repro.core import templates as jtemplates
from repro.core import tuner as jtuner
from repro_torch.api import Collection, MemoryOp, MemoryService
from repro_torch.api.batch import execute_group
from repro_torch.api.service import MaintenanceController
from repro_torch.configs.base import EngineConfig
from repro_torch.convert import ivf_state_from_numpy
from repro_torch.core import locking, metrics, templates
from repro_torch.core.hnsw import HNSW
from repro_torch.core.tuner import RecallTuner

jax.config.update("jax_platform_name", "cpu")

D = 128
ARGS = dict(dim=D, n_clusters=128, list_capacity=32, nprobe=4, k=10,
            use_kernel=False, kmeans_iters=3)
GRAPH = dict(hnsw_m=4, hnsw_ef=16)


@pytest.fixture(autouse=True)
def _port_lock_order_guard():
    """With AME_DEBUG_LOCKS=1 the port's locks record their acquisition
    order in repro_torch's own validator; fail the test that inverted it."""
    if not locking.debug_enabled():
        yield
        return
    locking.validator.reset()
    yield
    violations = locking.validator.drain()
    assert not violations, "\n".join(violations)


def _cfg(**kw):
    return EngineConfig(**{**ARGS, **kw})


def _jcfg(**kw):
    return JConfig(**{**ARGS, **kw})


def _coll(name="c", cfg=None, **kw):
    return Collection(name, cfg or _cfg(), device="cpu", **kw)


def _svc():
    return MemoryService(maintenance=False, device="cpu")


def _corpus(n, seed=0, shift=0.0):
    """Plain gaussian rows: neighbor gaps well above bf16 scan rounding."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)) + shift).astype(np.float32)


def _live(state):
    ids = torch.cat([state.list_ids.reshape(-1), state.spill_ids]).numpy()
    return set(ids[ids >= 0].tolist())


# ---------------------------------------------------------------------------
# RecallTuner state machine
# ---------------------------------------------------------------------------

def test_tuner_seek_doubles_and_raises_floor():
    t = RecallTuner(0.9, knob=2, lo=1, hi=128)
    assert t.observe(0.5) == 4          # below target: double
    assert t.observe(0.5) == 8
    assert t.observe(0.5) == 16
    s = t.stats()
    assert s["floor"] == 8              # last knob known insufficient
    assert s["raises"] == 3


def test_tuner_backoff_never_below_failed_knob():
    t = RecallTuner(0.9, knob=2, lo=1, hi=128)
    t.observe(0.5)                      # 2 failed -> floor 2, knob 4
    t.observe(0.5)                      # 4 failed -> floor 4, knob 8
    for _ in range(10):
        k = t.observe(1.0)
        assert k > t.stats()["floor"]
    assert t.knob == 5                  # floor + 1 is the hard deck


def test_tuner_hold_band_and_clamp():
    t = RecallTuner(0.9, knob=16, lo=1, hi=128, slack=0.05)
    assert t.observe(0.92) == 16        # inside [target, target+slack)
    assert t.stats()["raises"] == t.stats()["backoffs"] == 0
    t = RecallTuner(0.99, knob=100, lo=1, hi=128)
    assert t.observe(0.1) == 128
    assert t.observe(0.1) == 128        # saturated, not past hi


def test_tuner_persistence_roundtrip_and_validation():
    t = RecallTuner(0.9, knob=2, lo=1, hi=128)
    t.observe(0.5)
    t.observe(0.97)
    back = RecallTuner.from_dict(t.to_dict())
    assert back.knob == t.knob and back.stats() == t.stats()
    with pytest.raises(ValueError, match="target recall"):
        RecallTuner(1.5, knob=2, lo=1, hi=4)
    with pytest.raises(ValueError, match="outside"):
        RecallTuner(0.9, knob=9, lo=1, hi=4)


@pytest.mark.parametrize("seed", range(4))
def test_tuner_trajectory_matches_reference(seed):
    """The same recall sequence walks both packages' tuners through the
    same knobs, floors and counters, and saves the same dict."""
    rng = np.random.default_rng(seed)
    target = float(rng.uniform(0.5, 0.99))
    lo, hi = int(rng.integers(1, 4)), int(rng.integers(64, 2048))
    knob = int(rng.integers(lo, hi + 1))
    mine = RecallTuner(target, knob, lo, hi)
    ref = jtuner.RecallTuner(target, knob, lo, hi)
    for r in rng.uniform(0.0, 1.0, 40):
        assert mine.observe(float(r)) == ref.observe(float(r))
        assert mine.stats() == ref.stats()
    assert mine.to_dict() == ref.to_dict()
    if lo <= mine.knob <= hi:        # see the test below for knob > hi
        assert RecallTuner.from_dict(ref.to_dict()).stats() == \
            jtuner.RecallTuner.from_dict(mine.to_dict()).stats()


def test_tuner_backoff_above_hi_is_the_references():
    """A knob that missed at `hi` sets floor = hi, so the next backoff goes
    to floor + 1 = hi + 1, and `from_dict` then refuses the saved dict.
    The reference does the same; the port keeps its state machine (the
    collection clamps nprobe to C when it resolves a query)."""
    for cls in (RecallTuner, jtuner.RecallTuner):
        t = cls(0.9, knob=4, lo=1, hi=4)
        assert t.observe(0.5) == 4 and t.stats()["floor"] == 4
        assert t.observe(1.0) == 5
        with pytest.raises(ValueError, match="outside"):
            cls.from_dict(t.to_dict())


# ---------------------------------------------------------------------------
# Oracle metrics edge cases
# ---------------------------------------------------------------------------

def test_oracle_k_exceeds_live_rows():
    rows = _corpus(4, seed=1)
    true = metrics.brute_force_topk(rows[:2], rows, np.arange(4), 10,
                                    device="cpu")
    assert true.shape == (2, 10)
    assert (true[:, 4:] == -1).all() and (true[:, :4] >= 0).all()
    assert metrics.recall_at_k(true, true) == 1.0


def test_oracle_all_tombstoned_and_empty():
    rows = _corpus(8, seed=2)
    true = metrics.brute_force_topk(rows[:2], rows, np.full(8, -1), 5,
                                    device="cpu")
    assert (true == -1).all()
    assert metrics.recall_at_k(np.full((2, 5), -1), true) == 1.0
    true = metrics.brute_force_topk(_corpus(2, seed=3),
                                    np.zeros((0, D), np.float32),
                                    np.zeros(0, np.int64), 5, device="cpu")
    assert true.shape == (2, 5) and (true == -1).all()


def test_recall_counts_duplicates_once_and_partial_overlap():
    assert metrics.recall_at_k(np.array([[3, 3, 3, 5]]),
                               np.array([[3, 5, 7, -1]])) == \
        pytest.approx(2 / 3)
    true = np.array([[0, 1, 2, 3], [4, 5, 6, 7]])
    got = np.array([[0, 1, 9, 9], [4, 5, 6, 7]])
    assert metrics.recall_at_k(got, true) == pytest.approx(0.75)


def test_recall_rejects_mismatched_batch():
    """The reference asserts; the port raises ValueError (an assert
    vanishes under ``python -O``)."""
    with pytest.raises(ValueError):
        metrics.recall_at_k(np.zeros((2, 5)), np.zeros((3, 5)))
    with pytest.raises(AssertionError):
        jmetrics.recall_at_k(np.zeros((2, 5)), np.zeros((3, 5)))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_oracle_ids_match_reference_with_ties_and_holes(metric):
    """f64 products rounded to f32 (the port) and the reference's f32
    products rank the same rows; duplicate rows tie to the lower slot."""
    x = _corpus(300, seed=4)
    x[150:160] = x[0]                   # exact ties with row 0
    ids = np.arange(300)
    ids[::7] = -1                       # holes
    q = np.concatenate([x[:1], _corpus(15, seed=5)])
    np.testing.assert_array_equal(
        metrics.brute_force_topk(q, x, ids, 12, metric, device="cpu"),
        np.asarray(jmetrics.brute_force_topk(q, x, ids, 12, metric)))


# ---------------------------------------------------------------------------
# Size-based index policy
# ---------------------------------------------------------------------------

def test_policy_config_validation_matches_reference():
    bad = (dict(index_policy="btree"), dict(index_policy="hnsw",
                                            shard_db=True),
           dict(index_policy="flat", shard_db=True),
           dict(target_recall=1.5), dict(hnsw_m=1), dict(hnsw_ef=0))
    for kw in bad:
        with pytest.raises(ValueError):
            _cfg(**kw)
        with pytest.raises(ValueError):
            _jcfg(**kw)


def test_auto_policy_tracks_size():
    th = templates.TemplateThresholds(flat_max_rows=160, hnsw_min_rows=400)
    coll = _coll(cfg=_cfg(index_policy="auto", **GRAPH), thresholds=th)
    coll.build(_corpus(150, seed=4))
    assert coll.index_policy() == "flat"
    assert coll.resolve_query(1, None, None, None)[2] == "full_scan"
    coll.insert(_corpus(150, seed=5))
    assert coll.index_policy() == "ivf"
    assert coll.resolve_query(1, None, None, None)[2] == "probed"
    coll.insert(_corpus(100, seed=6))
    assert coll.index_policy() == "hnsw"
    assert coll.resolve_query(1, None, None, None)[2] == "hnsw"
    ids, _ = coll.query(_corpus(1, seed=4))
    assert ids.dtype == np.int64 and coll._graph is not None
    coll.delete(np.arange(200))         # deletes shrink it back
    assert coll.index_policy() == "ivf"


def test_fixed_policies_route():
    for pol, want in (("flat", "full_scan"), ("hnsw", "hnsw"),
                      ("ivf", "probed")):
        coll = _coll(cfg=_cfg(index_policy=pol, **GRAPH))
        coll.build(_corpus(300, seed=7))
        assert coll.resolve_query(1, None, None, None)[2] == want, pol
        assert coll.stats()["index_policy"] == pol


def test_every_policy_answers_with_high_recall():
    x = _corpus(250, seed=8)
    true = metrics.brute_force_topk(x[:16], x, np.arange(len(x)), 10,
                                    device="cpu")
    for pol in ("flat", "ivf", "hnsw"):
        coll = _coll(cfg=_cfg(index_policy=pol, nprobe=32, hnsw_m=6,
                              hnsw_ef=24))
        coll.build(x)
        got, _ = coll.query(x[:16], k=10)
        assert metrics.recall_at_k(got, true) >= 0.9, pol


# ---------------------------------------------------------------------------
# Recall probe lifecycle
# ---------------------------------------------------------------------------

def test_probe_cadence_and_reset():
    th = templates.TemplateThresholds(probe_interval_ops=8)
    coll = _coll(cfg=_cfg(target_recall=0.9), thresholds=th)
    coll.build(_corpus(400, seed=9))
    assert coll.recall_probe_due()            # fresh build: probe now
    assert coll.recall_probe()["recall"] is not None
    assert not coll.recall_probe_due()        # counter reset
    coll.insert(_corpus(8, seed=10))          # 8 ops >= interval
    assert coll.recall_probe_due()


def test_probe_disarmed_without_target():
    coll = _coll()
    coll.build(_corpus(300, seed=11))
    assert not coll.recall_probe_due()
    assert coll._nprobe_tuner is None and "tuner" not in coll.stats()


def test_probe_skipped_when_demoted():
    coll = _coll(cfg=_cfg(target_recall=0.9))
    coll.build(_corpus(300, seed=12))
    coll.demote()
    out = coll.recall_probe()
    assert out["recall"] is None and out["skipped"] == "warm"
    assert not coll.recall_probe_due()


def test_probe_is_deterministic_per_seq():
    a = _coll("same-name", _cfg(target_recall=0.9))
    b = _coll("same-name", _cfg(target_recall=0.9))
    x = _corpus(400, seed=13)
    a.build(x)
    b.build(x)
    ra, rb = a.recall_probe(), b.recall_probe()
    assert ra["seq"] == rb["seq"] == 0
    assert ra["recall"] == rb["recall"]
    assert a.recall_probe()["seq"] == 1       # seq advances


def test_probe_on_emptied_collection_is_vacuous():
    coll = _coll(cfg=_cfg(target_recall=0.9))
    coll.build(_corpus(256, seed=40), ids=np.arange(256))
    coll.delete(np.arange(256))
    out = coll.recall_probe()
    assert out["recall"] == 1.0 and out["sample"] == 0


def test_probe_measures_serving_path_not_probe_batch():
    """A 64-row probe batch routes full_scan by size; the probe measures
    the policy's steady-state path instead."""
    coll = _coll(cfg=_cfg(target_recall=0.9))
    coll.build(_corpus(400, seed=14))
    out = coll.recall_probe(sample=64)
    assert out["path"] == "probed" and out["knob"] is not None
    s = coll.stats()
    assert s["last_probe"] == out and set(s["tuner"]) == {"nprobe", "ef"}


# ---------------------------------------------------------------------------
# The acceptance scenario: drift -> probe detects -> retune restores
# ---------------------------------------------------------------------------

def test_probe_detects_drift_and_restores_recall():
    """Centroids fit on the base distribution go stale when drifted rows
    arrive; at nprobe=1 probed recall craters.  The probe loop walks
    nprobe up until the oracle confirms the target, while live queries
    keep succeeding (zero downtime)."""
    target = 0.92
    svc = _svc()
    svc.create_collection("c", _cfg(nprobe=1, target_recall=target))
    svc.build("c", _corpus(1000, seed=16))
    coll = svc.collection("c")
    svc.insert("c", _corpus(1000, seed=17, shift=4.0))
    first = coll.recall_probe()
    assert first["path"] == "probed" and first["recall"] < target
    assert first["retuned"] and first["knob"] > 1
    stop, errors = threading.Event(), []

    def serve():
        qs = _corpus(4, seed=18, shift=4.0)
        while not stop.is_set():
            try:
                ids, _ = svc.query("c", qs, k=10)
                assert ids.shape == (4, 10)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return

    t = threading.Thread(target=serve)
    t.start()
    try:
        restored = first["recall"]
        for _ in range(12):
            restored = coll.recall_probe()["recall"]
            if restored >= target:
                break
    finally:
        stop.set()
        t.join(timeout=120)
        svc.shutdown()
    assert not t.is_alive() and not errors and restored >= target
    assert coll.tuned_nprobe() > 1


def test_controller_schedules_probe_ops():
    svc = _svc()
    svc.create_collection("c", _cfg(target_recall=0.9))
    svc.build("c", _corpus(400, seed=19))     # fresh build: probe due
    ctl = MaintenanceController(svc, poll_interval_s=3600)
    try:
        assert ctl.poll_once() >= 1
        for _ in range(200):
            if svc.collection("c").stats()["last_probe"] is not None:
                break
            time.sleep(0.05)
        assert ctl.stats()["probes_triggered"] == 1
        assert svc.collection("c").stats()["last_probe"]["seq"] == 0
        assert ctl.poll_once() == 0           # cadence: not due again
    finally:
        ctl.stop()
        svc.shutdown()


def test_tuner_state_survives_save_load(tmp_path):
    svc = _svc()
    svc.create_collection("c", _cfg(nprobe=1, target_recall=0.9))
    svc.build("c", _corpus(800, seed=20))
    svc.insert("c", _corpus(800, seed=21, shift=4.0))
    coll = svc.collection("c")
    for _ in range(4):
        coll.recall_probe()
    knob = coll.tuned_nprobe()
    assert knob > 1
    svc.save(str(tmp_path))
    svc.shutdown()
    svc2 = MemoryService.load(str(tmp_path), maintenance=False, device="cpu")
    try:
        back = svc2.collection("c")
        assert back.tuned_nprobe() == knob and back._probe_seq == 4
    finally:
        svc2.shutdown()


# ---------------------------------------------------------------------------
# Tuner-owned nprobe vs batch fusion (signature == execution)
# ---------------------------------------------------------------------------

def _th():
    # keep small test batches on the probed path
    return templates.TemplateThresholds(full_scan_batch=32)


def test_diverged_tuners_split_groups():
    cfg = _cfg(target_recall=0.9)
    a, b = _coll("a", cfg, thresholds=_th()), _coll("b", cfg, thresholds=_th())
    a.build(_corpus(300, seed=22))
    b.build(_corpus(300, seed=23))
    assert a.batch_signature(4, None, None, None) == \
        b.batch_signature(4, None, None, None)
    b._nprobe_tuner.observe(0.1)              # b's knob doubles
    assert a.tuned_nprobe() != b.tuned_nprobe()
    sa = a.batch_signature(4, None, None, None)
    sb = b.batch_signature(4, None, None, None)
    assert sa != sb and sa[:5] == sb[:5] and sa[6:] == sb[6:]


def test_resolved_nprobe_matches_kernel_clamp():
    coll = _coll(cfg=_cfg(target_recall=0.9), thresholds=_th())
    coll.build(_corpus(300, seed=24))
    coll._nprobe_tuner._knob = 10_000         # force out-of-range knob
    _, nprobe, path = coll.resolve_query(4, None, None, None)
    assert (path, nprobe) == ("probed", coll.cfg.n_clusters)
    assert coll.resolve_query(4, None, -3, None)[1] == 1


def test_off_probed_path_nprobe_pinned():
    cfg = _cfg(index_policy="hnsw", target_recall=0.9, **GRAPH)
    a, b = _coll("a", cfg), _coll("b", cfg)
    a.build(_corpus(200, seed=25))
    b.build(_corpus(200, seed=26))
    b._nprobe_tuner.observe(0.1)
    assert a.batch_signature(4, None, None, None) == \
        b.batch_signature(4, None, None, None)
    assert a.resolve_query(4, None, None, None)[1:] == (0, "hnsw")


def test_fused_split_results_match_sync():
    cfg = _cfg(target_recall=0.9)
    svc = _svc()
    svc.create_collection("a", cfg, thresholds=_th())
    svc.create_collection("b", cfg, thresholds=_th())
    xa, xb = _corpus(300, seed=27), _corpus(300, seed=28)
    svc.build("a", xa)
    svc.build("b", xb)
    svc.collection("b")._nprobe_tuner.observe(0.1)
    try:
        fused = svc.query_many([("a", xa[:6]), ("b", xb[:6])])
        for (ids, scores), (name, x) in zip(fused, (("a", xa), ("b", xb))):
            sync = svc.collection(name).query(x[:6])
            np.testing.assert_array_equal(ids, sync[0])
            np.testing.assert_allclose(scores, sync[1], rtol=1e-5)
    finally:
        svc.shutdown()


def test_hnsw_lanes_fuse_per_lane():
    """Graph-path tenants batch through the service and are served lane by
    lane in one dispatch; the stacked executor refuses hnsw outright."""
    cfg = _cfg(index_policy="hnsw", **GRAPH)
    svc = _svc()
    svc.create_collection("a", cfg)
    svc.create_collection("b", cfg)
    xa, xb = _corpus(200, seed=29), _corpus(200, seed=30)
    svc.build("a", xa)
    svc.build("b", xb)
    try:
        futs = [svc.submit(MemoryOp("query", n, x[:5], batch=True))
                for n, x in (("a", xa), ("b", xb))]
        assert svc.flush() == 1                   # one group, one dispatch
        for f, (n, x) in zip(futs, (("a", xa), ("b", xb))):
            got = f.result(timeout=60)
            sync = svc.collection(n).query(x[:5])
            np.testing.assert_array_equal(got[0], sync[0])
            np.testing.assert_array_equal(got[1], sync[1])
        with pytest.raises(ValueError, match="hnsw"):
            execute_group([svc.collection("a")], [xa[:2]], cfg, 10, 0,
                          "hnsw")
    finally:
        svc.shutdown()


# ---------------------------------------------------------------------------
# Derived HNSW graph tier: IVF lifecycle guarantees hold
# ---------------------------------------------------------------------------

def test_graph_mirrors_writes():
    coll = _coll(cfg=_cfg(index_policy="hnsw", **GRAPH))
    coll.build(_corpus(200, seed=31))
    coll.query(_corpus(2, seed=32), k=5)      # forces graph build
    assert len(coll._graph) == 200
    coll.insert(_corpus(30, seed=33), ids=np.arange(200, 230))
    coll.delete(np.arange(15))
    assert len(coll._graph) == 215
    assert set(coll._graph.live_ids().tolist()) == _live(coll.snapshot())


def test_rebuild_and_demotion_invalidate_then_graph_recovers():
    coll = _coll(cfg=_cfg(index_policy="hnsw", **GRAPH))
    x = _corpus(200, seed=34)
    coll.build(x)
    coll.query(x[:2], k=5)
    coll.delete(np.arange(40))
    coll.rebuild()
    assert coll._graph is None                # derived copy dropped
    ids, _ = coll.query(x[100:108], k=10)     # lazily rebuilt
    assert not np.any(np.isin(ids, np.arange(40)))
    assert set(coll._graph.live_ids().tolist()) == _live(coll.snapshot())
    coll.demote()
    assert coll._graph is None
    ids, _ = coll.query(x[100:108], k=10)     # promotes, then rebuilds
    assert coll.residency == "hot" and coll._graph is not None
    np.testing.assert_array_equal(ids[:, 0], np.arange(100, 108))


def test_concurrent_insert_delete_rebuild_zero_lost_rows():
    coll = _coll(cfg=_cfg(index_policy="hnsw", **GRAPH))
    x = _corpus(200, seed=35)
    coll.build(x, ids=np.arange(200))
    coll.query(x[:1], k=1)                    # graph exists before race
    next_id = [200]
    errors = []

    def writer():
        try:
            rng = np.random.default_rng(36)
            for _ in range(6):
                base = next_id[0]
                next_id[0] += 10
                coll.insert(_corpus(10, seed=base),
                            ids=np.arange(base, base + 10))
                coll.delete(rng.integers(0, 100, size=4))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def rebuilder():
        try:
            for _ in range(2):
                coll.rebuild()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer),
               threading.Thread(target=rebuilder)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    live = _live(coll.snapshot())
    assert set(range(200, next_id[0])) <= live
    coll.query(x[:1], k=1)                    # rebuild graph if dropped
    assert set(coll._graph.live_ids().tolist()) == live


def test_hnsw_policy_save_load_roundtrip(tmp_path):
    cfg = _cfg(index_policy="hnsw", hnsw_m=6, hnsw_ef=24)
    coll = _coll(cfg=cfg)
    x = _corpus(150, seed=37)
    coll.build(x)
    coll.delete(np.arange(30))
    ids_before, _ = coll.query(x[100:116], k=10)
    coll.save_into(str(tmp_path))
    back = Collection.load_from(str(tmp_path), "c", cfg, device="cpu")
    assert back._graph is None                # not persisted
    assert _live(back.snapshot()) == _live(coll.snapshot())
    ids_after, _ = back.query(x[100:116], k=10)
    true = metrics.brute_force_topk(x[100:116], x[30:], np.arange(30, 150),
                                    10, device="cpu")
    for got in (ids_before, ids_after):
        assert metrics.recall_at_k(got, true) >= 0.9
    np.testing.assert_array_equal(ids_before, ids_after)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

def _graph_tuple(g):
    return (g.levels, g.entry, g.max_level, g.ids, g.id2node,
            sorted(g.dead), [sorted(layer) for layer in g.graph])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_hnsw_bit_equal_to_reference(metric):
    """Same seed, same rows (with a superseded id and deletes): the same
    graph, node for node and edge for edge, and the same search ids and
    distances, bit for bit."""
    x = _corpus(100, seed=41)
    ids = np.arange(1000, 1100)
    ids[90:] = ids[:10]                        # re-inserts supersede
    kw = dict(m=4, ef_construction=16, metric=metric, seed=3)
    mine, ref = HNSW(D, **kw), jhnsw.HNSW(D, **kw)
    mine.build(x, ids)
    ref.build(x, ids)
    for i in (1003, 1020, 1021, 1095, 9999):
        mine.delete(i)
        ref.delete(i)
    assert _graph_tuple(mine) == _graph_tuple(ref)
    for level_m, level_r in zip(mine.graph, ref.graph):
        for node, nb in level_r.items():
            np.testing.assert_array_equal(level_m[node], nb)
    np.testing.assert_array_equal(mine.vecs, ref.vecs)
    assert len(mine) == len(ref) and \
        np.array_equal(mine.live_ids(), ref.live_ids())
    q = _corpus(12, seed=42)
    for ef in (4, 16, 40):
        gi, gd = mine.search_batch_scored(q, 8, ef=ef)
        ri, rd = ref.search_batch_scored(q, 8, ef=ef)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gd, rd)


def _twins(name, path, store_dtype="float32", n=200):
    """A reference collection and a port collection holding the same state
    (carried across with `convert`), with the same host counters."""
    kw = dict(target_recall=0.9, store_dtype=store_dtype, rescore_k=32,
              **GRAPH)
    kw["index_policy"] = {"probed": "ivf", "full_scan": "flat",
                          "hnsw": "hnsw"}[path]
    ref = JCollection(name, _jcfg(**kw))
    x = _corpus(n, seed=43)
    ref.build(x)
    ref.delete(np.arange(0, n, 9))
    mine = _coll(name, _cfg(**kw))
    state = jax.device_get(ref.snapshot())
    with mine._lock:
        mine._state = ivf_state_from_numpy(state, device="cpu")
        mine._built = True
        mine._approx_live = ref._approx_live
    return ref, mine


@pytest.mark.parametrize("path,store_dtype", [
    ("probed", "float32"), ("probed", "int8"), ("full_scan", "float32"),
    ("hnsw", "float32")])
def test_recall_probe_matches_reference(path, store_dtype, monkeypatch):
    """One state in both packages: each probe takes the same path, samples
    the same rows in the same order, measures the same recall (1e-6) and
    moves the knob the same way, probe after probe."""
    ref, mine = _twins(f"twin-{path}", path, store_dtype)
    seen = {"ref": [], "port": []}

    def spy(module, key):
        orig = module.brute_force_topk

        def f(qs, *a, **kw):
            seen[key].append(np.asarray(qs.cpu() if isinstance(
                qs, torch.Tensor) else qs))
            return orig(qs, *a, **kw)
        monkeypatch.setattr(module, "brute_force_topk", f)

    spy(jmetrics, "ref")
    spy(metrics, "port")
    for _ in range(2):
        r, m = ref.recall_probe(), mine.recall_probe()
        for key in ("path", "k", "sample", "seq", "knob", "retuned"):
            assert m[key] == r[key], key
        assert m["path"] == path
        assert m["recall"] == pytest.approx(r["recall"], abs=1e-6)
    assert len(seen["ref"]) == len(seen["port"]) == 2
    for a, b in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(a, b)
    assert mine.tuned_nprobe() == ref.tuned_nprobe()
    assert mine.tuned_ef() == ref.tuned_ef()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tuner_metadata_cross_loads(tmp_path, writer):
    """A saved collection's `tuners` / `probe_seq` metadata, written by
    either package, restores the same knobs in the other; the loading
    side's target_recall wins over the saved one."""
    ref, mine = _twins(f"meta-{writer}", "probed")
    for _ in range(3):
        ref.recall_probe()
        mine.recall_probe()
    src = mine if writer == "port" else ref
    src.save_into(str(tmp_path))
    with open(os.path.join(tmp_path, "collection.json")) as f:
        meta = json.load(f)
    assert meta["probe_seq"] == 3
    assert set(meta["tuners"]) == {"nprobe", "ef"}
    assert set(meta["tuners"]["nprobe"]) == set(
        jtuner.RecallTuner(0.9, 1, 1, 2).to_dict())
    kw = dict(target_recall=0.85, **GRAPH)
    if writer == "port":
        back = JCollection.load_from(str(tmp_path), src.name, _jcfg(**kw))
    else:
        back = Collection.load_from(str(tmp_path), src.name, _cfg(**kw),
                                    device="cpu")
    assert back._probe_seq == 3
    assert back.tuned_nprobe() == src.tuned_nprobe()
    for t in ("_nprobe_tuner", "_ef_tuner"):
        want = dict(getattr(src, t).stats(), target=0.85)
        assert getattr(back, t).stats() == want


def test_auto_policy_and_routes_match_reference():
    """The same writes move both packages' auto tenants through the same
    policies and resolved (k, nprobe, path) triples."""
    th = dict(flat_max_rows=160, hnsw_min_rows=400)
    cfg_kw = dict(index_policy="auto", target_recall=0.9, **GRAPH)
    ref = JCollection("a", _jcfg(**cfg_kw),
                      thresholds=jtemplates.TemplateThresholds(**th))
    mine = _coll("a", _cfg(**cfg_kw),
                 thresholds=templates.TemplateThresholds(**th))
    steps = [("build", _corpus(150, seed=44)), ("insert", _corpus(150, 45)),
             ("insert", _corpus(100, seed=46)), ("delete", np.arange(200))]
    for op, arg in steps:
        for c in (ref, mine):
            getattr(c, op)(arg)
        assert mine.index_policy() == ref.index_policy()
        for b in (1, 8, 64):
            assert mine.resolve_query(b, None, None, None) == \
                ref.resolve_query(b, None, None, None)


def test_thresholds_match_reference():
    from repro.configs.ame_paper import PAPER_1M as J1M
    from repro_torch.configs.ame_paper import PAPER_1M
    mine = templates.TemplateThresholds.from_profile(PAPER_1M)
    ref = jtemplates.TemplateThresholds.from_profile(J1M)
    for f in ("flat_max_rows", "hnsw_min_rows", "probe_interval_ops",
              "probe_sample"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert dataclasses.asdict(templates.route("probe", 1, PAPER_1M)) == \
        dataclasses.asdict(jtemplates.route("probe", 1, J1M))
