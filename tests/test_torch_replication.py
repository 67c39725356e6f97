"""Replication of the port on the CPU: shipping log, replica apply, failover,
admission shedding.

The first nine tests are the reference's tier-1 fault plans
(`tests/test_replication_faults.py`) run against `repro_torch` at the
reference's sizes, and its five seeded random plans stay under the
`property` marker as there.  The rest hold the port to the JAX package and
to its own protocol: one scripted plan through both packages' ReplicaSets
(equal stats after every step, live sets, shipped entries, full-scan ids),
`apply_delta_batch` on a carried reference state against the reference's
(coincident integer rows, so the arithmetic is exact), the bootstrap
snapshot and the random-stream twin, the per-leaf `flat_rows_host`, the
ship payload's private copy, the derived graph mirrored by shipped writes,
and ack-implies-logged under concurrent writers.  Run with
AME_DEBUG_LOCKS=1 too: the lock-order validator fails a test that inverts
the hierarchy.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import MemoryService as JMemoryService
from repro.api import ReplicaSet as JReplicaSet
from repro.api.collection import Collection as JCollection
from repro.configs.base import EngineConfig as JConfig
from repro.core import index as jivf
from repro_torch.api import (AdmissionControl, Collection, MemoryService,
                             Overloaded, ReplicaSet)
from repro_torch.api.replication import (NoFreshReplica, PrimaryDead,
                                         ReplicaDead, ShippingLog)
from repro_torch.configs.base import EngineConfig
from repro_torch.convert import ivf_state_from_numpy
from repro_torch.core import index as ivf
from repro_torch.core import locking
from repro_torch.core.scheduler import Task

jax.config.update("jax_platform_name", "cpu")

D = 128
COLL = "mem"
ARGS = dict(dim=D, n_clusters=128, list_capacity=64, nprobe=64, k=10,
            use_kernel=False, kmeans_iters=3)


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


def _rows(rng, n):
    return rng.standard_normal((n, D)).astype(np.float32)


def live_ids(state):
    ids = torch.cat([state.list_ids.reshape(-1), state.spill_ids]).numpy()
    return set(ids[ids >= 0].tolist())


def _same_leaves(a, b, what=""):
    for f, x, y in zip(ivf.IVFState._fields, a, b):
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f"{what} leaf {f} differs"


class ScriptedFaults:
    """Deterministic fault plan for the pump (the reference test's).

    `ship` maps (replica_name, first_seq_of_batch) -> verdict, fired once
    each; `kill_at` maps replica_name -> seq whose apply raises
    `ReplicaDead` (fired once).  Anything unscripted is "ok".  `dead` is
    the ReplicaDead type to raise (each package has its own).
    """

    def __init__(self, ship=None, kill_at=None, dead=ReplicaDead):
        self.ship = dict(ship or {})
        self.kill_at = dict(kill_at or {})
        self.dead = dead
        self.fired = []

    def on_ship(self, replica, collection, entries):
        verdict = self.ship.pop((replica, entries[0].seq), "ok")
        if verdict != "ok":
            self.fired.append((replica, entries[0].seq, verdict))
        return verdict

    def on_apply(self, replica, collection, entry):
        if self.kill_at.get(replica) == entry.seq:
            del self.kill_at[replica]
            self.fired.append((replica, entry.seq, "kill"))
            raise self.dead(f"{replica} killed applying seq {entry.seq}")


def _mk(injector=None, n_replicas=2, ship_batch=4, max_lag_ops=1024,
        n0=256, seed=0, cfg=None, **svc_kw):
    """ReplicaSet over a fresh CPU primary with one built collection;
    returns (rs, rng, acked) where `acked` is the live-id oracle — the set
    of ids whose write RETURNED (was acked) on the primary."""
    svc = MemoryService(maintenance=False, device="cpu", **svc_kw)
    rs = ReplicaSet(svc, n_replicas=n_replicas, ship_batch=ship_batch,
                    max_lag_ops=max_lag_ops, fault_injector=injector)
    rs.create_collection(COLL, cfg or _cfg())
    rng = np.random.default_rng(seed)
    rs.build(COLL, _rows(rng, n0), ids=np.arange(n0))
    acked = set(range(n0))
    return rs, rng, acked


def _churn(rs, rng, acked, inserts=3, deletes=2, batch=8):
    """Acked write bursts against the primary, mirrored into `acked`."""
    next_id = max(acked) + 1 if acked else 0
    for _ in range(inserts):
        ids = np.arange(next_id, next_id + batch)
        rs.insert(COLL, _rows(rng, batch), ids=ids)
        acked.update(int(i) for i in ids)      # returned => acked
        next_id += batch
    live = sorted(acked)
    for _ in range(deletes):
        victims = rng.choice(live, size=min(4, len(live)), replace=False)
        rs.delete(COLL, victims)
        acked.difference_update(int(v) for v in victims)
        live = sorted(acked)


def _primary_live(rs):
    return live_ids(rs.primary.collection(COLL).snapshot())


def _replica_live(rep):
    return live_ids(rep.service.collection(COLL).snapshot())


def _assert_parity(rs, rep, rng):
    """Caught-up replica must answer queries bitwise-identically."""
    qs = _rows(rng, 8)
    p_ids, p_scores = rs.primary.query(COLL, qs)
    r_ids, r_scores = rep.service.query(COLL, qs)
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_array_equal(p_scores, r_scores)


# ---------------------------------------------------------------------------
# The reference's tier-1 fault plans, on the port
# ---------------------------------------------------------------------------

def test_ship_and_bitwise_parity():
    rs, rng, acked = _mk()
    _churn(rs, rng, acked)
    rs.pump()
    assert _primary_live(rs) == acked
    for rep in rs.replicas:
        assert rep.watermark(COLL) == rs._logs[COLL].last_seq()
        assert _replica_live(rep) == acked
        _assert_parity(rs, rep, rng)
        _same_leaves(rep.service.collection(COLL).snapshot(),
                     rs.primary.collection(COLL).snapshot(), rep.name)
    # every live replica caught up => the log trims to empty
    assert rs.stats()["log_retained"][COLL] == 0
    rs.shutdown()


def test_dropped_batch_is_lag_not_loss():
    # drop replica-0's first two shipped batches (the build is seq 1, so
    # with ship_batch=4 batches start at seqs 1 and 5)
    faults = ScriptedFaults(ship={("replica-0", 1): "drop",
                                  ("replica-0", 5): "drop"})
    rs, rng, acked = _mk(injector=faults)
    _churn(rs, rng, acked)
    out = rs.pump()
    assert len(faults.fired) >= 1
    lag = rs.lag(COLL)[COLL]
    assert lag["replica-0"] > 0, "dropped batch must show as lag"
    assert lag["replica-1"] == 0
    # the dropped entries are still in the log: the next pumps re-ship
    # them (at-least-once delivery) and the replica fully recovers
    while rs.lag(COLL)[COLL]["replica-0"] > 0:
        out = rs.pump()
        assert out["shipped"] >= 0
    assert _replica_live(rs.replicas[0]) == acked
    _assert_parity(rs, rs.replicas[0], rng)
    assert rs.stats()["fault_counts"]["drop"] == 2
    rs.shutdown()


def test_duplicate_batch_applies_once():
    faults = ScriptedFaults(ship={("replica-1", 1): "duplicate"})
    rs, rng, acked = _mk(injector=faults)
    _churn(rs, rng, acked)
    rs.pump()
    assert faults.fired == [("replica-1", 1, "duplicate")]
    # idempotent apply: the duplicated batch is skipped at the watermark,
    # so no id is double-inserted and parity stays bitwise
    for rep in rs.replicas:
        assert _replica_live(rep) == acked
        _assert_parity(rs, rep, rng)
    rs.shutdown()


def test_delayed_batch_bounded_staleness():
    # delay replica-0's first shipped batch (first seq = 1: the build)
    faults = ScriptedFaults(ship={("replica-0", 1): "delay"})
    rs, rng, acked = _mk(injector=faults, max_lag_ops=4)
    _churn(rs, rng, acked, inserts=4, deletes=2)    # 6 ops past the build
    rs.pump()
    lag = rs.lag(COLL)[COLL]
    assert lag["replica-0"] > rs.max_lag_ops >= 0
    # routing must refuse the stale replica...
    rs.kill_replica("replica-1")
    with pytest.raises(NoFreshReplica):
        rs.query(COLL, _rows(rng, 2), prefer="replica")
    # ...until the delayed batches arrive and staleness re-bounds
    rs.pump()
    assert rs.lag(COLL)[COLL]["replica-0"] == 0
    ids, _ = rs.query(COLL, _rows(rng, 2), prefer="replica")
    assert ids.shape == (2, 10)
    assert rs.stats()["replica_queries"] == 1
    rs.shutdown()


def test_kill_replica_mid_apply_is_atomic():
    # kill replica-0 while it applies seq 3 — mid-batch (after the first
    # pump ships the build at seq 1, the churn batch spans seqs 2-5)
    faults = ScriptedFaults(kill_at={"replica-0": 3})
    rs, rng, acked = _mk(injector=faults)
    rs.pump()                      # both replicas apply the build (seq 1)
    before = {rep.name: rep.watermark(COLL) for rep in rs.replicas}
    dead_coll = rs.replicas[0].service.collection(COLL)
    snap = dead_coll.snapshot()
    _churn(rs, rng, acked)
    rs.pump()
    dead, alive = rs.replicas[0], rs.replicas[1]
    assert not dead.alive and alive.alive
    # atomic batch apply: the killed replica's watermark and state are
    # exactly the pre-batch publication — no torn half-applied batch
    assert dead.watermark(COLL) == before["replica-0"] == 1
    assert _replica_live(dead) == set(range(256))
    assert dead_coll.snapshot() is snap
    # the survivor is unaffected and the set still serves + fails over
    assert _replica_live(alive) == acked
    rs.kill_primary()
    out = rs.failover()
    assert out["promoted"] == "replica-1"
    assert _primary_live(rs) == acked
    assert rs.stats()["fault_counts"]["kill"] == 1
    rs.shutdown()


def test_primary_kill_failover_loses_no_acked_write():
    rs, rng, acked = _mk(ship_batch=4)
    _churn(rs, rng, acked, inserts=4, deletes=2)
    # ship only part of the backlog (one batch per replica), then kill the
    # primary mid-window: replicas are behind by construction
    rs.pump(max_batches=1)
    lag = rs.lag(COLL)[COLL]
    assert max(lag.values()) > 0, "test needs replicas mid-window"
    rs.kill_primary()
    with pytest.raises(PrimaryDead):
        rs.insert(COLL, _rows(rng, 2))
    out = rs.failover()
    # the failover replayed the shipping-log tail: every acked write is
    # present on the promoted primary
    assert out["replayed"] > 0
    assert out["failover_ms"] >= 0
    assert _primary_live(rs) == acked, "acked write lost across failover"
    # the promoted service accepts writes and keeps shipping to the
    # surviving replica (sequence numbers continue on the shared log)
    new_ids = np.arange(10_000, 10_008)
    rs.insert(COLL, _rows(rng, 8), ids=new_ids)
    acked.update(int(i) for i in new_ids)
    rs.pump()
    assert _primary_live(rs) == acked
    (survivor,) = rs.replicas
    assert _replica_live(survivor) == acked
    _assert_parity(rs, survivor, rng)
    rs.shutdown()


def test_preemption_drain_makes_failover_replay_free():
    """SIGTERM-style preemption (PreemptionGuard.request) drains the log
    before the switch: a planned failover replays zero entries."""
    rs, rng, acked = _mk()
    _churn(rs, rng, acked)
    out = rs.planned_failover()
    assert out["replayed"] == 0
    assert _primary_live(rs) == acked
    assert not rs.guard.should_checkpoint      # consumed by the failover
    rs.shutdown()


def _wedge_and_fill(sched, adm):
    """Wedge every worker, then fill both query-capable queues to the
    admission limit (the reference test's recipe); returns the gate."""
    gate = threading.Event()

    def wedge(started):
        started.set()
        gate.wait()

    for backend in ("background", "throughput", "latency"):
        started = threading.Event()
        sched.submit(Task(fn=lambda ev=started: wedge(ev), kind="query",
                          backend=backend))
        assert started.wait(timeout=10), f"{backend} wedge never ran"
    for backend in ("latency", "throughput"):
        for _ in range(adm.max_queue_depth):
            sched.submit(Task(fn=lambda: None, kind="query", backend=backend))
    return gate


def test_overloaded_primary_sheds_query_to_replica():
    # depth-only admission: est-wait rejection would make the filler
    # submissions below racy
    adm = AdmissionControl(max_queue_depth=2, max_queue_wait_s=None)
    rs, rng, acked = _mk(admission=adm)
    _churn(rs, rng, acked, inserts=1, deletes=0)
    rs.pump()
    gate = _wedge_and_fill(rs.primary.scheduler, adm)
    try:
        qs = _rows(rng, 2)
        with pytest.raises(Overloaded):
            rs.primary.query(COLL, qs)
        ids, _ = rs.query(COLL, qs)            # sheds instead of failing
        assert ids.shape == (2, 10)
        assert rs.stats()["shed_to_replica"] == 1
        r_ids, _ = rs.replicas[0].service.query(COLL, qs)
        np.testing.assert_array_equal(ids, r_ids)
    finally:
        gate.set()
    rs.shutdown()


def test_shipping_log_trim_and_gap_detection():
    log = ShippingLog("c")
    for i in range(10):
        log.append("insert", None, np.asarray([i]))
    assert log.last_seq() == 10
    assert [e.seq for e in log.tail(4, limit=3)] == [5, 6, 7]
    assert log.trim(6) == 6
    assert log.retained() == 4
    assert [e.seq for e in log.tail(6)] == [7, 8, 9, 10]
    with pytest.raises(RuntimeError, match="trim horizon"):
        log.tail(3)                    # fell behind the trim horizon


# ---------------------------------------------------------------------------
# Randomized fault plans (property marker, as in the reference)
# ---------------------------------------------------------------------------

class RandomFaults:
    """Seeded random verdicts: each shipped batch may drop/delay/duplicate;
    never kills."""

    def __init__(self, seed, p_fault=0.3):
        self.rng = np.random.default_rng(seed)
        self.p_fault = p_fault

    def on_ship(self, replica, collection, entries):
        if self.rng.random() < self.p_fault:
            return str(self.rng.choice(["drop", "delay", "duplicate"]))
        return "ok"


@pytest.mark.property
@pytest.mark.parametrize("seed", range(5))
def test_property_random_faults_never_lose_acked_writes(seed):
    rng = np.random.default_rng(1000 + seed)
    rs, data_rng, acked = _mk(injector=RandomFaults(seed), seed=seed)
    next_id = 256
    for _ in range(rng.integers(3, 8)):
        op = rng.choice(["insert", "delete", "pump"])
        if op == "insert":
            n = int(rng.integers(2, 12))
            ids = np.arange(next_id, next_id + n)
            rs.insert(COLL, _rows(data_rng, n), ids=ids)
            acked.update(int(i) for i in ids)
            next_id += n
        elif op == "delete" and acked:
            victims = rng.choice(sorted(acked),
                                 size=min(3, len(acked)), replace=False)
            rs.delete(COLL, victims)
            acked.difference_update(int(v) for v in victims)
        else:
            rs.pump(max_batches=int(rng.integers(1, 3)))
        # watermarks only advance, and never past the shipped seq
        last = rs._logs[COLL].last_seq()
        assert all(0 <= r.watermark(COLL) <= last for r in rs.replicas)
    rs.kill_primary()
    rs.failover()
    assert _primary_live(rs) == acked
    rs._injector = None
    for _ in range(64):
        if all(r.watermark(COLL) == rs._logs[COLL].last_seq()
               for r in rs.replicas if r.alive):
            break
        rs.pump()
    for rep in rs.replicas:
        if rep.alive:
            assert _replica_live(rep) == acked
            _assert_parity(rs, rep, data_rng)
    rs.shutdown()


# ---------------------------------------------------------------------------
# One plan through both packages
# ---------------------------------------------------------------------------

STAT_KEYS = ("primary_alive", "lag", "log_retained", "shed_to_replica",
             "replica_queries", "fault_counts")


def _stats(rs):
    st = rs.stats()
    out = {k: st[k] for k in STAT_KEYS}
    out["failovers"] = [(f["promoted"], f["replayed"])
                        for f in st["failovers"]]
    out["replicas"] = {n: {"alive": r["alive"], "applied": r["applied"],
                           "apply_errors": r["apply_errors"]}
                       for n, r in st["replicas"].items()}
    return out


def _j_live(svc):
    st = svc.collection(COLL).snapshot()
    ids = np.concatenate([np.asarray(st.list_ids).ravel(),
                          np.asarray(st.spill_ids).ravel()])
    return set(ids[ids >= 0].tolist())


def _record(rs, seen):
    """Every entry the log still holds, by seq (the log trims)."""
    log = rs._logs[COLL]
    for e in log.tail(log._base):
        seen.setdefault(e.seq, e)


def test_scripted_plan_matches_reference_step_by_step():
    """One op and fault plan through `repro.api.ReplicaSet` and the port's:
    after every step the same stats (lag, log_retained, fault counts,
    failovers' promoted/replayed, query counters), the same live ids on the
    primary and on every replica; at the end the same shipped entries (seq,
    kind, rows bit for bit, ids) and the same full-scan ids."""
    # replica-2 dies applying seq 4; both survivors' second batch is
    # delayed when the primary dies, so the failover replays their tail
    plan = dict(ship={("replica-0", 1): "drop", ("replica-1", 1): "duplicate",
                      ("replica-0", 7): "delay", ("replica-1", 7): "delay"},
                kill_at={"replica-2": 4})
    from repro.api.replication import ReplicaDead as JReplicaDead
    sides = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            svc = JMemoryService(maintenance=False)
            rs = JReplicaSet(svc, n_replicas=3, ship_batch=3,
                             fault_injector=ScriptedFaults(dead=JReplicaDead,
                                                           **plan))
            rs.create_collection(COLL, JConfig(**ARGS))
        else:
            svc = MemoryService(maintenance=False, device="cpu")
            rs = ReplicaSet(svc, n_replicas=3, ship_batch=3,
                            fault_injector=ScriptedFaults(**plan))
            rs.create_collection(COLL, _cfg())
        sides[pkg] = rs
    rng = np.random.default_rng(5)
    base = _rows(rng, 256)
    steps = [("build", base, np.arange(256))]
    for i in range(3):
        steps.append(("insert", _rows(rng, 8), np.arange(300 + 8 * i,
                                                         308 + 8 * i)))
    steps += [("delete", None, np.asarray([3, 5, 300, 9999])),
              ("pump", 1, None), ("insert", _rows(rng, 5), None),
              ("query", _rows(rng, 2), "replica"), ("pump", None, None),
              ("insert", _rows(rng, 4), np.arange(400, 404)),
              ("delete", None, np.asarray([7, 401])), ("pump", 1, None),
              ("kill_primary", None, None), ("failover", None, None),
              ("insert", _rows(rng, 6), np.arange(500, 506)),
              ("query", _rows(rng, 3), "primary"), ("pump", None, None)]
    seen = {pkg: {} for pkg in sides}
    for step in steps:
        kind, a, b = step
        for pkg, rs in sides.items():
            if kind in ("build", "insert"):
                getattr(rs, kind)(COLL, a, ids=b)
            elif kind == "delete":
                rs.delete(COLL, b)
            elif kind == "pump":
                rs.pump(max_batches=a)
            elif kind == "query":
                ids, _ = rs.query(COLL, a, prefer=b)
                assert ids.shape == (len(a), 10)
            else:
                getattr(rs, kind)()
            _record(rs, seen[pkg])
        j, t = sides["jax"], sides["torch"]
        assert _stats(t) == _stats(j), kind
        assert live_ids(t.primary.collection(COLL).snapshot()) == \
            _j_live(j.primary), kind
        for jr, tr in zip(j.replicas, t.replicas):
            assert tr.name == jr.name
            assert live_ids(tr.service.collection(COLL).snapshot()) == \
                _j_live(jr.service), (kind, tr.name)
    st = sides["torch"].stats()
    assert st["fault_counts"] == {"drop": 1, "delay": 2, "duplicate": 1,
                                  "kill": 1}
    assert st["failovers"][0]["replayed"] > 0
    # the same shipped entries, in the same order, bit for bit
    assert sorted(seen["torch"]) == sorted(seen["jax"]) == \
        list(range(1, sides["torch"]._logs[COLL].last_seq() + 1))
    for seq, te in seen["torch"].items():
        je = seen["jax"][seq]
        assert (te.seq, te.kind) == (je.seq, je.kind)
        assert te.ids.dtype == je.ids.dtype == np.int32
        np.testing.assert_array_equal(te.ids, je.ids)
        if je.rows is None:
            assert te.rows is None
        else:
            assert te.rows.dtype == je.rows.dtype == np.float32
            np.testing.assert_array_equal(te.rows, je.rows)
    # the exact full scan ranks the same live rows on both primaries
    q = _rows(rng, 4)
    j_ids, _ = sides["jax"].primary.query(COLL, q, path="full_scan")
    t_ids, _ = sides["torch"].primary.query(COLL, q, path="full_scan")
    np.testing.assert_array_equal(t_ids, j_ids)
    for rs in sides.values():
        rs.shutdown()


# ---------------------------------------------------------------------------
# Collection.apply_delta_batch against the reference's
# ---------------------------------------------------------------------------

def _carried_pair(spill=32):
    """A reference collection and a port collection holding the same state
    bit for bit: C distinct small-integer centroids and clusters of rows
    coinciding with them, so every assignment of a later insert is exact."""
    c = 128
    args = {**ARGS, "list_capacity": 8, "metric": "l2"}
    jcfg, tcfg = JConfig(**args), EngineConfig(**args)
    centers = np.random.default_rng(40).integers(-8, 9, (c, D)).astype(
        np.float32)
    assign = np.repeat(np.arange(c, dtype=np.int32), 5)
    x = centers[assign]
    ids = np.arange(len(x), dtype=np.int32)
    jstate = jivf.empty_state(jcfg, spill)._replace(
        centroids=jnp.asarray(centers))
    jstate, _ = jivf._pack(jstate, jnp.asarray(x), jnp.asarray(ids),
                           jnp.asarray(assign), jcfg)
    jstate = jax.device_get(jstate)
    jcoll = JCollection("j", jcfg, spill_capacity=spill)
    jcoll.state = jax.tree_util.tree_map(jnp.asarray, jstate)
    tcoll = Collection("t", tcfg, spill_capacity=spill, device="cpu")
    tcoll._swap(ivf_state_from_numpy(jstate, device="cpu"))
    for coll in (jcoll, tcoll):
        coll._built = True
        coll._next_id = len(x)
        coll._approx_live = len(x)
    return jcoll, tcoll, centers


@pytest.mark.parametrize("first", ["insert", "delete"])
def test_apply_delta_batch_matches_reference(first):
    """A batch whose first op runs through the copying kernel and the rest
    replays in place: the same leaves bit for bit, the same counters and
    pressure, and the snapshot read before the batch is untouched."""
    jcoll, tcoll, centers = _carried_pair()
    rng = np.random.default_rng(41)

    def ins(n, lo):
        pick = rng.integers(0, len(centers), n)
        return "insert", centers[pick], np.arange(lo, lo + n, dtype=np.int32)

    # 3 more rows per cluster fill the 8-slot lists; the rest spill
    plan = [ins(160, 1000), ("delete", None, np.asarray([0, 7, 1003, 77777],
                                                        np.int32)),
            ins(200, 2000), ("delete", None, np.asarray([2001, 5], np.int32)),
            ins(120, 3000)]
    if first == "delete":
        plan = plan[1:] + plan[:1]
    before = tcoll.snapshot()
    kept = [t.clone() for t in before if t is not None]
    jout = jcoll.apply_delta_batch([jivf.DeltaOp(k, r, i) for k, r, i in plan])
    tout = tcoll.apply_delta_batch([ivf.DeltaOp(k, r, i) for k, r, i in plan])
    assert tout == jout
    assert tout["spilled"] > 0 and tout["tombstoned"] > 0
    jstate = jax.device_get(jcoll.snapshot())
    for f, t, j in zip(ivf.IVFState._fields, tcoll.snapshot(), jstate):
        if t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f)
    for a, b in zip([t for t in before if t is not None], kept):
        assert torch.equal(a, b), "the published snapshot changed"
    assert tcoll.counters == jcoll.counters
    assert tcoll.maintenance_pressure() == jcoll.maintenance_pressure()
    assert tcoll._approx_live == jcoll._approx_live
    assert tcoll._next_id == jcoll._next_id == 3120
    assert tcoll.version() == 2


def test_apply_delta_batch_logs_for_a_rebuild_in_flight():
    """Shipped ops that land while a rebuild recomputes go to the delta log
    and are replayed onto the rebuilt state: none is lost."""
    coll = Collection("c", _cfg(), spill_capacity=256, device="cpu")
    rng = np.random.default_rng(42)
    coll.build(_rows(rng, 256), ids=np.arange(256))
    with coll._lock:
        coll._delta_logs[0] = []
    ops = [ivf.DeltaOp("insert", _rows(rng, 8), np.arange(500, 508)),
           ivf.DeltaOp("delete", None, np.asarray([1, 2, 503]))]
    coll.apply_delta_batch(ops)
    with coll._lock:
        log, coll._delta_logs[0] = coll._delta_logs[0], None
    assert [op.kind for op in log] == ["insert", "delete"]
    assert log[0].ids.tolist() == list(range(500, 508))
    with pytest.raises(ValueError, match="kind"):
        coll.apply_delta_batch([ivf.DeltaOp("upsert", None, [1])])
    with pytest.raises(RuntimeError, match="build"):
        Collection("d", _cfg(), device="cpu").apply_delta_batch(ops)


# ---------------------------------------------------------------------------
# Bootstrap snapshot and the random-stream twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_adopted_before_build_replicas_are_bit_equal(store_dtype):
    """The bootstrap of an unbuilt primary twins its seed, draw count and
    id allocator; the shipped build then replays the primary's random
    stream, so every leaf (the int8 store's too) is equal after churn, a
    rebuild-free batch of inserts/deletes, and a second shipped build."""
    cfg = _cfg(store_dtype=store_dtype, list_capacity=16)
    svc = MemoryService(maintenance=False, device="cpu")
    svc.create_collection(COLL, cfg, seed=7)
    rs = ReplicaSet(svc, n_replicas=1, ship_batch=64)
    rcoll = rs.replicas[0].service.collection(COLL)
    assert (rcoll.seed, rcoll._n_draws, rcoll._next_id) == (7, 0, 0)
    rng = np.random.default_rng(43)
    rs.build(COLL, _rows(rng, 300))
    acked = set(range(300))
    _churn(rs, rng, acked)
    rs.pump()
    prim = svc.collection(COLL)
    _same_leaves(rcoll.snapshot(), prim.snapshot(), "after churn")
    rs.build(COLL, _rows(rng, 200))            # a second draw of the stream
    rs.insert(COLL, _rows(rng, 10))
    rs.pump()
    _same_leaves(rcoll.snapshot(), prim.snapshot(), "after a second build")
    assert (rcoll._n_draws, rcoll._next_id) == (prim._n_draws,
                                                prim._next_id)
    assert prim._n_draws == 2
    rs.shutdown()


def test_attach_snapshot_bootstraps_a_built_primary():
    """Adopting a built, churned primary: the snapshot is the flat slot
    arrays and the stream position at the hook install; the replica holds
    the same live rows (not the same slots: its bootstrap build draws its
    own centroids, as the reference's does) and continues the id space."""
    svc = MemoryService(maintenance=False, device="cpu")
    prim = svc.create_collection(COLL, _cfg(), seed=3)
    rng = np.random.default_rng(44)
    x = _rows(rng, 256)
    svc.build(COLL, x)
    svc.insert(COLL, _rows(rng, 8))
    svc.delete(COLL, [0, 1, 2])
    hooked = []
    boot = prim.attach_shipper(lambda *a: hooked.append(a))
    assert boot["built"] and boot["next_id"] == 264
    assert boot["key"] == {"seed": 3, "n_draws": 1}
    rows, ids = ivf.flat_rows_host(prim.snapshot())
    np.testing.assert_array_equal(boot["rows"], rows)
    np.testing.assert_array_equal(boot["ids"], ids)
    prim.set_ship_hook(None)
    rs = ReplicaSet(svc, n_replicas=1)
    rcoll = rs.replicas[0].service.collection(COLL)
    assert live_ids(rcoll.snapshot()) == live_ids(prim.snapshot())
    assert rcoll._next_id == 264 and rcoll.seed == 3
    assert rcoll._n_draws == 2           # the bootstrap build took a draw
    live = np.nonzero(ids >= 0)[0]
    q = rows[live[:4]]
    np.testing.assert_array_equal(
        rs.primary.query(COLL, q, path="full_scan")[0],
        rs.replicas[0].service.query(COLL, q, path="full_scan")[0])
    rs.insert(COLL, _rows(rng, 4))
    rs.pump()
    assert live_ids(rcoll.snapshot()) == live_ids(prim.snapshot())
    assert not hooked
    rs.shutdown()


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_flat_rows_host_equals_the_concatenation(store_dtype):
    coll = Collection("c", _cfg(store_dtype=store_dtype, list_capacity=8),
                      spill_capacity=64, device="cpu")
    rng = np.random.default_rng(45)
    coll.build(_rows(rng, 1100))             # lists overflow into the spill
    coll.delete(np.arange(0, 1100, 7))
    st = coll.snapshot()
    assert int(st.spill_size) > 0
    rows, ids = ivf.flat_rows_host(st)
    want_rows = torch.cat([st.lists.reshape(-1, D), st.spill]).numpy()
    want_ids = torch.cat([st.list_ids.reshape(-1), st.spill_ids]).numpy()
    assert rows.dtype == np.float32 and ids.dtype == np.int32
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(ids, want_ids)
    for t in st:
        if t is not None:
            assert not np.shares_memory(rows, t.numpy())
            assert not np.shares_memory(ids, t.numpy())


@pytest.mark.parametrize("as_torch,dtype", [(False, np.float32),
                                            (False, np.float64),
                                            (True, np.float32)])
def test_ship_payload_is_a_private_copy_of_what_was_written(as_torch, dtype):
    """The payload is one copy: of the caller's buffer (f32 rows and i32
    ids go into the state without a conversion, so the write's tensors
    alias the caller's arrays) or of the converted rows."""
    svc = MemoryService(maintenance=False, device="cpu")
    svc.create_collection(COLL, _cfg())
    rs = ReplicaSet(svc, n_replicas=1)
    rng = np.random.default_rng(46)
    rs.build(COLL, _rows(rng, 256))
    x = _rows(rng, 8).astype(dtype)
    gone = np.asarray([4, 5], np.int32 if dtype == np.float32 else np.int64)
    if as_torch:
        x, gone = torch.from_numpy(x), torch.from_numpy(gone)
    rs.insert(COLL, x)
    rs.delete(COLL, gone)
    ins, dele = rs._logs[COLL].tail(1)
    assert (ins.kind, dele.kind) == ("insert", "delete")
    assert ins.rows.dtype == np.float32 and ins.ids.dtype == np.int32
    np.testing.assert_array_equal(ins.rows, np.asarray(x, np.float32))
    np.testing.assert_array_equal(ins.ids, np.arange(256, 264))
    np.testing.assert_array_equal(dele.ids, [4, 5])
    st = svc.collection(COLL).snapshot()
    rows, ids = ivf.flat_rows_host(st)                # lists and spill
    np.testing.assert_array_equal(np.sort(rows[np.isin(ids, ins.ids)], 0),
                                  np.sort(ins.rows, 0))
    for a in (ins.rows, ins.ids, dele.ids):
        assert not np.shares_memory(a, np.asarray(x))
        assert not np.shares_memory(a, np.asarray(gone))
        for t in st:
            if t is not None:
                assert not np.shares_memory(a, t.numpy())
    kept = ins.rows.copy()
    x[:] = 0                                   # the caller reuses its buffer
    gone[:] = -1
    np.testing.assert_array_equal(ins.rows, kept)
    np.testing.assert_array_equal(dele.ids, [4, 5])
    rs.shutdown()


def test_shipped_writes_reach_the_replica_graph():
    """An hnsw-policy replica mirrors shipped inserts and deletes into its
    derived graph (the same graph object, no rebuild), answers graph
    queries as the primary does, and never returns a deleted id."""
    cfg = _cfg(index_policy="hnsw", hnsw_m=4, hnsw_ef=16, list_capacity=8)
    svc = MemoryService(maintenance=False, device="cpu")
    svc.create_collection(COLL, cfg)
    rs = ReplicaSet(svc, n_replicas=1, ship_batch=8)
    rng = np.random.default_rng(47)
    x = _rows(rng, 200)
    rs.build(COLL, x)
    rs.pump()
    prim = svc.collection(COLL)
    rcoll = rs.replicas[0].service.collection(COLL)
    q = x[:3]
    for coll in (prim, rcoll):
        coll.query(q)                     # builds each derived graph
    graph = rcoll._graph
    assert graph is not None
    new = _rows(rng, 6)
    rs.insert(COLL, new, ids=np.arange(500, 506))
    rs.delete(COLL, [0, 1, 502])
    rs.pump()
    assert rcoll._graph is graph, "the apply rebuilt instead of mirroring"
    got = set(graph.live_ids().tolist())
    assert {500, 501, 503, 504, 505} <= got and not {0, 1, 502} & got
    probe = np.concatenate([q, new])
    p_ids, p_sc = prim.query(probe, path="hnsw")
    r_ids, r_sc = rcoll.query(probe, path="hnsw")
    np.testing.assert_array_equal(p_ids, r_ids)
    np.testing.assert_array_equal(p_sc, r_sc)
    assert not {0, 1, 502} & set(r_ids.ravel().tolist())
    np.testing.assert_array_equal(r_ids[[3, 4, 6, 7, 8], 0],
                                  [500, 501, 503, 504, 505])
    rs.shutdown()


def test_acked_writes_are_logged_in_publication_order():
    """Two writer threads insert and delete while the main thread pumps:
    every write that returned had been handed to the shipping log before
    its return, and the replica that replays the log in seq order ends
    bit-equal to the primary."""
    rs, rng, acked = _mk(n_replicas=1, ship_batch=5)
    log = rs._logs[COLL]
    prim = rs.primary.collection(COLL)
    ship, logged = prim._ship_hook, set()

    def spy(kind, rows, ids):
        ship(kind, rows, ids)
        logged.add((kind, tuple(ids.tolist())))
    prim.set_ship_hook(spy)
    lock, errors = threading.Lock(), []

    def writer(w):
        try:
            wr = np.random.default_rng(100 + w)
            for i in range(12):
                ids = np.arange(1000 * (w + 1) + 8 * i,
                                1000 * (w + 1) + 8 * (i + 1))
                rs.insert(COLL, _rows(wr, 8), ids=ids)
                assert ("insert", tuple(ids.tolist())) in logged
                with lock:
                    acked.update(ids.tolist())
                if i % 3 == 2:
                    rs.delete(COLL, ids[:2])
                    assert ("delete", tuple(ids[:2].tolist())) in logged
                    with lock:
                        acked.difference_update(ids[:2].tolist())
        except BaseException as e:       # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(2)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        rs.pump()
        time.sleep(0.001)
    for t in threads:
        t.join()
    assert not errors, errors
    rs.pump()
    rep = rs.replicas[0]
    assert rep.watermark(COLL) == log.last_seq() == 1 + 24 + 8
    assert _primary_live(rs) == _replica_live(rep) == acked
    _same_leaves(rep.service.collection(COLL).snapshot(), prim.snapshot())
    rs.shutdown()


def test_replicas_live_on_the_primary_device():
    svc = MemoryService(maintenance=False, device="cpu")
    rs = ReplicaSet(svc, n_replicas=2)
    assert [r.service.device for r in rs.replicas] == [svc.device] * 2
    rs.create_collection(COLL, _cfg())
    assert all(r.service.collection(COLL).device == svc.device
               for r in rs.replicas)
    rs.shutdown()
