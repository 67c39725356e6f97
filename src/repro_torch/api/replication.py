"""Replicated serving tier: delta-log shipping, bounded staleness, failover;
port of ``src/repro/api/replication.py``.

The per-collection delta log is already a replication primitive: every
acked write is an ordered `(kind, rows, ids)` record.  This module ships
those records to query-only replica `MemoryService`s on the primary's
device:

    primary Collection --_ship hook--> ShippingLog (seq-numbered, trimmed)
                                          |  pump(): contiguous tails
                                          v
    Replica.apply: Collection.apply_delta_batch (shared-first + in-place
                   ivf.replay, ONE swap)  ->  applied-seq watermark

Protocol invariants, each proven on the port by
`tests/test_torch_replication.py` (the reference's
`tests/test_replication_faults.py` plans):

* **Ack implies logged.**  The shipping hook runs inside the primary's
  writer critical section after the state swap, so a write that returned
  to its caller is in the log; `attach_shipper` installs the hook and
  reads the bootstrap snapshot under the same writer lock, so the start
  of the log is consistent too.  Failover replays the log tail onto the
  promoted replica, hence **no acked write is ever lost**.
* **At-least-once delivery, exactly-once apply.**  A replica skips
  entries at or below its watermark, so duplicated batches are no-ops;
  dropped/delayed batches simply stay in the log and re-ship on the next
  pump (lag, never loss).
* **Atomic apply.**  `apply_delta_batch` publishes one swap per batch; a
  replica killed mid-apply keeps its pre-batch state and watermark.
* **Bounded staleness.**  `lag(collection)` = shipped-seq - applied-seq
  per replica; `query()` only routes to replicas within `max_lag_ops`.

Failover promotes the most-caught-up live replica, replays its shipping
tail, re-installs the ship hooks on the promoted service, and keeps the
surviving replicas subscribed (the log trims only below the minimum live
watermark, so a lagging survivor can always catch up).  The fault module
(`repro_torch.distributed.fault`) serves here: `PreemptionGuard` turns
SIGTERM (or a
programmatic `request()`) into a full pre-kill drain — a *planned*
failover replays nothing — and each replica's `StragglerMonitor` times
apply batches so query routing deprioritizes flagged stragglers.

Lock order (see repro_torch.core.locking): ReplicaSet's `_repl_lock` (35) >
replica `_admit_lock` (30) > `_writer_lock` (20) > `_ship_lock` (15) >
leaf `_lock` (10).  The ship hook (called at 20) only descends to 15;
the pump (at 35) applies into replicas through 30/20.  The hook never
pumps synchronously — that would invert 20 -> 35.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.service import MemoryService
from repro_torch.configs.base import EngineConfig
from repro_torch.core import index as ivf
from repro_torch.core import locking
from repro_torch.core.scheduler import Overloaded
from repro_torch.distributed.fault import PreemptionGuard, StragglerMonitor


class PrimaryDead(RuntimeError):
    """A write (or primary-only read) was routed to a dead primary; call
    `failover()` to promote a replica first."""


class ReplicaDead(RuntimeError):
    """Raised by a fault injector to kill a replica mid-apply; also the
    natural error type for a replica whose apply path crashed."""


class NoFreshReplica(RuntimeError):
    """No live replica is within `max_lag_ops` of the shipped sequence
    (pump and retry, or relax the staleness bound)."""


class ShipEntry:
    """One acked write in shipping order.  Host-side numpy payload — the
    log must survive the primary's device state (that is the point) — and
    a private copy: the caller's buffer may change after the ack."""

    __slots__ = ("seq", "kind", "rows", "ids")

    def __init__(self, seq: int, kind: str, rows: Optional[np.ndarray],
                 ids: np.ndarray):
        self.seq = seq
        self.kind = kind            # "build" | "insert" | "delete"
        self.rows = rows            # f32[B, D] for build/insert, None for delete
        self.ids = ids              # i32[B]

    def __repr__(self):
        return f"ShipEntry(seq={self.seq}, kind={self.kind!r}, n={len(self.ids)})"


class ShippingLog:
    """Per-collection seq-numbered log of acked writes.

    Appended from inside the primary's writer critical section (so log
    order == publication order) under `_ship_lock` (15); read by the pump
    under the same lock.  `trim(upto)` drops entries every live replica
    has applied — the log's footprint is O(max replica lag), not O(history).
    """

    def __init__(self, collection: str):
        self.collection = collection
        self._ship_lock = locking.make_lock("_ship_lock")
        self._entries: List[ShipEntry] = []   # contiguous; first seq = _base+1
        self._base = 0                        # highest trimmed-away seq
        self._last = 0                        # highest appended seq

    def append(self, kind: str, rows: Optional[np.ndarray],
               ids: np.ndarray) -> int:
        with self._ship_lock:
            self._last += 1
            self._entries.append(ShipEntry(self._last, kind, rows, ids))
            return self._last

    def last_seq(self) -> int:
        with self._ship_lock:
            return self._last

    def tail(self, after: int, limit: Optional[int] = None) -> List[ShipEntry]:
        """Entries with seq > `after`, oldest first (up to `limit`).
        Raises if `after` predates the trim horizon — a caller that far
        behind can no longer catch up from this log."""
        with self._ship_lock:
            if after < self._base:
                raise RuntimeError(
                    f"shipping log {self.collection!r}: tail after seq "
                    f"{after} predates trim horizon {self._base}")
            lo = after - self._base           # index of first wanted entry
            hi = len(self._entries) if limit is None else lo + limit
            return self._entries[lo:hi]

    def trim(self, upto: int) -> int:
        """Drop entries with seq <= `upto`; returns how many were dropped."""
        with self._ship_lock:
            n = min(max(0, upto - self._base), len(self._entries))
            if n:
                del self._entries[:n]
                self._base += n
            return n

    def retained(self) -> int:
        with self._ship_lock:
            return len(self._entries)


class Replica:
    """A query-only `MemoryService` fed by shipped delta batches.

    `applied` maps collection -> per-shard applied-seq watermarks (one
    entry per shard; unsharded replicas — the only kind the shipping tier
    currently builds — have a single shard, but the watermark shape
    matches the per-shard delta-log layout so a sharded replica slots in
    without a protocol change).  The watermark advances only after a
    batch's single swap, so it is always on an entry boundary.
    """

    def __init__(self, name: str, service: MemoryService):
        self.name = name
        self.service = service
        self.alive = True
        self.applied: Dict[str, List[int]] = {}
        self.monitor = StragglerMonitor(window=64, threshold=3.0)
        self.apply_errors = 0

    def watermark(self, collection: str) -> int:
        """The collection's applied seq (min across shards — an entry is
        applied only when every shard that wants it has it)."""
        marks = self.applied.get(collection)
        return min(marks) if marks else 0

    def stats(self) -> dict:
        return {"alive": self.alive,
                "applied": {c: self.watermark(c) for c in sorted(self.applied)},
                "apply_errors": self.apply_errors,
                "straggler": self.monitor.stats()}


class ReplicaSet:
    """Primary + N query-only replicas, linked by per-collection shipping
    logs (see module docstring for the protocol and its invariants).

    Adopt collections by creating them *through* the ReplicaSet (or
    constructing it after the primary's collections exist — both bootstrap
    via `Collection.attach_shipper`).  Replica services live on the
    primary's device: a set whose primary is on the card never places a
    replica on the CPU.  Drive shipping with `pump()` —
    deterministic and caller-clocked, which is what makes the fault
    harness reproducible; a serving loop calls it from a timer.

    `fault_injector` (tests) may define:
        on_ship(replica, collection, entries) -> "ok"|"drop"|"delay"|"duplicate"
        on_apply(replica, collection, entry)  -> None or raise ReplicaDead
    """

    def __init__(self, primary: MemoryService, n_replicas: int = 2, *,
                 max_lag_ops: int = 1024, ship_batch: int = 64,
                 replica_maintenance: bool = False,
                 fault_injector=None,
                 guard: Optional[PreemptionGuard] = None):
        # _repl_lock (35): serializes pump/failover/adopt against each
        # other while still ABOVE the admission/writer locks the apply
        # path takes inside replica collections
        self._repl_lock = locking.make_rlock("_repl_lock")
        self.primary = primary
        self.primary_alive = True
        self.max_lag_ops = max_lag_ops
        self.ship_batch = ship_batch
        self._injector = fault_injector
        self.guard = guard if guard is not None else PreemptionGuard(
            install=False)
        self.replicas: List[Replica] = [
            Replica(f"replica-{i}",
                    MemoryService(maintenance=replica_maintenance,
                                  device=primary.device))
            for i in range(n_replicas)]
        self._logs: Dict[str, ShippingLog] = {}
        self._create_kw: Dict[str, dict] = {}
        self.failovers: List[dict] = []
        self.shed_to_replica = 0
        self.replica_queries = 0
        self.fault_counts = {"drop": 0, "delay": 0, "duplicate": 0,
                             "kill": 0}
        for name in primary.list_collections():
            self._adopt(name)

    # ------------------------------------------------------------------
    # Collection adoption + shipping hooks
    # ------------------------------------------------------------------
    def create_collection(self, name: str, cfg: EngineConfig,
                          **kw):
        """Create on the primary and adopt for shipping (replica twins are
        created with the same cfg/spill/thresholds)."""
        coll = self.primary.create_collection(name, cfg, **kw)
        self._create_kw[name] = dict(kw)
        self._adopt(name)
        return coll

    def _make_hook(self, log: ShippingLog) -> Callable:
        def hook(kind: str, rows, ids) -> None:
            log.append(kind, rows, ids)
        return hook

    def _adopt(self, name: str) -> None:
        with self._repl_lock:
            if name in self._logs:
                return
            coll = self.primary.collection(name)
            log = ShippingLog(name)
            # hook install + bootstrap snapshot are atomic w.r.t. writers
            boot = coll.attach_shipper(self._make_hook(log))
            self._logs[name] = log
            kw = self._create_kw.get(name, {})
            for rep in self.replicas:
                rcoll = rep.service.create_collection(
                    name, coll.cfg,
                    spill_capacity=coll.spill_capacity,
                    thresholds=kw.get("thresholds"))
                # twin the random stream (the seed and the draws taken:
                # the reference's PRNG key) and the id allocator: a build
                # shipped as a log entry then replays with the primary's
                # exact stream, making replica state bitwise-identical
                with rcoll._lock:
                    rcoll.seed = boot["key"]["seed"]
                    rcoll._n_draws = boot["key"]["n_draws"]
                    rcoll._next_id = boot["next_id"]
                if boot["built"]:
                    ids = np.asarray(boot["ids"])
                    live = np.nonzero(ids >= 0)[0]
                    rcoll.build(np.asarray(boot["rows"])[live], ids=ids[live])
                rep.applied[name] = [0]

    # ------------------------------------------------------------------
    # Shipping pump
    # ------------------------------------------------------------------
    def pump(self, max_batches: Optional[int] = None) -> dict:
        """Ship contiguous log tails to every live lagging replica.

        Deterministic: replicas and collections are visited in a fixed
        order, batches are `ship_batch` entries, and fault verdicts come
        from the injector.  `max_batches` bounds batches per (replica,
        collection) per call — a preemption request (`guard`) overrides it
        and drains everything, the planned-failover path.  Returns
        counters ``{"shipped", "applied_batches", "preempt_drain"}``.
        """
        with self._repl_lock:
            drain = self.guard.should_checkpoint
            if drain:
                max_batches = None
            shipped = 0
            batches = 0
            for name in sorted(self._logs):
                log = self._logs[name]
                last = log.last_seq()
                for rep in self.replicas:
                    if not rep.alive:
                        continue
                    sent = 0
                    while rep.watermark(name) < last and (
                            max_batches is None or sent < max_batches):
                        entries = log.tail(rep.watermark(name),
                                           limit=self.ship_batch)
                        if not entries:
                            break
                        verdict = "ok"
                        if self._injector is not None:
                            verdict = self._injector.on_ship(
                                rep.name, name, entries) or "ok"
                        if verdict in ("drop", "delay"):
                            # the batch never arrives (drop) or arrives
                            # after this pump (delay): either way the
                            # entries stay in the log and re-ship next
                            # pump — lag, never loss
                            self.fault_counts[verdict] += 1
                            break
                        try:
                            n = self._apply(rep, name, entries)
                            if verdict == "duplicate":
                                self.fault_counts["duplicate"] += 1
                                n += self._apply(rep, name, entries)
                        except ReplicaDead:
                            self.fault_counts["kill"] += 1
                            rep.alive = False
                            rep.apply_errors += 1
                            break
                        shipped += n
                        sent += 1
                        batches += 1
            self._trim()
            return {"shipped": shipped, "applied_batches": batches,
                    "preempt_drain": drain}

    def _apply(self, rep: Replica, name: str, entries: List[ShipEntry],
               inject: bool = True) -> int:
        """Apply one shipped batch to `rep`; returns entries applied.
        Idempotent: entries at or below the watermark are skipped, so a
        duplicated batch is a no-op; a gap (possible only if the log
        trimmed past a dead replica's watermark) raises."""
        mark = rep.watermark(name)
        fresh = [e for e in entries if e.seq > mark]
        if not fresh:
            return 0
        if fresh[0].seq != mark + 1:
            raise RuntimeError(
                f"{rep.name}: gap in shipped batch for {name!r} "
                f"(watermark {mark}, first fresh seq {fresh[0].seq})")
        coll = rep.service.collection(name)
        rep.monitor.start()
        try:
            if inject and self._injector is not None:
                on_apply = getattr(self._injector, "on_apply", None)
                if on_apply is not None:
                    for e in fresh:
                        on_apply(rep.name, name, e)
            i = 0
            while i < len(fresh):
                e = fresh[i]
                if e.kind == "build":
                    # a build replaces the whole index; applied alone
                    coll.build(e.rows, ids=e.ids)
                    rep.applied[name] = [e.seq]
                    i += 1
                    continue
                j = i
                while j < len(fresh) and fresh[j].kind != "build":
                    j += 1
                ops = [ivf.DeltaOp(e.kind, e.rows, e.ids)
                       for e in fresh[i:j]]
                coll.apply_delta_batch(ops)
                rep.applied[name] = [fresh[j - 1].seq]
                i = j
        finally:
            rep.monitor.stop()
        return len(fresh)

    def _trim(self) -> int:
        """Drop log entries every live replica has applied (caller holds
        `_repl_lock`).  With no live replica nothing trims — the tail is
        exactly what failover needs to replay."""
        dropped = 0
        live = [r for r in self.replicas if r.alive]
        if not live:
            return 0
        for name, log in self._logs.items():
            dropped += log.trim(min(r.watermark(name) for r in live))
        return dropped

    # ------------------------------------------------------------------
    # Serving API
    # ------------------------------------------------------------------
    def _check_primary(self) -> None:
        if not self.primary_alive:
            raise PrimaryDead("primary is dead; call failover() first")

    def build(self, collection: str, vectors, ids=None) -> dict:
        self._check_primary()
        return self.primary.build(collection, vectors, ids=ids)

    def insert(self, collection: str, vectors, ids=None) -> int:
        self._check_primary()
        return self.primary.insert(collection, vectors, ids=ids)

    def delete(self, collection: str, ids) -> int:
        self._check_primary()
        return self.primary.delete(collection, ids)

    def query(self, collection: str, queries, k=None, nprobe=None,
              path=None, prefer: str = "primary") -> tuple:
        """Serve a query: primary first, shedding to a fresh replica when
        the primary is overloaded (`Overloaded` from admission control) or
        dead; ``prefer="replica"`` routes read traffic straight to the
        freshest replica (read scaling — the bench's replicated lane)."""
        if prefer == "primary" and self.primary_alive:
            try:
                return self.primary.query(collection, queries, k=k,
                                          nprobe=nprobe, path=path)
            except Overloaded:
                with self._repl_lock:
                    self.shed_to_replica += 1
        rep = self._pick_replica(collection)
        with self._repl_lock:
            self.replica_queries += 1
        return rep.service.query(collection, queries, k=k, nprobe=nprobe,
                                 path=path)

    def _pick_replica(self, collection: str) -> Replica:
        """Freshest live replica within `max_lag_ops`; straggler-flagged
        replicas are deprioritized (served only if no clean one qualifies)."""
        with self._repl_lock:
            log = self._logs.get(collection)
            if log is None:
                raise KeyError(f"no replicated collection {collection!r}")
            last = log.last_seq()
            best: Tuple[int, int, Optional[Replica]] = (-1, -1, None)
            for rep in self.replicas:
                if not rep.alive:
                    continue
                mark = rep.watermark(collection)
                if last - mark > self.max_lag_ops:
                    continue
                clean = 0 if rep.monitor.flagged else 1
                if (clean, mark) > best[:2]:
                    best = (clean, mark, rep)
            if best[2] is None:
                raise NoFreshReplica(
                    f"no live replica within {self.max_lag_ops} ops of "
                    f"seq {last} for {collection!r}")
            return best[2]

    def lag(self, collection: Optional[str] = None) -> Dict[str, Dict[str, int]]:
        """Per-replica staleness in ops: shipped seq - applied seq."""
        with self._repl_lock:
            names = [collection] if collection else sorted(self._logs)
            return {name: {rep.name: self._logs[name].last_seq()
                           - rep.watermark(name)
                           for rep in self.replicas if rep.alive}
                    for name in names}

    # ------------------------------------------------------------------
    # Failure + failover
    # ------------------------------------------------------------------
    def kill_primary(self) -> None:
        """Simulate primary process loss: detach the ship hooks (a dead
        process ships nothing) and stop accepting writes.  Acked writes
        are already in the shipping log — that is the guarantee under
        test."""
        with self._repl_lock:
            if not self.primary_alive:
                return
            self.primary_alive = False
            for name in self._logs:
                try:
                    self.primary.collection(name).set_ship_hook(None)
                except KeyError:
                    pass

    def kill_replica(self, name: str) -> None:
        with self._repl_lock:
            for rep in self.replicas:
                if rep.name == name:
                    rep.alive = False
                    return
            raise KeyError(f"no replica {name!r}")

    def failover(self) -> dict:
        """Promote the most-caught-up live replica to primary.

        Replays the shipping-log tail beyond the promoted replica's
        watermark (fault injection does NOT apply — failover is the
        recovery path), re-installs ship hooks on the promoted service so
        its future writes keep feeding the surviving replicas (sequence
        numbers continue — the log object is shared), and records
        `failover_ms`.  After this the ReplicaSet serves writes again with
        one fewer replica.
        """
        t0 = time.perf_counter()
        with self._repl_lock:
            if self.primary_alive:
                raise RuntimeError(
                    "primary is alive; kill_primary() (or a real fault) "
                    "must precede failover()")
            live = [r for r in self.replicas if r.alive]
            if not live:
                raise RuntimeError("no live replica to promote")
            promoted = max(
                live, key=lambda r: (sum(r.watermark(c) for c in self._logs),
                                     r.name))
            replayed = 0
            for name in sorted(self._logs):
                entries = self._logs[name].tail(promoted.watermark(name))
                replayed += self._apply(promoted, name, entries,
                                        inject=False)
            self.primary = promoted.service
            self.primary_alive = True
            self.replicas = [r for r in self.replicas if r is not promoted]
            for name, log in self._logs.items():
                self.primary.collection(name).set_ship_hook(
                    self._make_hook(log))
            out = {"promoted": promoted.name, "replayed": replayed,
                   "failover_ms": 1e3 * (time.perf_counter() - t0)}
            self.failovers.append(out)
            self.guard.reset()
            return out

    def planned_failover(self) -> dict:
        """Drain-then-switch: request preemption, pump everything, kill
        the primary, promote.  A planned failover replays zero entries."""
        self.guard.request()
        self.pump()
        self.kill_primary()
        return self.failover()

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._repl_lock:
            return {
                "primary_alive": self.primary_alive,
                "replicas": {r.name: r.stats() for r in self.replicas},
                "lag": self.lag(),
                "log_retained": {n: log.retained()
                                 for n, log in self._logs.items()},
                "shed_to_replica": self.shed_to_replica,
                "replica_queries": self.replica_queries,
                "fault_counts": dict(self.fault_counts),
                "failovers": list(self.failovers),
            }

    def shutdown(self) -> None:
        with self._repl_lock:
            reps = list(self.replicas)
        for rep in reps:
            rep.service.shutdown()
        self.primary.shutdown()
        self.guard.uninstall()

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
