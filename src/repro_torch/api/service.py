"""MemoryService — the multi-tenant agentic-memory front door; port of
``src/repro/api/service.py``.

Owns named `Collection`s and one `WindowedScheduler`.  Every operation —
build, insert, delete, query, rebuild — lowers to a `MemoryOp`, is routed
through `templates.route` for its execution path / backend class /
priority, and runs on the scheduler; synchronous calls are thin `.result()`
wrappers over the same path.

Maintenance: `MaintenanceController` (started lazily with the first
collection unless `maintenance=False`) polls each collection's host-side
tombstone/spill pressure counters and, past the thresholds in its
`templates.TemplateThresholds`, submits a background-class rebuild through
the scheduler — the delta-replay rebuild in `Collection` makes that safe
under concurrent inserts/deletes.  The same poll submits a recall probe
(the ``probe`` op) for every collection whose tuner cadence is due.

Cross-collection batching: queries submitted with ``batch=True`` park in
a pending window; `flush` groups them by `Collection.batch_signature` and
runs each multi-lane group as one lane-batched dispatch
(`repro_torch.api.batch`), where every scan is one launch of a scan kernel
with a lane axis — mesh-sharded tenants included: same-signature sharded
lanes stack per shard and run as one dispatch
(`distributed.dist_fused_query_stacked`).  `query_many` is the batched
entry point.

Residency: a `ResidencyManager` (`repro_torch.api.residency`) keeps every
collection in one tier — HOT on the device, WARM in host memory, COLD on
disk — under an optional device byte budget with LRU eviction.  A query
against a non-HOT collection promotes it inside its own scheduler task;
the maintenance poll demotes idle tenants.

Persistence: `save`/`load` write and read one namespace directory per
collection under ``collections/`` plus a ``service.json`` registry, in the
reference's layout, each collection in its tier.  Sharded collections
write one ``shard_<i>`` namespace per shard; `load(..., mesh=...)` restores
them (``reshard=True`` onto another mesh shape).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import batch as fuse
from repro_torch.api.collection import Collection, atomic_write_json
from repro_torch.api.ops import MemoryOp, OpFuture
from repro_torch.api.residency import ResidencyManager
from repro_torch.configs.base import EngineConfig
from repro_torch.core import locking
from repro_torch.core import templates
from repro_torch.core.scheduler import AdmissionControl, Overloaded, Task, \
    WindowedScheduler
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels import ops as kernel_ops

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")
SERVICE_FILE = "service.json"


class MaintenanceController:
    """Workload-triggered background maintenance for a `MemoryService`.

    A daemon thread polls every collection's `maintenance_due_shards()`
    (pure host counters — no device sync) and schedules at most one
    in-flight rebuild per (collection, shard) through the service's
    scheduler, on the background backend class the rebuild template routes
    to (on a mesh-sharded collection each due shard gets its own
    shard-local rebuild op), schedules
    at most one in-flight recall probe per collection whose cadence is
    due, and demotes the tenants the residency manager names (idle, or
    over the device budget) as ordinary demote ops.  Queries
    are isolated from the rebuild both by the scheduler (latency workers
    never take index work) and by the collection (delta-replay rebuilds
    never hold the state lock through device compute).
    """

    def __init__(self, service: "MemoryService", *,
                 poll_interval_s: float = 0.05,
                 failure_backoff_s: float = 5.0):
        self._service = service
        self.poll_interval_s = poll_interval_s
        self.failure_backoff_s = failure_backoff_s
        self._stop = threading.Event()
        self._lock = locking.make_lock("_lock")
        # keyed by (collection, slot): the slot of a rebuild is its shard
        # (None for unsharded tenants), a recall probe's "probe", a
        # residency demotion's "demote:<tier>" — each slot has at most one
        # op in flight
        self._inflight: Dict[Tuple[str, object], Optional[OpFuture]] = {}
        # persistent rebuild failures must not re-submit every poll
        self._backoff_until: Dict[Tuple[str, object], float] = {}
        self.triggered = 0
        self.demotions_triggered = 0
        self.probes_triggered = 0
        self.failed = 0
        self.shed = 0
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run,
                                        name="ame-maintenance", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except BaseException as e:   # noqa: BLE001 — keep the loop alive
                with self._lock:
                    self.failed += 1
                    self.last_error = e

    def _try_submit(self, key: Tuple[str, object], op: MemoryOp) -> bool:
        """Reserve slot `key` and submit `op` through the service.

        At most one in-flight op per slot; a finished-with-error slot backs
        off before re-submitting.  Safe to race with other pollers: the
        slot is reserved (value None) under the lock before the submit, so
        a slot never gets two concurrent ops.  Returns True iff submitted.
        """
        with self._lock:
            if key in self._inflight:
                fut = self._inflight[key]
                # None = another poller reserved the slot mid-submit
                if fut is None or not fut.done():
                    return False          # one in-flight op per slot
                self._inflight.pop(key)
                if fut._error is not None:
                    self.failed += 1
                    self.last_error = fut._error
                    self._backoff_until[key] = (
                        time.monotonic() + self.failure_backoff_s)
            if time.monotonic() < self._backoff_until.get(key, 0.0):
                return False              # failing slot: wait out backoff
            self._inflight[key] = None
        try:
            fut = self._service.submit(op)
        except BaseException as e:  # noqa: BLE001 — release the slot
            with self._lock:
                self._inflight.pop(key, None)
                if isinstance(e, Overloaded):
                    # admission control shed this background op — by
                    # design, maintenance yields to serving traffic under
                    # overload.  Not a failure: re-offer after one poll.
                    self.shed += 1
                    self._backoff_until[key] = (
                        time.monotonic() + self.poll_interval_s)
                elif not isinstance(e, KeyError):
                    self.failed += 1
                    self.last_error = e
                    self._backoff_until[key] = (
                        time.monotonic() + self.failure_backoff_s)
            return False
        with self._lock:
            self._inflight[key] = fut
        return True

    def poll_once(self) -> int:
        """One maintenance sweep; returns the number of ops scheduled
        (rebuilds from tombstone/spill pressure, recall probes for
        collections whose tuner cadence is due, plus background residency
        demotions of idle or over-budget tenants).  Also callable
        directly; safe to race with the daemon poll."""
        n = 0
        for name in self._service.list_collections():
            try:
                coll = self._service.collection(name)
            except KeyError:
                continue                  # dropped between list and poll
            for shard in coll.maintenance_due_shards():
                key = (name, shard if coll.sharded else None)
                if self._try_submit(key, MemoryOp("rebuild", name,
                                                  shard=key[1])):
                    with self._lock:
                        self.triggered += 1
                    n += 1
            # recall probe: the tuner's measurement cadence rides the same
            # slot protocol — at most one in-flight probe per collection
            if coll.recall_probe_due():
                if self._try_submit((name, "probe"), MemoryOp("probe", name)):
                    with self._lock:
                        self.probes_triggered += 1
                    n += 1
        # residency sweep: the manager names (collection, target-tier)
        # pairs that should drain off the device tier in the background —
        # HOT tenants idle past idle_demote_s, WARM ones idle past
        # cold_after_s, and LRU tenants while the device tier is over
        # budget.  Each rides the scheduler as an ordinary demote op.
        for name, tier in self._service.residency.demotion_due():
            key = (name, f"demote:{tier}")
            if self._try_submit(key, MemoryOp("demote", name, tier=tier)):
                with self._lock:
                    self.demotions_triggered += 1
                n += 1
        return n

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    @staticmethod
    def _slot_name(key: Tuple[str, object]) -> str:
        name, slot = key
        if slot is None:
            return name
        if isinstance(slot, str):         # "probe" / "demote:<tier>"
            return f"{name}[{slot}]"
        return f"{name}[shard {slot}]"

    def stats(self) -> dict:
        with self._lock:
            return {"triggered": self.triggered, "failed": self.failed,
                    "shed": self.shed,
                    "demotions_triggered": self.demotions_triggered,
                    "probes_triggered": self.probes_triggered,
                    "inflight": sorted(
                        self._slot_name(k) for k, f in self._inflight.items()
                        if f is None or not f.done()),
                    "last_error": repr(self.last_error)
                                  if self.last_error else None}


class MemoryService:
    """Multi-tenant front door over named `Collection`s (see module doc).

    Thread-safety: every public method is safe to call from any thread.
    The registry lock only guards the collection dict; per-collection
    consistency is the collection's own concern (writer lock + snapshot
    reads — see `repro_torch.api.collection`).

    Blocking behavior: `submit()` returns an `OpFuture` immediately (it
    blocks only while the scheduler's submission window is full — the
    paper's windowed batch submission — or while a full batch window
    flushes); the sync conveniences
    (`build`/`insert`/`delete`/`query`/`rebuild`) are `.result()` wrappers
    and block until the op lands.  `shutdown()` blocks until the
    maintenance thread and (owned) scheduler workers exit; the service is
    also a context manager that shuts down on exit.

    Collections live on `device` (the CUDA card unless the caller names
    another; with no card and no device named, construction raises).

    Residency knobs: `device_budget_bytes` caps the HOT tier (None =
    unbounded), `residency_dir` enables the COLD disk tier,
    `idle_demote_s` / `cold_after_s` drive background idle demotion via the
    maintenance poll (see `repro_torch.api.residency`).
    """

    def __init__(self, *, scheduler: Optional[WindowedScheduler] = None,
                 batch_window: int = 8, maintenance: bool = True,
                 maintenance_poll_interval_s: float = 0.05,
                 device_budget_bytes: Optional[int] = None,
                 residency_dir: Optional[str] = None,
                 idle_demote_s: Optional[float] = None,
                 cold_after_s: Optional[float] = None,
                 admission: Optional[AdmissionControl] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._admission = admission
        self._scheduler = scheduler
        self._own_scheduler = scheduler is None
        self._collections: Dict[str, Collection] = {}
        self._lock = locking.make_rlock("_lock")
        self.batch_window = batch_window
        self._pending: List[Tuple[MemoryOp, OpFuture]] = []
        # stacked G-states of fused groups, reused while no lane writes
        self._stack_cache = fuse.StackCache()
        self._residency = ResidencyManager(
            device_budget_bytes=device_budget_bytes,
            spill_dir=residency_dir, idle_demote_s=idle_demote_s,
            cold_after_s=cold_after_s, cache=self._stack_cache)
        self._maintenance_enabled = maintenance
        self._maintenance_poll_interval_s = maintenance_poll_interval_s
        self._maintenance: Optional[MaintenanceController] = None

    @property
    def residency(self) -> ResidencyManager:
        return self._residency

    @property
    def maintenance(self) -> Optional[MaintenanceController]:
        with self._lock:
            return self._maintenance

    def _ensure_maintenance(self) -> None:
        """Started lazily with the first collection: idle services hold
        neither worker threads nor a poll thread."""
        with self._lock:
            if self._maintenance_enabled and self._maintenance is None:
                self._maintenance = MaintenanceController(
                    self, poll_interval_s=self._maintenance_poll_interval_s)

    @property
    def scheduler(self) -> WindowedScheduler:
        """Lazily started so idle services don't hold worker threads."""
        with self._lock:
            if self._scheduler is None:
                self._scheduler = WindowedScheduler(admission=self._admission)
            return self._scheduler

    # ------------------------------------------------------------------
    # Collection registry
    # ------------------------------------------------------------------
    def create_collection(self, name: str, cfg: EngineConfig, *,
                          seed: int = 0, spill_capacity: int = 4096,
                          thresholds=None, mesh=None) -> Collection:
        if not _NAME_RE.match(name) or name in (".", ".."):
            raise ValueError(f"invalid collection name {name!r} "
                             "(allowed: letters, digits, . _ -)")
        with self._lock:
            if name in self._collections:
                raise ValueError(f"collection {name!r} already exists")
            coll = Collection(name, cfg, seed=seed,
                              spill_capacity=spill_capacity,
                              thresholds=thresholds, mesh=mesh,
                              device=self.device)
            self._collections[name] = coll
        self._residency.register(coll)
        self._ensure_maintenance()
        return coll

    def collection(self, name: str) -> Collection:
        with self._lock:
            try:
                return self._collections[name]
            except KeyError:
                raise KeyError(f"no collection {name!r}; have "
                               f"{sorted(self._collections)}") from None

    def drop_collection(self, name: str) -> None:
        with self._lock:
            coll = self._collections.pop(name, None)
        if coll is not None:
            # a cached fused-group stack holds a full copy of the dropped
            # tenant's state — release it now, not at LRU churn
            self._stack_cache.evict(coll)
            self._residency.forget(coll)

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self._collections)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._collections

    # ------------------------------------------------------------------
    # Async op API — everything goes through the scheduler.
    # ------------------------------------------------------------------
    def submit(self, op: MemoryOp) -> OpFuture:
        coll = self.collection(op.collection)     # missing tenant fails fast
        fut = OpFuture(op)
        if op.batch:                      # MemoryOp allows it on queries only
            fut._on_wait = self.flush     # waiting on a parked op flushes
            with self._lock:
                # analyze: ok(LO002) list.append on _pending, not ShippingLog.append
                self._pending.append((op, fut))
                full = len(self._pending) >= self.batch_window
            if full:
                self.flush()
            return fut
        plan = templates.route(op.kind, op.batch_size, coll.cfg,
                               coll.thresholds,
                               concurrent_queries=op.concurrent)

        def fn():
            try:
                out = self._execute(coll, op)
            except BaseException as e:    # noqa: BLE001 — owed to the future
                fut._set_error(e)
                raise
            fut._set_result(out)
            return out

        nbytes = getattr(op.payload, "nbytes", 0)
        task = Task(fn=fn, kind=op.kind, backend=plan.backend,
                    priority=plan.priority, size_bytes=int(nbytes))
        fut.task = self.scheduler.submit(task)
        return fut

    def _execute(self, coll: Collection, op: MemoryOp):
        if op.kind == "build":
            return coll.build(op.payload, ids=op.ids)
        if op.kind == "insert":
            return coll.insert(op.payload, ids=op.ids)
        if op.kind == "delete":
            return coll.delete(op.payload if op.ids is None else op.ids)
        if op.kind == "query":
            # a query against a non-HOT tenant chains promote -> query
            # inside this ONE task (never two chained scheduler tasks —
            # with one worker per backend class that could deadlock);
            # ensure_hot also times the promotion, so cold-hit latency
            # shows in the residency stats apart from hot queries
            self._residency.ensure_hot(coll)
            return coll.query(op.payload, k=op.k, nprobe=op.nprobe,
                              path=op.path)
        if op.kind == "rebuild":
            return coll.rebuild(shard=op.shard)
        if op.kind == "promote":
            self._residency.ensure_hot(coll)
            return coll.residency
        if op.kind == "demote":
            return self._residency.demote(coll, tier=op.tier or "warm")
        if op.kind == "probe":
            # background recall measurement + tuner step; read-only w.r.t.
            # the row store, so it never contends with serving traffic
            return coll.recall_probe()
        raise ValueError(f"unknown op kind {op.kind!r}")

    # ------------------------------------------------------------------
    # Cross-collection batched execution
    # ------------------------------------------------------------------
    def flush(self) -> int:
        """Fuse pending batched queries and dispatch them.

        Drains the pending window (ops submitted with ``batch=True``) and
        groups it by execution signature (`Collection.batch_signature`:
        cfg shapes, store policy, spill capacity, mesh — None for unsharded
        tenants — and the resolved `(k, nprobe, path)` triple).  A mixed
        window therefore splits into independent groups (unsharded, one
        per mesh, singletons), and each multi-op group becomes ONE scheduler
        task running one lane-batched dispatch (`repro_torch.api.batch`).
        A group with a single op has nothing to stack and takes the
        ordinary per-op path.  Returns the number of dispatches submitted
        (fused or singleton), so G same-signature tenants report as 1.

        Who flushes: the window filling to ``batch_window`` ops, a caller
        waiting on a parked future (`OpFuture.wait` calls this method, so a
        parked op never hangs), `query_many`, `shutdown()`, or an explicit
        call.  Safe to race from several threads: the window is snatched
        under the registry lock, so every pending op is dispatched once.

        Residency split: fusion only stacks HOT lanes.  A non-HOT lane's
        state is off the device, and blocking the whole fused dispatch on
        its (possibly disk-reading) promotion would make every hot tenant
        in the group pay the cold tenant's latency, so non-HOT ops dispatch
        as singletons that promote themselves.

        Error propagation: a signature failure (e.g. the collection was
        dropped between park and flush) settles that op's future with the
        error; a failure while submitting or executing a group settles
        every still-pending future in the group.
        """
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0

        groups: Dict[tuple, List[Tuple[MemoryOp, OpFuture]]] = {}
        for op, fut in pending:
            try:
                coll = self.collection(op.collection)
                sig = coll.batch_signature(op.batch_size, op.k, op.nprobe,
                                           op.path)
            except BaseException as e:    # noqa: BLE001 — owed to the future
                fut._set_error(e)
                continue
            groups.setdefault(sig, []).append((op, fut))

        n = 0
        for sig, ops in groups.items():
            cfg, _dtype, _spill, mesh, k, nprobe, path = sig
            hot, demoted = [], []
            for op, fut in ops:
                try:
                    resident = (self.collection(op.collection).residency
                                == "hot")
                except BaseException as e:  # noqa: BLE001 — dropped tenant
                    fut._set_error(e)
                    continue
                (hot if resident else demoted).append((op, fut))
            for op, fut in demoted:
                try:
                    self._submit_single_query(op, fut, k, nprobe, path)
                    n += 1
                except BaseException as e:  # noqa: BLE001
                    if not fut.done():
                        fut._set_error(e)
            if not hot:
                continue
            try:
                if len(hot) == 1:
                    # a lone op has nothing to fuse with: the per-op path
                    op, fut = hot[0]
                    self._submit_single_query(op, fut, k, nprobe, path)
                else:
                    self._submit_fused(hot, cfg, k, nprobe, path, mesh=mesh)
                n += 1
            except BaseException as e:    # noqa: BLE001 — e.g. a concurrent
                for _, fut in hot:        # drop_collection; never strand a
                    if not fut.done():    # future in a dead group
                        fut._set_error(e)
        return n

    def _submit_single_query(self, op: MemoryOp, fut: OpFuture,
                             k: int, nprobe: int, path: str) -> None:
        coll = self.collection(op.collection)

        def fn():
            try:
                # promote-then-query inside ONE task (see _execute): a lane
                # left out of fusion for being non-HOT is admitted here
                self._residency.ensure_hot(coll)
                out = coll.query(op.payload, k=k, nprobe=nprobe, path=path)
            except BaseException as e:    # noqa: BLE001
                fut._set_error(e)
                raise
            fut._set_result(out)
            return out

        plan = templates.route("query", op.batch_size, coll.cfg,
                               coll.thresholds)
        nbytes = getattr(op.payload, "nbytes", 0)
        fut.task = self.scheduler.submit(
            Task(fn=fn, kind="query", backend=plan.backend,
                 priority=plan.priority, size_bytes=int(nbytes)))

    def _submit_fused(self, ops: List[Tuple[MemoryOp, OpFuture]],
                      cfg: EngineConfig, k: int, nprobe: int,
                      path: str, mesh=None) -> None:
        """Submit one same-signature group as ONE fused scheduler task.

        Lane assembly: one lane per distinct collection; several ops
        against the same collection concatenate into its lane and demux by
        row span, so a group degenerates gracefully to G = 1 (one lane,
        one stacked state — still a single dispatch).  `mesh` comes from
        the group's batch signature: None stacks unsharded lanes, a
        `ShardMesh` stacks the lanes' shard-local states per shard.

        The task routes through `templates.route(..., fused_lanes=G)` —
        fused dispatches are throughput-class regardless of per-lane batch.
        A `path="hnsw"` group never reaches the stacked dispatch: a host
        beam search has no product to stack, so the task serves its lanes
        in sequence, each from its own graph.  A lane demoted between flush
        and dispatch is promoted again and the stacked dispatch retried
        (three attempts), then the lanes fall back to per-lane queries,
        which promote themselves.  Error propagation mirrors `flush`: any
        other failure inside the task settles every still-pending future
        in the group before re-raising to the scheduler.
        """
        lanes: Dict[str, dict] = {}
        for op, fut in ops:
            lane = lanes.setdefault(
                op.collection,
                {"coll": self.collection(op.collection), "qs": [],
                 "entries": [], "rows": 0})
            q = as_tensor(op.payload, torch.float32, lane["coll"].device)
            q = q[None] if q.dim() == 1 else q
            lane["entries"].append((fut, lane["rows"], lane["rows"] + len(q)))
            lane["qs"].append(q)
            lane["rows"] += len(q)
        order = sorted(lanes)
        futs = [fut for op, fut in ops]

        def fn():
            try:
                colls = [lanes[nm]["coll"] for nm in order]
                qs = [torch.cat(lanes[nm]["qs"]) for nm in order]
                results = None
                if path == "hnsw":
                    # graph-path lanes share the group (same signature) and
                    # the single scheduler dispatch, but a host-side beam
                    # search has no GEMM to stack — the task serves the
                    # lanes in sequence, each from its own derived graph
                    results = [c.query(q, k=k, path=path)
                               for c, q in zip(colls, qs)]
                    fuse.demux([lanes[nm]["entries"] for nm in order],
                               results)
                    return len(results)
                # a lane can demote between flush and dispatch (background
                # idle demotion / eviction races the scheduler queue):
                # re-promote and retry the stacked dispatch a few times,
                # then fall back to per-lane queries, which promote
                # themselves under the writer lock and cannot lose the race
                for _ in range(3):
                    for c in colls:
                        self._residency.ensure_hot(c)
                    try:
                        results = fuse.execute_group(
                            colls, qs, cfg, k, nprobe, path, mesh=mesh,
                            cache=self._stack_cache)
                        break
                    except fuse.NotResident:
                        continue
                if results is None:
                    results = [c.query(q, k=k, nprobe=nprobe, path=path)
                               for c, q in zip(colls, qs)]
                fuse.demux([lanes[nm]["entries"] for nm in order], results)
            except BaseException as e:    # noqa: BLE001
                for fut in futs:
                    if not fut.done():
                        fut._set_error(e)
                raise
            return len(results)

        total = sum(lanes[nm]["rows"] for nm in order)
        plan = templates.route("query", total, cfg, fused_lanes=len(order))
        nbytes = sum(int(getattr(op.payload, "nbytes", 0)) for op, _ in ops)
        task = Task(fn=fn, kind="query", backend=plan.backend,
                    priority=plan.priority, size_bytes=nbytes)
        self.scheduler.submit(task)
        for fut in futs:
            fut.task = task

    def query_many(self, requests: Iterable[Tuple[str, "np.ndarray"]],
                   k: Optional[int] = None, nprobe: Optional[int] = None,
                   path: Optional[str] = None) -> List[tuple]:
        """Batched entry point: fuse queries across collections.

        requests: iterable of (collection_name, queries).  Returns per-
        request (ids, scores) in request order — identical to calling
        `query()` per request, minus the per-tenant dispatches.
        """
        futs = [self.submit(MemoryOp("query", name, q, k=k, nprobe=nprobe,
                                     path=path, batch=True))
                for name, q in requests]
        self.flush()
        return [f.result() for f in futs]

    # ------------------------------------------------------------------
    # Synchronous conveniences — thin .result() wrappers.
    # ------------------------------------------------------------------
    def build(self, collection: str, vectors, ids=None) -> dict:
        return self.submit(MemoryOp("build", collection, vectors,
                                    ids=ids)).result()

    def insert(self, collection: str, vectors, ids=None,
               concurrent: bool = False) -> int:
        return self.submit(MemoryOp("insert", collection, vectors, ids=ids,
                                    concurrent=concurrent)).result()

    def delete(self, collection: str, ids) -> int:
        """Returns the number of slots actually tombstoned."""
        return self.submit(MemoryOp("delete", collection, ids)).result()

    def query(self, collection: str, queries, k=None, nprobe=None,
              path=None) -> tuple:
        return self.submit(MemoryOp("query", collection, queries, k=k,
                                    nprobe=nprobe, path=path)).result()

    def rebuild(self, collection: str, shard: Optional[int] = None) -> dict:
        """Rebuild a collection (blocks).  `shard` compacts one mesh shard
        of a sharded collection shard-locally; None rebuilds everything."""
        return self.submit(MemoryOp("rebuild", collection,
                                    shard=shard)).result()

    def promote(self, collection: str) -> str:
        """Bring a collection onto the device tier (blocks); returns its
        residency tier afterwards ("hot").  Queries promote on demand —
        this is the explicit warm-up for latency-sensitive tenants."""
        return self.submit(MemoryOp("promote", collection)).result()

    def demote(self, collection: str, tier: str = "warm") -> str:
        """Evict a collection off the device tier (blocks): "warm" parks
        its state in host memory, "cold" leaves only its disk checkpoint
        (requires the service's `residency_dir`).  Returns the resulting
        tier.  The next query transparently promotes it back."""
        return self.submit(MemoryOp("demote", collection,
                                    tier=tier)).result()["tier"]

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            colls = dict(self._collections)
            sched = self._scheduler
            maint = self._maintenance
        return {"collections": {n: c.stats() for n, c in colls.items()},
                "scheduler": sched.stats() if sched is not None else {},
                "maintenance": maint.stats() if maint is not None else {},
                "stack_cache": self._stack_cache.stats(),
                "residency": self._residency.stats()}

    def counters(self) -> Dict[str, float]:
        """Every cumulative counter of the service in one flat dict, for a
        reader that differences two calls across a window:

        * ``sched.<kind>.n`` / ``.wait_s`` / ``.lat_s`` / ``.admit_wait_s``:
          the scheduler's tasks of each op kind (`WindowedScheduler.totals`);
        * ``coll.<name>.<counter>``: each collection's `counters` and
          `writer_counters` (`Collection.host_counters`);
        * ``launches.<kernel>.<variant>`` (``launches.segsum_gemm``): the
          hand-written kernels' launches in this process
          (`kernels.ops.launch_counts`).

        Reads host counters only, with no device sync, so it is safe to
        call at a measurement window's edges."""
        with self._lock:
            colls = dict(self._collections)
            sched = self._scheduler
        out: Dict[str, float] = {}
        if sched is not None:
            for kind, totals in sched.totals().items():
                for key, v in totals.items():
                    out[f"sched.{kind}.{key}"] = v
        for name, coll in colls.items():
            for key, v in coll.host_counters().items():
                out[f"coll.{name}.{key}"] = v
        for key, v in kernel_ops.launch_counts().items():
            out[f"launches.{key}"] = v
        return out

    def shutdown(self) -> None:
        with self._lock:
            maint, self._maintenance = self._maintenance, None
        if maint is not None:
            maint.stop()
        self.flush()
        if self._own_scheduler:
            with self._lock:
                sched, self._scheduler = self._scheduler, None
            if sched is not None:
                sched.shutdown()

    def __enter__(self) -> "MemoryService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # Persistence — per-collection namespaces under one service directory.
    # ------------------------------------------------------------------
    def save(self, directory: str, step: int = 0) -> None:
        """Persist every collection (blocks until all namespaces are
        written).  Sharded collections write one ``shard_<i>`` namespace
        per mesh shard; restore them via `load(..., mesh=...)`."""
        with self._lock:
            colls = dict(self._collections)
        os.makedirs(directory, exist_ok=True)
        registry = {}
        for name, coll in colls.items():
            coll.save_into(os.path.join(directory, "collections", name),
                           step=step)
            registry[name] = {"cfg": dataclasses.asdict(coll.cfg),
                              "sharded": coll.sharded}
        atomic_write_json(os.path.join(directory, SERVICE_FILE),
                          {"version": 1, "collections": registry})

    @classmethod
    def load(cls, directory: str, *,
             scheduler: Optional[WindowedScheduler] = None,
             batch_window: int = 8, step: Optional[int] = None,
             maintenance: bool = True,
             mesh=None, reshard: bool = False,
             device_budget_bytes: Optional[int] = None,
             residency_dir: Optional[str] = None,
             idle_demote_s: Optional[float] = None,
             cold_after_s: Optional[float] = None,
             device: DeviceLike = None) -> "MemoryService":
        """Restore a saved service on `device`.  `mesh` is required when the
        registry holds sharded collections (they restore onto it; pass
        `reshard=True` to accept a mesh shape other than the saved one —
        the rows are re-packed onto it).  A collection saved WARM restores
        host-side, one saved COLD as a pointer to its own
        checkpoint namespace without reading the arrays — the first query
        promotes either back.  The residency knobs configure the restored
        service's manager, which every loaded collection registers with;
        HOT restores count against the budget immediately."""
        with open(os.path.join(directory, SERVICE_FILE)) as f:
            registry = json.load(f)
        svc = cls(scheduler=scheduler, batch_window=batch_window,
                  maintenance=maintenance,
                  device_budget_bytes=device_budget_bytes,
                  residency_dir=residency_dir, idle_demote_s=idle_demote_s,
                  cold_after_s=cold_after_s, device=device)
        for name, entry in registry["collections"].items():
            cfg = EngineConfig(**entry["cfg"])
            kw = {}
            if entry.get("sharded", cfg.shard_db):
                if mesh is None:
                    raise ValueError(
                        f"collection {name!r} in {directory!r} is sharded; "
                        "pass MemoryService.load(..., mesh=<ShardMesh>) to "
                        "restore it")
                kw["mesh"] = mesh
            coll = Collection.load_from(
                os.path.join(directory, "collections", name), name, cfg,
                step=step, reshard=reshard, device=svc.device, **kw)
            with svc._lock:
                svc._collections[name] = coll
            svc._residency.register(coll)
        if registry["collections"]:
            svc._ensure_maintenance()
        return svc
