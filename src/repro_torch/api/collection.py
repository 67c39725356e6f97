"""A named memory collection — one tenant's IVF state, id-space, counters.

Port of ``src/repro/api/collection.py``: one collection with either store
policy (f32, or f32 plus the int8 scan store), its residency tier (HOT on
the device, WARM in host memory, COLD on disk; see
`repro_torch.api.residency`), recall-adaptive routing (the index policy,
the recall probe and its knob tuners, the derived HNSW graph tier),
replication shipping (the ship hook, the bootstrap snapshot and the
replica-side `apply_delta_batch`; see `repro_torch.api.replication`), the
mesh-sharded tier, and save/load in the reference's on-disk layout.

Concurrency model (lost-update-safe writes, wait-free reads), as in the
reference:

* Queries never block on writers.  They read `self._state` — an atomically
  swapped snapshot — under `_lock`, a tiny critical section that only ever
  guards pointer reads/swaps and host counters, never device compute.
* Writers (build / insert / delete / rebuild-swap) serialize on a dedicated
  `_writer_lock`.  Insert/delete compute on copies (`insert_shared` /
  `delete_shared`) while holding *only* the writer lock, wait for the
  device, then swap the fresh state in under `_lock`.
* `rebuild()` is delta-replay based: it snapshots the state, recomputes
  off-lock while concurrent writers append their ops to a bounded delta
  log, then re-acquires the writer lock, replays the log onto the rebuilt
  state (`ivf.replay`, in place: the rebuilt state has no other owner) and
  swaps.  No write that lands during a rebuild is ever lost.  If the log
  overflows, the rebuild restarts from a fresh snapshot; the final attempt
  runs with the writer lock held (writers briefly blocked, queries still
  served).  A bulk `build()` or a demotion bumps `_epoch`, so a rebuild
  racing it detects that its snapshot is obsolete and aborts.
* Every swap bumps `_version`; `version()` lets callers assert freshness.
* Residency transitions (`demote` / `promote`) serialize on the writer
  lock.  A query or write against a non-HOT collection promotes it first;
  `promote` asks the residency manager for room before it takes the
  writer lock (lock order `_admit_lock > _writer_lock > _lock`).

Sharded collections (``shard_db=True`` + a `ShardMesh`) run the same
lifecycle on a tuple of shard-local states (`repro_torch.core.distributed`)
with *per-shard* maintenance state: the delta log, tombstone/spill pressure
counters, spill floor and version counter are tracked per shard, and
`rebuild(shard=i)` compacts shard ``i`` alone — sibling shards' tensors and
versions are untouched.  The unsharded collection is the 1-shard case of
the same bookkeeping.  Sharded collections write one ``shard_<i>``
namespace per shard plus the mesh shape in the metadata; loading checks the
mesh shape and can re-pack the rows onto another mesh (``reshard=True``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.core import distributed as dce
from repro_torch.core import index as ivf
from repro_torch.core import locking
from repro_torch.core import metrics
from repro_torch.core import templates
from repro_torch.core.hnsw import HNSW
from repro_torch.core.spans import span
from repro_torch.core.tuner import RecallTuner
from repro_torch.device import DeviceLike, as_tensor, resolve_device


META_FILE = "collection.json"


def atomic_write_json(path: str, payload: dict) -> None:
    """Crash-safe metadata write: temp file in the same dir + os.replace."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _copy_state(state: ivf.IVFState, device: torch.device, *,
                pin: bool = False) -> ivf.IVFState:
    """A copy of every leaf on `device` (dtype and shape kept, contiguous),
    page-locked when `pin` (host copies of a CUDA state).  The copies run
    on the current stream; a copy to or from the card is synchronised
    before this returns, since an asynchronous copy into page-locked
    memory is garbage until then."""
    out = ivf.IVFState(*[
        None if t is None else torch.empty(
            t.shape, dtype=t.dtype, device=device, pin_memory=pin,
        ).copy_(t, non_blocking=True)
        for t in state])
    for dev in {device, state.device}:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    return out


def _host(x) -> np.ndarray:
    """A tensor (on any device) or host array as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ship_copy(src, t: torch.Tensor, dtype) -> np.ndarray:
    """The ship payload of one written leaf (rows or ids): a private host
    array with the bits the write stored, made by one copy — of the
    caller's host buffer `src` when the write came from the host, else one
    device-to-host copy of `t`, the tensor the write used.  It aliases
    neither the caller's buffer nor the device state."""
    if src is None or (isinstance(src, torch.Tensor)
                       and src.device.type != "cpu"):
        if t.device.type != "cpu":
            return t.cpu().numpy()
        src = t
    return np.array(src, dtype=dtype).reshape(t.shape)


def _host_tensors(arrays):
    """IVFState of numpy arrays (a checkpoint restore) as CPU tensors; a
    sequence of per-shard ones as a tuple of them."""
    if not isinstance(arrays, ivf.IVFState):
        return tuple(_host_tensors(a) for a in arrays)
    return ivf.IVFState(*[None if a is None else torch.from_numpy(a)
                          for a in arrays])


def _shard_dir(directory: str, i: int) -> str:
    """Shard i's checkpoint namespace in a sharded collection's directory."""
    return os.path.join(directory, f"shard_{i:03d}")


def _shards(state) -> tuple:
    """The shard-local states of a state: itself for an unsharded one."""
    return (state,) if isinstance(state, ivf.IVFState) else tuple(state)


def _to_mesh(shards, mesh: dce.ShardMesh) -> tuple:
    """Per-shard states (host tensors) copied onto the mesh's devices, one
    centroids tensor per device."""
    return dce.share_centroids([_copy_state(st, dev)
                                for st, dev in zip(shards, mesh.devices)])


class Collection:
    def __init__(self, name: str, cfg: EngineConfig, *, seed: int = 0,
                 spill_capacity: int = 4096,
                 thresholds: Optional[templates.TemplateThresholds] = None,
                 delta_log_capacity: int = 1024, mesh=None,
                 device: DeviceLike = None, _alloc_state: bool = True):
        if cfg.shard_db and mesh is None:
            raise ValueError(f"collection {name!r}: shard_db=True needs a mesh")
        self.name = name
        self.cfg = cfg
        self.mesh = mesh
        # a sharded collection lives on its mesh; shard 0's device takes
        # the inputs and the merged answers
        self.device = (mesh.devices[0] if cfg.shard_db
                       else resolve_device(device))
        self.seed = seed
        self.spill_capacity = spill_capacity
        self.delta_log_capacity = delta_log_capacity
        self.thresholds = thresholds or templates.TemplateThresholds.from_profile(cfg)
        self._built = False
        # _lock: snapshot swap + counters + id allocator (tiny sections only)
        self._lock = locking.make_rlock("_lock")
        # _writer_lock: serializes mutators; the query path never takes it
        self._writer_lock = locking.make_rlock("_writer_lock")
        self._version = 0          # bumped on every state swap
        self._epoch = 0            # bumped on bulk build (obsoletes snapshots)
        self._next_id = 0
        self._n_draws = 0          # random streams handed out (see _split)
        self._approx_live = 0      # host-side live-row estimate (saved)
        self.counters = {"queries": 0, "inserts": 0, "deletes": 0,
                         "rebuilds": 0, "spilled": 0}
        # the writer lock's cost, host-side and process-local (neither
        # saved nor held to the reference, unlike `counters`): insert calls
        # and their seconds waiting for the lock; the seconds each
        # rebuild's publish step held it (its whole attempt when the
        # attempt runs exclusive), the rows it replayed and its restarts
        self.writer_counters = {"insert_calls": 0, "insert_lock_wait_s": 0.0,
                                "rebuild_lock_hold_s": 0.0,
                                "rebuild_replayed_rows": 0,
                                "rebuild_restarts": 0}
        # Per-shard maintenance state; the unsharded collection is the
        # 1-shard case.  Shard i's entries are only touched by ops that
        # land on shard i, so shard-local rebuilds schedule independently:
        #   _rebuild_locks   at most one delta-replay rebuild per shard
        #   _delta_logs      write log while shard i's rebuild recomputes
        #   _shard_versions  bumped when shard i's state changes
        #   _shard_pressure  host-side tombstone/spill counters since the
        #                    last (re)build of shard i — what the
        #                    MaintenanceController polls (no device sync)
        #   _spill_floors    residual spill the last rebuild of shard i
        #                    could not drain: pressure below the floor is
        #                    irreducible, so maintenance_due ignores it
        n_shards = mesh.size if cfg.shard_db else 1
        self._n_shards = n_shards
        self._rebuild_locks = [locking.make_lock("_rebuild_locks")
                               for _ in range(n_shards)]
        self._delta_logs: List[Optional[List[ivf.DeltaOp]]] = [None] * n_shards
        self._delta_overflow = [False] * n_shards
        self._shard_versions = [0] * n_shards
        self._shard_pressure = [{"tombstones": 0, "spilled": 0}
                                for _ in range(n_shards)]
        self._spill_floors = [0] * n_shards
        # Residency tier (see repro_torch.api.residency): "hot" = device
        # state in _state; "warm" = host copy in _host_state (page-locked
        # when the collection lives on the card; per-shard states when
        # sharded); "cold" = checkpoint under
        # _cold_dir only.  Transitions go through demote()/promote() under
        # the writer lock; _index_nbytes is the exact byte size of the
        # device state (what the budget charges), computed without
        # allocation.
        self._residency_tier = "hot"
        self._host_state = None
        self._cold_dir: Optional[str] = None
        self._cold_step: Optional[int] = None
        self._residency_mgr = None     # back-ref set by ResidencyManager
        self._last_used = time.monotonic()
        self._index_nbytes = ivf.state_nbytes(cfg, spill_capacity, n_shards)
        # Recall-adaptive routing: the HNSW graph is a DERIVED host-side
        # accelerator for the "hnsw" index policy — the IVF row store stays
        # the single source of truth for durability, delta replay,
        # residency and save/load.  The graph is (re)built lazily from the
        # live rows (`_ensure_graph`), mirrored by writers under the writer
        # lock (`_graph_apply`), and invalidated whenever a bulk operation
        # republishes the store wholesale (build / rebuild / demote).
        # `_graph_lock` is a leaf: it only ever wraps graph work.
        self._graph: Optional[HNSW] = None
        self._graph_lock = locking.make_lock("_lock")
        self._probe_ops = 0            # ops since the last recall probe
        self._probe_seq = 0            # deterministic probe RNG stream
        self._last_probe: Optional[dict] = None
        # Replication shipping hook (repro_torch.api.replication): when set,
        # every acked write (build/insert/delete) is reported — host-side
        # rows/ids — from inside the writer critical section, AFTER its
        # state swap, so hook call order == publication order and an op is
        # shipped iff it was acked.  The hook must only descend to
        # _ship_lock (15).
        self._ship_hook = None
        # target_recall > 0 arms the probe + per-path knob tuners; the
        # sharded tier serves exact per-shard scans + the merge (no effort
        # knob), so its probes measure without retuning
        if cfg.target_recall > 0 and not self.sharded:
            self._nprobe_tuner: Optional[RecallTuner] = RecallTuner(
                cfg.target_recall,
                max(1, min(cfg.nprobe, cfg.n_clusters)), 1, cfg.n_clusters)
            ef_lo = max(1, cfg.k)
            ef_hi = max(1024, 8 * max(cfg.hnsw_ef, cfg.k))
            self._ef_tuner: Optional[RecallTuner] = RecallTuner(
                cfg.target_recall,
                min(max(cfg.hnsw_ef, ef_lo), ef_hi), ef_lo, ef_hi)
        else:
            self._nprobe_tuner = None
            self._ef_tuner = None
        # load_from installs the restored state itself: no device allocation
        if not _alloc_state:
            self._state = None
        elif self.sharded:
            self._state = dce.empty_dist_state(cfg, mesh, spill_capacity)
        else:
            self._state = ivf.empty_state(cfg, spill_capacity,
                                          device=self.device)

    @property
    def sharded(self) -> bool:
        return self.cfg.shard_db and self.mesh is not None

    @property
    def n_shards(self) -> int:
        """Mesh size for sharded collections, else 1."""
        return self._n_shards

    @property
    def _spill_floor(self) -> int:
        """Aggregate irreducible spill across shards (see `_spill_floors`)."""
        with self._lock:
            return sum(self._spill_floors)

    # ------------------------------------------------------------------
    # Residency tier (device / host memory / disk — see
    # repro_torch.api.residency)
    # ------------------------------------------------------------------
    @property
    def residency(self) -> str:
        """Current tier: "hot" | "warm" | "cold"."""
        with self._lock:
            return self._residency_tier

    def last_used(self) -> float:
        """monotonic() timestamp of the last query/write — the LRU key."""
        with self._lock:
            return self._last_used

    def index_nbytes(self) -> int:
        """Exact byte size of the device state (static shapes — constant
        for the collection's lifetime; equals
        `ivf.footprint(state)["index_bytes"]`)."""
        return self._index_nbytes

    def _host_view_locked(self):
        """Host representation of the current state; caller holds the
        writer lock.  HOT: a fresh host copy (page-locked from the card);
        WARM: the host copy held; COLD: the checkpoint read back (numpy).
        Sharded: a tuple of the per-shard states."""
        with self._lock:
            tier = self._residency_tier
            state = self._state
            host = self._host_state
        if tier == "hot":
            pin = self.device.type == "cuda"
            copies = tuple(_copy_state(st, torch.device("cpu"), pin=pin)
                           for st in _shards(state))
            return copies if self.sharded else copies[0]
        if tier == "warm":
            return host
        return self._read_cold_host()

    def _read_cold_host(self):
        """Load the COLD checkpoint back into host numpy arrays (no device
        allocation)."""
        if self._cold_dir is None:
            raise RuntimeError(
                f"collection {self.name!r} is cold but has no checkpoint "
                "directory — demote(tier='cold') requires one")
        return self._read_host(self._cold_dir, self._cold_step)

    def _restore(self, directory: str, step: Optional[int],
                 device: DeviceLike = None) -> ivf.IVFState:
        """One checkpoint namespace's state: numpy arrays, or tensors on
        `device`."""
        from repro_torch.checkpoint.checkpointer import Checkpointer
        template = ivf.empty_host_state(self.cfg,
                                        self.spill_capacity)._asdict()
        return ivf.IVFState(**Checkpointer(directory).restore(
            template, step=step, device=device))

    def _read_host(self, directory: str, step: Optional[int],
                   n_shards: Optional[int] = None):
        """The state of checkpoint namespace `directory` as numpy arrays;
        sharded, the list of its `n_shards` (default: this collection's)
        ``shard_<i>`` namespaces."""
        if not self.sharded:
            return self._restore(directory, step)
        return [self._restore(_shard_dir(directory, i), step)
                for i in range(n_shards or self._n_shards)]

    def _write_host_state(self, directory: str, state, step: int) -> None:
        """Write a state (host or device leaves) as checkpoint namespaces
        in the reference's layout, as `save_into` does: one per shard when
        sharded."""
        from repro_torch.checkpoint.checkpointer import Checkpointer
        os.makedirs(directory, exist_ok=True)
        if not self.sharded:
            Checkpointer(directory).save(step, state._asdict())
            return
        for i, local in enumerate(state):
            Checkpointer(_shard_dir(directory, i)).save(step, local._asdict())

    def demote(self, tier: str = "warm", *, directory: Optional[str] = None,
               step: int = 0) -> dict:
        """Release the device state: "warm" keeps a host copy, "cold"
        writes a disk checkpoint (`directory`, or the collection's existing
        cold namespace) and keeps nothing in memory.

        Serializes through the writer lock, so it can never tear an
        in-flight write; bumps `_epoch` so an in-flight delta-replay
        rebuild aborts instead of resurrecting the demoted state at its
        swap.  Queries racing the demotion either grabbed the old snapshot
        (still valid — the tensors outlive the swap) or re-promote on their
        next snapshot read.  Demoting an already-colder collection is a
        no-op ("cold" → demote("warm") does NOT load anything back).
        """
        if tier not in ("warm", "cold"):
            raise ValueError(f"demote tier must be 'warm' or 'cold', "
                             f"got {tier!r}")
        t0 = time.perf_counter()
        with self._writer_lock:
            with self._lock:
                cur = self._residency_tier
            if cur == tier or cur == "cold":
                return {"tier": cur, "demoted": False}
            host = self._host_view_locked()
            if tier == "cold":
                directory = directory or self._cold_dir
                if directory is None:
                    raise ValueError(
                        f"collection {self.name!r}: demote to cold needs a "
                        "checkpoint directory (configure the service's "
                        "residency_dir)")
                self._write_host_state(directory, host, step)
                host = None
            with self._lock:
                self._residency_tier = tier
                self._host_state = host
                if tier == "cold":
                    self._cold_dir = directory
                    self._cold_step = step
                self._state = None
                self._version += 1
                self._epoch += 1    # obsoletes in-flight rebuild snapshots
                for s in range(self._n_shards):
                    self._shard_versions[s] += 1
            # the derived graph only serves the HOT tier; free it with the
            # device state (promote + next graph query rebuild it)
            self._graph_invalidate()
        out = {"tier": tier, "demoted": True,
               "demote_s": time.perf_counter() - t0}
        mgr = self._residency_mgr
        if mgr is not None:
            mgr._record_demotion(tier, out["demote_s"])
        return out

    def promote(self) -> dict:
        """Bring a WARM/COLD collection back to the device tier (HOT).

        Asks the residency manager (when attached) to make room FIRST —
        with no collection locks held, so the admission path's victim
        demotions can never deadlock against us — then copies the state to
        the device under the writer lock and publishes it once the copy
        has synchronised.  No-op on a HOT collection.
        """
        with self._lock:
            if self._residency_tier == "hot":
                return {"tier": "hot", "promoted": False}
        mgr = self._residency_mgr
        if mgr is not None:
            mgr.make_room_for(self)
        t0 = time.perf_counter()
        try:
            with self._writer_lock:
                with self._lock:
                    tier = self._residency_tier
                    host = self._host_state
                if tier == "hot":     # raced another promoter — done
                    return {"tier": "hot", "promoted": False}
                if tier == "cold":
                    host = _host_tensors(self._read_cold_host())
                if self.sharded:
                    state = _to_mesh(host, self.mesh)
                else:
                    state = _copy_state(host, self.device)
                with self._lock:
                    self._state = state
                    self._residency_tier = "hot"
                    self._host_state = None
                    self._last_used = time.monotonic()
                    self._version += 1
                    for s in range(self._n_shards):
                        self._shard_versions[s] += 1
        finally:
            if mgr is not None:
                mgr.finish_admit(self)
        out = {"tier": "hot", "promoted": True,
               "promote_s": time.perf_counter() - t0}
        if mgr is not None:
            mgr._record_promotion(out["promote_s"])
        return out

    def _acquire_writer_hot(self) -> None:
        """Acquire the writer lock with the collection HOT.

        Promote happens BEFORE the lock acquisition (admission takes victim
        writer locks — taking ours first would invert the lock order); if a
        concurrent eviction demoted us between the promote and the acquire,
        release and retry.  Terminates because evictions only happen on
        other tenants' admissions, which are finite between our retries.
        """
        with span("ame.coll.writer_lock"):
            while True:
                self.promote()
                self._writer_lock.acquire()
                with self._lock:
                    if self._residency_tier == "hot":
                        return
                self._writer_lock.release()

    @contextlib.contextmanager
    def _hot_writer(self):
        self._acquire_writer_hot()
        try:
            yield
        finally:
            self._writer_lock.release()

    def _query_state(self) -> ivf.IVFState:
        """Snapshot for the query path: wait-free on a HOT collection,
        promotes first otherwise (the cold-hit path).  Under adversarial
        eviction thrash, falls back to pinning hotness with the writer
        lock for the pointer read — bounded, and only ever on a collection
        that was demoted several times mid-query."""
        for _ in range(4):
            with self._lock:
                if self._residency_tier == "hot":
                    self._last_used = time.monotonic()
                    return self._state
            self.promote()
        with self._hot_writer():
            with self._lock:
                self._last_used = time.monotonic()
                return self._state

    # ------------------------------------------------------------------
    # Replication shipping (repro_torch.api.replication)
    # ------------------------------------------------------------------
    def set_ship_hook(self, hook) -> None:
        """Install/remove (`None`) the replication shipping hook.

        `hook(kind, rows, ids)` is called with host numpy arrays (rows
        f32[B, D] or None, ids i32[B]) from inside the writer critical
        section after each acked write's state swap; it must be fast and
        may only take locks below the writer level (the shipping log's
        `_ship_lock`, 15).  Prefer `attach_shipper` when a consistent
        bootstrap snapshot is needed.  A mesh-sharded collection does not
        ship (ValueError), as `attach_shipper` refuses it in the reference.
        """
        if self.sharded and hook is not None:
            raise ValueError(
                f"collection {self.name!r} is mesh-sharded; replication "
                "shipping supports unsharded collections only")
        with self._lock:
            self._ship_hook = hook

    def attach_shipper(self, hook) -> dict:
        """Install `hook` and return a consistent bootstrap snapshot.

        Runs under the writer lock, so no write can land between the
        snapshot read and the hook install: every write is either in the
        returned snapshot or will be reported through the hook.  Returns
        ``{"built", "rows", "ids", "key", "next_id"}``; rows/ids are the
        flat host slot arrays (ids < 0 = dead slots) when built, else None.
        ``"key"`` is what `_split` continues the random stream from — the
        reference's PRNG key: ``{"seed", "n_draws"}``.  Sharded collections
        don't ship (the per-shard delta log stays on the mesh); ValueError.
        """
        if self.sharded:
            raise ValueError(
                f"collection {self.name!r} is mesh-sharded; replication "
                "shipping supports unsharded collections only")
        with self._hot_writer():
            with self._lock:
                self._ship_hook = hook
                built = self._built
                state = self._state
                key = {"seed": self.seed, "n_draws": self._n_draws}
                next_id = self._next_id
            rows = ids = None
            if built:
                rows, ids = ivf.flat_rows_host(state)
        return {"built": built, "rows": rows, "ids": ids, "key": key,
                "next_id": next_id}

    def _ship(self, kind: str, rows, ids, src_rows=None, src_ids=None) -> None:
        """Report one acked write to the shipping hook (no-op when unset).
        Caller holds `_writer_lock`; `rows`/`ids` are the tensors the write
        used, `src_rows`/`src_ids` what the caller passed (see
        `_ship_copy`)."""
        with self._lock:
            hook = self._ship_hook
        if hook is None:
            return
        hook(kind,
             None if rows is None else _ship_copy(src_rows, rows, np.float32),
             _ship_copy(src_ids, ids, np.int32))

    def apply_delta_batch(self, ops: Sequence[ivf.DeltaOp]) -> dict:
        """Apply a shipped delta batch in order with ONE state swap.

        The replica-side apply path: the first op runs through the copying
        kernel (`insert_shared` / `delete_shared`) — concurrent readers may
        hold the published snapshot — which yields a sole-owned
        intermediate state; the remaining ops replay onto it in place
        (`ivf.replay`), and the result publishes atomically after one wait
        for the device.  A crash mid-batch leaves the published state
        intact: batches are all-or-nothing, which is what lets the
        replication watermark advance only on entry boundaries.  Every op
        is logged for an in-flight rebuild and mirrored into the derived
        graph.  Never calls the shipping hook — applying shipped writes on
        a replica must not re-ship them.

        Returns ``{"applied", "inserted", "spilled", "tombstoned"}``.
        """
        if self.sharded:
            raise ValueError(
                f"collection {self.name!r} is mesh-sharded; apply_delta_batch "
                "supports unsharded replicas only")
        if not ops:
            return {"applied": 0, "inserted": 0, "spilled": 0,
                    "tombstoned": 0}
        if not self._built:
            raise RuntimeError(f"build() collection {self.name!r} before "
                               "applying deltas")
        for op in ops:
            if op.kind not in ("insert", "delete"):
                raise ValueError(f"unknown delta op kind {op.kind!r}")
        # the shipped ids are host arrays: count them before the upload
        ins_ids = [np.atleast_1d(_host(op.ids)) for op in ops
                   if op.kind == "insert"]
        max_id = max((int(i.max()) for i in ins_ids if i.size), default=-1)
        inserted = sum(i.size for i in ins_ids)
        ops = [ivf.DeltaOp(
            op.kind, None if op.rows is None else self._rows(op.rows),
            as_tensor(op.ids, torch.int32, self.device).reshape(-1))
            for op in ops]
        with self._hot_writer():
            first, rest = ops[0], ops[1:]
            if first.kind == "insert":
                state, sp0 = ivf.insert_shared(self._state, first.rows,
                                               first.ids, self.cfg)
                tomb0 = torch.zeros_like(sp0)
            else:
                state, tomb0 = ivf.delete_shared(self._state, first.ids)
                sp0 = torch.zeros_like(tomb0)
                if any(op.kind == "insert" for op in rest):
                    # the in-place inserts below write fields the copying
                    # delete still shares with the published snapshot
                    state = ivf.own_insert_fields(state, self.cfg)
            spilled = tombstoned = 0
            if rest:
                state, spilled, tombstoned = ivf.replay(state, rest, self.cfg)
            sp0, tomb0 = torch.stack([sp0, tomb0]).tolist()
            spilled += sp0
            tombstoned += tomb0
            with self._lock:
                self._shard_pressure[0]["spilled"] += spilled
                self._shard_pressure[0]["tombstones"] += tombstoned
                self._approx_live = max(
                    0, self._approx_live + inserted - tombstoned)
                self._next_id = max(self._next_id, max_id + 1)
            self._swap(state, inserts=inserted, deletes=tombstoned,
                       spilled=spilled)
            for op in ops:
                self._log_delta(op.kind, op.rows, op.ids)
                self._graph_apply(op.kind, op.rows, op.ids)
        return {"applied": len(ops), "inserted": inserted,
                "spilled": spilled, "tombstoned": tombstoned}

    # ------------------------------------------------------------------
    # Persistence — one namespace directory per collection, in the
    # reference's layout (a Checkpointer step dir + `collection.json`), so
    # either package loads the other's snapshots.
    # ------------------------------------------------------------------
    def save_into(self, directory: str, step: int = 0) -> None:
        """Write this collection's namespace directory.  Reads a consistent
        snapshot under the writer lock; safe to call under live traffic.

        Unsharded: one Checkpointer step dir + `collection.json`.  Sharded:
        one ``shard_<i>/`` namespace per shard plus the mesh axis names and
        shape in the metadata, so `load_from` can check — or reshard — the
        layout.  The metadata records the residency tier, and a WARM/COLD
        collection saves from its host copy / cold checkpoint without
        touching the device."""
        os.makedirs(directory, exist_ok=True)
        with self._writer_lock:
            with self._lock:
                tier = self._residency_tier
                state = self._state
                # the keys and values of the reference's collection
                meta = {"name": self.name, "next_id": self._next_id,
                        "counters": dict(self.counters),
                        "built": self._built,
                        "spill_capacity": self.spill_capacity, "step": step,
                        "spill_floors": list(self._spill_floors),
                        "store_dtype": self.cfg.store_dtype,
                        "residency": tier,
                        "pressure": [dict(p) for p in self._shard_pressure],
                        "approx_live": self._approx_live,
                        "probe_seq": self._probe_seq}
            # tuner state round-trips so a restored collection keeps its
            # learned effort knobs instead of re-seeking from the defaults
            if self._nprobe_tuner is not None:
                meta["tuners"] = {"nprobe": self._nprobe_tuner.to_dict(),
                                  "ef": self._ef_tuner.to_dict()}
            if self.sharded:
                meta["sharded"] = True
                meta["mesh_axes"] = list(self.mesh.axis_names)
                meta["mesh_shape"] = list(self.mesh.shape)
            # a HOT state goes to disk leaf by leaf from the device
            tree = state if tier == "hot" else self._host_view_locked()
            self._write_host_state(directory, tree, step)
        atomic_write_json(os.path.join(directory, META_FILE), meta)

    @classmethod
    def load_from(cls, directory: str, name: str, cfg: EngineConfig, *,
                  step: Optional[int] = None, reshard: bool = False,
                  **kw) -> "Collection":
        """Restore a collection from its namespace directory in the tier it
        was saved in: HOT onto the device, WARM into host memory, COLD as a
        pointer to the namespace (no array read until the first query
        promotes it).  The snapshot's `store_dtype` wins over `cfg`'s: the
        checkpoint carries (or lacks) the int8 store's leaves.

        Sharded snapshots need ``cfg.shard_db=True`` and a ``mesh=``.  A
        mesh shape other than the saved one fails unless ``reshard=True``,
        which re-packs the saved rows onto the new mesh against the saved
        centroids (`distributed.reshard_host`) and loads HOT."""
        mpath = os.path.join(directory, META_FILE)
        meta = {}
        if os.path.exists(mpath):
            with open(mpath) as f:
                meta = json.load(f)
        residency = meta.get("residency", "hot")
        spill_capacity = int(meta.get("spill_capacity", 4096))
        saved_dtype = meta.get("store_dtype")
        if saved_dtype is not None and saved_dtype != cfg.store_dtype:
            cfg = dataclasses.replace(cfg, store_dtype=saved_dtype)
        coll = cls(name, cfg, spill_capacity=spill_capacity,
                   _alloc_state=False, **kw)
        if bool(meta.get("sharded", False)) != coll.sharded:
            saved = "sharded" if meta.get("sharded") else "unsharded"
            raise ValueError(
                f"collection {name!r} was saved {saved} (mesh "
                f"{meta.get('mesh_shape')}); load it with a matching "
                "EngineConfig.shard_db and, when sharded, a mesh= kwarg")
        n_saved, resharded = coll._n_shards, False
        if coll.sharded:
            saved_shape = [int(v) for v in meta["mesh_shape"]]
            cur_shape = list(coll.mesh.shape)
            n_saved = int(np.prod(saved_shape))
            if cur_shape != saved_shape and not reshard:
                raise ValueError(
                    f"collection {name!r} was saved on mesh "
                    f"{dict(zip(meta['mesh_axes'], saved_shape))} but is "
                    f"being loaded on mesh shape {cur_shape}; pass "
                    "reshard=True to re-pack the rows onto the new mesh")
            if cur_shape != saved_shape:
                # the re-packed state exists only on the device: HOT
                resharded, residency = True, "hot"
        state = None
        if residency == "cold":
            with coll._lock:
                coll._cold_dir = directory
                coll._cold_step = step
                coll._residency_tier = "cold"
        elif resharded:
            state = dce.reshard_host(coll._read_host(directory, step, n_saved),
                                     cfg, coll.mesh, spill_capacity)
        elif residency == "warm":
            state = _host_tensors(coll._read_host(directory, step))
            if coll.device.type == "cuda":
                state = tuple(_copy_state(st, st.device, pin=True)
                              for st in _shards(state))
                state = state if coll.sharded else state[0]
            with coll._lock:
                coll._host_state = state
                coll._residency_tier = "warm"
        elif coll.sharded:
            state = dce.share_centroids([
                coll._restore(_shard_dir(directory, i), step, dev)
                for i, dev in enumerate(coll.mesh.devices)])
        else:
            state = coll._restore(directory, step, coll.device)
        if residency == "hot":
            with coll._lock:
                coll._state = state
        n = coll._n_shards
        floors = ([0] * n if resharded
                  else meta.get("spill_floors")
                  or [int(meta.get("spill_floor", 0))])
        press = None if resharded else meta.get("pressure")
        if press is not None:
            press = [{"tombstones": int(p.get("tombstones", 0)),
                      "spilled": int(p.get("spilled", 0))} for p in press]
        elif state is not None:
            # snapshots without host counters were always saved HOT; a
            # resharded state starts from its own counters
            press = [{"tombstones": int(t.num_deleted),
                      "spilled": int(t.spill_size)} for t in _shards(state)]
        else:
            press = []
        press = press[:n] + [{"tombstones": 0, "spilled": 0}
                             for _ in range(n - len(press[:n]))]
        floors = [int(f) for f in floors][:n]
        floors += [0] * (n - len(floors))
        with coll._lock:
            coll._built = bool(meta.get("built", True))
            coll._next_id = int(meta.get("next_id", 0))
            coll.counters.update(meta.get("counters", {}))
            coll._approx_live = int(meta.get("approx_live", 0))
            coll._shard_pressure = press
            coll._spill_floors = floors
            coll._probe_seq = int(meta.get("probe_seq", 0))
        # restore learned tuner knobs under the CALLER's target_recall (the
        # cfg wins over the snapshot's target, but the knob/floor survive)
        tuners = meta.get("tuners")
        if tuners is not None and coll._nprobe_tuner is not None:
            for attr, key in (("_nprobe_tuner", "nprobe"),
                              ("_ef_tuner", "ef")):
                d = dict(tuners[key])
                d["target"] = cfg.target_recall
                setattr(coll, attr, RecallTuner.from_dict(d))
        return coll

    # ------------------------------------------------------------------
    # Versioned state snapshot
    # ------------------------------------------------------------------
    def snapshot(self) -> ivf.IVFState:
        """Wait-free versioned read of the current state pointer (None while
        the collection is not HOT).  A writer or rebuild swaps the pointer
        rather than mutating a published state, so a snapshot stays
        internally consistent while it is read."""
        with self._lock:
            return self._state

    def version(self) -> int:
        with self._lock:
            return self._version

    def versioned_snapshot(self) -> Tuple[ivf.IVFState, int]:
        """(state, version) read atomically under the pointer lock.

        The fusion layer's stack cache (`repro_torch.api.batch.StackCache`)
        tags a stacked G-state with the exact versions of the snapshots it
        was built from; reading both under one lock acquisition means a
        cache key can never pair a fresh version with a stale state.
        """
        with self._lock:
            return self._state, self._version

    def shard_versions(self) -> List[int]:
        """Per-shard version counters (length `n_shards`).  A shard-local
        rebuild bumps only its own shard's entry; writes that touch every
        shard (build / insert / delete) bump all of them."""
        with self._lock:
            return list(self._shard_versions)

    def _swap(self, state, shards: Optional[Tuple[int, ...]] = None,
              **counter_deltas) -> int:
        """Atomically publish a new state (the collection is HOT after it);
        returns the new version.  `shards` limits which per-shard version
        counters bump (None = all)."""
        with self._lock:
            self._state = state
            self._residency_tier = "hot"
            self._host_state = None
            self._last_used = time.monotonic()
            self._version += 1
            for s in (range(self._n_shards) if shards is None else shards):
                self._shard_versions[s] += 1
            for key, d in counter_deltas.items():
                self.counters[key] += d
                self._probe_ops += d    # recall-probe cadence counter
            return self._version

    # ------------------------------------------------------------------
    def _split(self) -> torch.Generator:
        """A fresh random stream for one build/rebuild (the reference
        splits its PRNG key here): seeded from (seed, draw number)."""
        with self._lock:
            n = self._n_draws
            self._n_draws += 1
        seed = int(np.random.SeedSequence([self.seed, n]).generate_state(
            1, np.uint64)[0] >> 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _ids_for(self, n: int, ids) -> torch.Tensor:
        if ids is not None:
            ids = as_tensor(ids, torch.int32, self.device).reshape(-1)
            if ids.shape[0] != n:
                raise ValueError(f"{ids.shape[0]} ids for {n} rows")
            top = int(ids.max()) + 1 if n else 0
        with self._lock:
            if ids is None:
                ids = torch.arange(self._next_id, self._next_id + n,
                                   dtype=torch.int32, device=self.device)
                self._next_id += n
            else:
                self._next_id = max(self._next_id, top)
        return ids

    def _rows(self, vectors) -> torch.Tensor:
        x = as_tensor(vectors, torch.float32, self.device)
        if x.dim() != 2 or x.shape[1] != self.cfg.dim:
            raise ValueError(f"collection {self.name!r} takes rows of "
                             f"dim {self.cfg.dim}, got {tuple(x.shape)}")
        return x

    def _bump(self, **deltas) -> None:
        with self._lock:
            for key, d in deltas.items():
                self.counters[key] += d
                self._probe_ops += d    # recall-probe cadence counter

    def _log_delta(self, kind: str, rows, ids) -> None:
        """Record a write for every shard with an in-flight rebuild.  Caller
        holds `_writer_lock`, so log order == state application order.

        Inserts are logged as the *shard-local* row block (`dist_insert`
        routes shard s rows [s*B/S, (s+1)*B/S)), so a replay onto a rebuilt
        shard re-applies exactly the rows that landed there.  Deletes are
        logged whole.  The slicing runs outside `_lock`: the writer lock
        (held by our caller) is what installs and retires the logs."""
        with self._lock:
            active = [s for s, log in enumerate(self._delta_logs)
                      if log is not None]
        if not active:
            return
        entries = {}
        for s in active:
            if kind == "insert" and self._n_shards > 1:
                b = rows.shape[0] // self._n_shards
                entries[s] = ivf.DeltaOp("insert", rows[s * b:(s + 1) * b],
                                         ids[s * b:(s + 1) * b])
            else:
                entries[s] = ivf.DeltaOp(kind, rows, ids)
        with self._lock:
            for s, op in entries.items():
                log = self._delta_logs[s]
                if log is None:
                    continue
                if len(log) >= self.delta_log_capacity:
                    self._delta_overflow[s] = True
                else:
                    log.append(op)

    # ------------------------------------------------------------------
    # Raw ops (paper templates); the service routes these via the scheduler.
    # ------------------------------------------------------------------
    def _check_shardable(self, kind: str, n: int) -> None:
        """Sharded build/insert route rows block-wise over the mesh, which
        needs the batch to divide evenly."""
        if self.sharded and n % self._n_shards:
            raise ValueError(
                f"collection {self.name!r}: {kind} batch of {n} rows does "
                f"not divide over the {self._n_shards}-shard mesh; pad the "
                f"batch to a multiple of {self._n_shards}")

    def build(self, vectors, ids=None) -> dict:
        """Bulk build (paper 'index template').  Blocks until the index is
        live (device compute synced before return).  Runs under the writer
        lock; queries keep reading the old snapshot throughout."""
        x = self._rows(vectors)
        self._check_shardable("build", int(x.shape[0]))
        src = (vectors, ids)
        ids = self._ids_for(x.shape[0], ids)
        t0 = time.perf_counter()
        # a build replaces the whole state from scratch — no need to promote
        # a demoted one first, but the fresh device state must be admitted
        # against the residency budget (same shapes, same byte charge)
        mgr = self._residency_mgr
        if mgr is not None:
            mgr.make_room_for(self)
        try:
            return self._build_admitted(x, ids, t0, src)
        finally:
            if mgr is not None:
                mgr.finish_admit(self)

    def _build_admitted(self, x, ids, t0, src=(None, None)) -> dict:
        with self._writer_lock:
            if self.sharded:
                state, spilled = dce.dist_build(
                    self._split(), x, ids, self.cfg, self.mesh,
                    spill_capacity_per_shard=self.spill_capacity)
            else:
                # analyze: ok(LO002) ivf.build is the index module (takes no locks), not Collection.build
                state, spilled = ivf.build(self._split(), x, ids, self.cfg,
                                           spill_capacity=self.spill_capacity)
            # sync: compute done before publish
            per_shard = [int(v) for v in spilled.reshape(-1).tolist()]
            spilled = sum(per_shard)
            with self._lock:
                self._built = True
                self._epoch += 1        # obsoletes in-flight rebuild snapshots
                self._shard_pressure = [{"tombstones": 0, "spilled": sp}
                                        for sp in per_shard]
                self._spill_floors = list(per_shard)
                self._approx_live = int(x.shape[0])
                # a fresh index deserves a prompt recall measurement
                self._probe_ops = self.thresholds.probe_interval_ops
            self._swap(state, rebuilds=1, spilled=spilled)
            self._graph_invalidate()   # derived graph lazily rebuilds
            self._ship("build", x, ids, *src)
        return {"build_s": time.perf_counter() - t0, "spilled": spilled}

    def insert(self, vectors, ids=None) -> int:
        """Insert rows (paper 'update template').  Returns #spilled.
        Blocks until the rows are queryable (compute synced, then swapped).

        Device compute runs under the writer lock only — concurrent queries
        keep reading the previous snapshot.  Uses the copying
        `insert_shared`, never the in-place `insert`: queries on other
        threads may still hold the current snapshot.
        """
        if not self._built:
            raise RuntimeError(f"build() collection {self.name!r} before "
                               "inserting")
        x = self._rows(vectors)
        n = int(x.shape[0])
        self._check_shardable("insert", n)
        src = (vectors, ids)
        ids = self._ids_for(n, ids)
        t_wait = time.perf_counter()
        with self._hot_writer():
            t_wait = time.perf_counter() - t_wait
            if self.sharded:
                state, spilled = dce.dist_insert(self._state, x, ids,
                                                 self.cfg, self.mesh)
            else:
                state, spilled = ivf.insert_shared(self._state, x, ids,
                                                   self.cfg)
            # sync: compute done before publish
            per_shard = [int(v) for v in spilled.reshape(-1).tolist()]
            spilled = sum(per_shard)
            with self._lock:
                for s, sp in enumerate(per_shard):
                    self._shard_pressure[s]["spilled"] += sp
                self._approx_live += n
                self.writer_counters["insert_calls"] += 1
                self.writer_counters["insert_lock_wait_s"] += t_wait
            self._swap(state, inserts=n, spilled=spilled)
            self._log_delta("insert", x, ids)
            # mirror into the derived HNSW graph (no-op until one exists);
            # still under the writer lock, so graph order == state order
            self._graph_apply("insert", x, ids)
            self._ship("insert", x, ids, *src)
        return spilled

    def delete(self, ids) -> int:
        """Tombstone `ids`; returns the number of slots actually tombstoned
        (ids not present contribute nothing).  Blocks until the tombstones
        are visible to new queries."""
        src, ids = ids, as_tensor(ids, torch.int32, self.device).reshape(-1)
        with self._hot_writer():
            if self.sharded:
                # shard-local tombstoning; per-shard hits feed per-shard
                # maintenance pressure
                state, hits = dce.dist_delete(self._state, ids, self.mesh)
            else:
                state, hits = ivf.delete_shared(self._state, ids)
            # sync: compute done before publish
            per_shard = [int(v) for v in hits.reshape(-1).tolist()]
            n_hit = sum(per_shard)
            with self._lock:
                for s, n in enumerate(per_shard):
                    self._shard_pressure[s]["tombstones"] += n
                self._approx_live = max(0, self._approx_live - n_hit)
            self._swap(state, deletes=n_hit)
            self._log_delta("delete", None, ids)
            # graph delete is idempotent per id — absent ids are a no-op,
            # matching the state's "ids not present contribute nothing"
            self._graph_apply("delete", None, ids)
            self._ship("delete", None, ids, None, src)
        return n_hit

    def query(self, queries, k: Optional[int] = None,
              nprobe: Optional[int] = None,
              path: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns host (ids i32[B, k], scores f32[B, k]).  Template-routed;
        `path` ("probed" | "full_scan" | "hnsw") overrides the router; the
        graph path answers from the host-side HNSW graph (ids i64).  Wait-free
        w.r.t. writers on a HOT collection: reads the current snapshot
        under the pointer lock and never takes the writer lock.  On a
        WARM/COLD collection this is the cold-hit path: the state is
        promoted back to the device first, then the query runs as usual."""
        q = as_tensor(queries, torch.float32, self.device)
        if q.dim() == 1:
            q = q[None]
        k, nprobe, path = self.resolve_query(q.shape[0], k, nprobe, path)
        state = self._query_state()
        self._bump(queries=int(q.shape[0]))
        if self.sharded:
            # the sharded tier always full-scans each shard + the merge
            ids, scores = dce.dist_query(state, q, self.cfg, self.mesh, k)
        elif path == "full_scan":
            ids, scores = ivf.query_full_scan(state, q, self.cfg, k)
        elif path == "probed":
            ids, scores = ivf.query_probed(state, q, self.cfg, k, nprobe)
        elif path == "hnsw":
            # derived-graph path: host-side serial beam search at the
            # tuner-owned ef (the paper's pointer-chasing baseline, live)
            return self._query_graph(q.cpu().numpy(), k)
        else:
            raise ValueError(f"unknown query path {path!r}")
        with span("ame.coll.query.to_host"):
            return ids.cpu().numpy(), scores.cpu().numpy()

    def rebuild(self, shard: Optional[int] = None, *,
                max_restarts: int = 2) -> dict:
        """Reclaim tombstones + drain spill (paper 'index template') without
        losing concurrent writes.  Blocks until the rebuilt state is live.

        Snapshot -> recompute off-lock (writers log their ops to the bounded
        delta log) -> reacquire the writer lock -> replay the delta onto the
        rebuilt state -> swap.  On delta-log overflow the rebuild restarts
        from a fresh snapshot; the final attempt holds the writer lock for
        the whole recompute.  If a bulk `build()` lands mid-rebuild the
        snapshot is obsolete and the rebuild aborts.

        On a sharded collection `shard` selects ONE shard to compact
        shard-locally (reassign its live rows against the replicated
        centroids, repack, drain its spill); sibling shards' states and
        versions are untouched.  `shard=None` sweeps every shard in turn.
        On an unsharded collection `shard` must be None or 0 and the
        rebuild is the full re-cluster (`ivf.rebuild`).
        """
        if not self.sharded:
            if shard not in (None, 0):
                raise ValueError(
                    f"collection {self.name!r} is unsharded; rebuild(shard="
                    f"{shard}) is only meaningful with shard_db=True")
            return self._rebuild_counted(self._rebuild_single(max_restarts))
        if shard is None:
            out = {"rebuild_s": 0.0, "spilled": 0, "replayed": 0,
                   "restarts": 0, "aborted": False, "shards": []}
            for s in range(self._n_shards):
                r = self._rebuild_counted(self._rebuild_shard(s, max_restarts))
                for key in ("rebuild_s", "spilled", "replayed", "restarts"):
                    out[key] += r[key]
                out["aborted"] = out["aborted"] or r["aborted"]
                out["shards"].append(s)
            return out
        if not 0 <= shard < self._n_shards:
            raise ValueError(f"collection {self.name!r} has shards "
                             f"0..{self._n_shards - 1}; got shard={shard}")
        return self._rebuild_counted(self._rebuild_shard(shard, max_restarts))

    def _rebuild_counted(self, out: dict) -> dict:
        with self._lock:
            self.writer_counters["rebuild_replayed_rows"] += out["replayed"]
            self.writer_counters["rebuild_restarts"] += out["restarts"]
        return out

    def _rebuild_held(self, since: float) -> None:
        """Count the writer lock's hold by a rebuild since `since` (the
        caller still holds it)."""
        with self._lock:
            self.writer_counters["rebuild_lock_hold_s"] += (
                time.perf_counter() - since)

    def _rebuild_single(self, max_restarts: int) -> dict:
        """Unsharded delta-replay rebuild (full re-cluster)."""
        t0 = time.perf_counter()
        with self._rebuild_locks[0]:
            restarts = 0
            while True:
                exclusive = restarts >= max_restarts
                # promote-then-acquire: a demoted collection has no device
                # state to rebuild (and a demotion mid-rebuild bumps _epoch,
                # aborting us at the publish step like a bulk build would)
                self._acquire_writer_hot()
                held = time.perf_counter()
                snap = self._state
                epoch = self._epoch
                if not exclusive:
                    with self._lock:
                        self._delta_logs[0] = []
                        self._delta_overflow[0] = False
                    self._writer_lock.release()
                try:
                    new, spilled = ivf.rebuild(self._split(), snap, self.cfg)
                    spilled = int(spilled)   # sync: the recompute is done
                except BaseException:
                    # stop logging and release cleanly; writes stay applied
                    if not exclusive:
                        self._writer_lock.acquire()
                    try:
                        with self._lock:
                            self._delta_logs[0] = None
                            self._delta_overflow[0] = False
                    finally:
                        self._writer_lock.release()
                    raise
                if not exclusive:
                    self._writer_lock.acquire()
                    held = time.perf_counter()
                try:
                    with self._lock:
                        log = self._delta_logs[0] or []
                        overflow = self._delta_overflow[0]
                        self._delta_logs[0] = None
                        self._delta_overflow[0] = False
                    if self._epoch != epoch:
                        # a bulk build replaced the index (or a demotion
                        # released it) mid-rebuild: our snapshot is obsolete
                        return {"rebuild_s": time.perf_counter() - t0,
                                "spilled": 0, "replayed": 0,
                                "restarts": restarts, "aborted": True}
                    if overflow:
                        restarts += 1
                        continue
                    replayed = sum(int(op.ids.shape[0]) for op in log)
                    with span("ame.coll.rebuild.replay"):
                        tombstoned = 0
                        extra = 0
                        if log:
                            new, extra, tombstoned = ivf.replay(new, log, self.cfg)
                        # replayed deletes leave real tombstones in the swapped
                        # state — pressure must reflect them.  Only the
                        # recompute's own leftover spill becomes the floor; replay
                        # spill stays live pressure for the next rebuild.
                        with self._lock:
                            self._shard_pressure[0] = {"tombstones": tombstoned,
                                                       "spilled": spilled + extra}
                            self._spill_floors[0] = spilled
                        spilled += extra
                        self._swap(new, rebuilds=1)
                        # the rebuilt store may have repacked/dropped slots the
                        # mirrored graph still reflects — drop the derived
                        # graph; the next graph query rebuilds it from the
                        # post-replay live rows
                        self._graph_invalidate()
                    return {"rebuild_s": time.perf_counter() - t0,
                            "spilled": spilled, "replayed": replayed,
                            "restarts": restarts, "aborted": False}
                finally:
                    self._rebuild_held(held)
                    self._writer_lock.release()

    def _rebuild_shard(self, shard: int, max_restarts: int) -> dict:
        """Shard-local delta-replay rebuild of one mesh shard.

        `_rebuild_single`'s protocol with two twists: the recompute is
        `dist_rebuild` (compaction of shard `shard` only), and the publish
        step *adopts* the rebuilt shard into the CURRENT live state (as
        `dist_adopt_shard` does), so sibling-shard writes that landed
        during the off-lock recompute are kept without replay — only this
        shard's logged ops replay onto it.  The recompute
        (`dce.compact_shard`, `dist_rebuild`'s per-shard step) holds only
        this shard's snapshot: the siblings' old states are freed as
        concurrent writes replace them.
        """
        t0 = time.perf_counter()
        with self._rebuild_locks[shard]:
            restarts = 0
            while True:
                exclusive = restarts >= max_restarts
                self._acquire_writer_hot()
                held = time.perf_counter()
                snap = self._state[shard]
                epoch = self._epoch
                if not exclusive:
                    with self._lock:
                        self._delta_logs[shard] = []
                        self._delta_overflow[shard] = False
                    self._writer_lock.release()
                try:
                    rebuilt, sp = dce.compact_shard(snap, self.cfg)
                    del snap
                    spilled = int(sp)   # sync: the recompute is done
                except BaseException:
                    if not exclusive:
                        self._writer_lock.acquire()
                    try:
                        with self._lock:
                            self._delta_logs[shard] = None
                            self._delta_overflow[shard] = False
                    finally:
                        self._writer_lock.release()
                    raise
                if not exclusive:
                    self._writer_lock.acquire()
                    held = time.perf_counter()
                try:
                    with self._lock:
                        log = self._delta_logs[shard] or []
                        overflow = self._delta_overflow[shard]
                        self._delta_logs[shard] = None
                        self._delta_overflow[shard] = False
                    if self._epoch != epoch:
                        return {"rebuild_s": time.perf_counter() - t0,
                                "spilled": 0, "replayed": 0,
                                "restarts": restarts, "aborted": True,
                                "shard": shard}
                    if overflow:
                        restarts += 1
                        continue
                    # siblings keep their LIVE states (concurrent writes
                    # already applied there); only this shard swaps in the
                    # rebuilt state and replays its log
                    cur = self._state
                    merged = cur[:shard] + (rebuilt,) + cur[shard + 1:]
                    replayed = sum(int(op.ids.shape[0]) for op in log)
                    extra = tombstoned = 0
                    if log:
                        merged, extra, tombstoned = dce.dist_replay(
                            merged, log, shard, self.cfg, self.mesh)
                    # Spill rebalance: rows this rebuild could not drain
                    # move to an underfull sibling's spill buffer, whose
                    # spill pressure rises accordingly, so its next rebuild
                    # drains them into free list slots.
                    moved, moved_to = 0, None
                    if spilled + extra > 0:
                        merged, moved, moved_to = self._rebalance_spill(
                            merged, shard)
                    with self._lock:
                        self._shard_pressure[shard] = {
                            "tombstones": tombstoned,
                            "spilled": max(spilled + extra - moved, 0)}
                        self._spill_floors[shard] = max(spilled - moved, 0)
                        if moved_to is not None:
                            self._shard_pressure[moved_to]["spilled"] += moved
                    spilled += extra
                    bump = (shard,) if moved_to is None else (shard, moved_to)
                    self._swap(merged, shards=bump, rebuilds=1)
                    return {"rebuild_s": time.perf_counter() - t0,
                            "spilled": spilled, "replayed": replayed,
                            "restarts": restarts, "aborted": False,
                            "shard": shard, "rebalanced": moved,
                            "rebalance_to": moved_to}
                finally:
                    self._rebuild_held(held)
                    self._writer_lock.release()

    def _rebalance_spill(self, state, src: int):
        """Move shard `src`'s live spill rows to an underfull sibling.

        The destination is the sibling with the most free list slots among
        those with spill room; rows move with their per-row int8 sideband,
        and `src`'s spill buffer is compacted (its tombstoned spill slots
        vanish, so `num_deleted` drops by their count).  Only the two
        shards' spill fields are rewritten, on their devices, into new
        tensors: the published siblings are never written.

        Caller holds the writer lock.  A sibling whose own rebuild is
        mid-recompute (`_rebuild_locks[j]` held) is skipped: its publish
        adopts a state computed from a pre-move snapshot and would drop the
        rows moved into it.

        Returns (new_state, moved_rows, dst_shard) — (state, 0, None) when
        there is nothing to move or nowhere to put it.
        """
        if self._n_shards < 2:
            return state, 0, None
        s = state[src]
        cap = int(s.spill_ids.shape[0])
        n_src = int(s.spill_size)
        live = (s.spill_ids[:n_src] >= 0).nonzero().squeeze(1)
        if live.numel() == 0:
            return state, 0, None
        dst, dst_key = None, None
        for j, t in enumerate(state):
            if j == src or self._rebuild_locks[j].locked():
                continue
            free_spill = cap - int(t.spill_size)
            if free_spill <= 0:
                continue
            free_lists = t.list_ids.numel() - int(t.list_sizes.sum())
            key = (free_lists, free_spill)
            if dst is None or key > dst_key:
                dst, dst_key = j, key
        if dst is None:
            return state, 0, None
        d = state[dst]
        n_dst = int(d.spill_size)
        m = int(min(live.numel(), cap - n_dst))
        take, keep = live[:m], live[m:]
        dead = n_src - live.numel()     # tombstoned spill slots compacted

        def pack_src(a, fill=0):
            out = torch.full_like(a, fill)
            out[:keep.numel()] = a[keep]
            return out

        def grow_dst(a, moved):
            a = a.clone()
            a[n_dst:n_dst + m] = moved.to(a.device)
            return a

        def scalar(v, like):
            return torch.tensor(v, dtype=torch.int32, device=like.device)

        s_new = s._replace(
            spill=pack_src(s.spill), spill_ids=pack_src(s.spill_ids, -1),
            spill_size=scalar(keep.numel(), s.spill_size),
            num_deleted=scalar(int(s.num_deleted) - dead, s.num_deleted))
        d_new = d._replace(
            spill=grow_dst(d.spill, s.spill[take]),
            spill_ids=grow_dst(d.spill_ids, s.spill_ids[take]),
            spill_size=scalar(n_dst + m, d.spill_size))
        if s.q_spill is not None:
            # the per-row affine sideband rides along with its rows
            s_new = s_new._replace(
                q_spill=pack_src(s.q_spill),
                q_spill_scales=pack_src(s.q_spill_scales, 1.0),
                q_spill_zeros=pack_src(s.q_spill_zeros),
                q_spill_norms=pack_src(s.q_spill_norms))
            d_new = d_new._replace(**{
                f: grow_dst(getattr(d, f), getattr(s, f)[take])
                for f in ("q_spill", "q_spill_scales", "q_spill_zeros",
                          "q_spill_norms")})
        out = list(state)
        out[src], out[dst] = s_new, d_new
        return tuple(out), m, dst

    # ------------------------------------------------------------------
    # Maintenance pressure (consumed by the service's MaintenanceController)
    # ------------------------------------------------------------------
    def maintenance_pressure(self) -> dict:
        """Host-side pressure since the last (re)build — poll-cheap."""
        with self._lock:
            shards = [dict(p) for p in self._shard_pressure]
            for s, log in enumerate(self._delta_logs):
                shards[s]["delta_backlog"] = len(log) if log is not None else 0
        return {"tombstones": sum(s["tombstones"] for s in shards),
                "spilled": sum(s["spilled"] for s in shards),
                "delta_backlog": max(s["delta_backlog"] for s in shards),
                "shards": shards}

    def _maintenance_limits(self) -> Tuple[int, int]:
        """Per-shard (tombstone, spill) rebuild trigger limits: each shard
        owns `cfg.capacity` list slots and `spill_capacity` spill slots; the
        shard-local pending floor applies only when actually sharded."""
        return self.thresholds.maintenance_limits(self.cfg.capacity,
                                                  self.spill_capacity,
                                                  per_shard=self.sharded)

    def maintenance_due_shards(self) -> List[int]:
        """Shard ids whose tombstone/spill pressure crosses the thresholds —
        each worth an independent shard-local rebuild (`[0]` when an
        unsharded collection is due)."""
        if not self._built or self.residency != "hot":
            # a demoted collection has no device state to compact; promoting
            # it just to rebuild would fight the eviction policy — pressure
            # keeps accruing and is served once a query promotes it
            return []
        tomb_limit, spill_limit = self._maintenance_limits()
        with self._lock:
            press = [dict(p) for p in self._shard_pressure]
            floors = list(self._spill_floors)
        # only spill above the irreducible floor counts — residual spill the
        # last rebuild failed to place must not re-trigger it forever
        return [s for s in range(len(press))
                if press[s]["tombstones"] >= tomb_limit
                or press[s]["spilled"] - floors[s] >= spill_limit]

    def maintenance_due(self) -> bool:
        """True when the pressure crosses the thresholds and a background
        rebuild would pay for itself."""
        return bool(self.maintenance_due_shards())

    # ------------------------------------------------------------------
    # Index policy + derived HNSW graph tier (recall-adaptive routing)
    # ------------------------------------------------------------------
    def index_policy(self) -> str:
        """Resolved index policy for the collection's CURRENT size.

        "auto" follows the host-side live-row estimate across the template
        thresholds: <= `flat_max_rows` -> "flat" (exact full scan),
        >= `hnsw_min_rows` -> "hnsw" (derived graph), else "ivf".  Sharded
        collections always resolve to "ivf": the mesh tier serves exact
        per-shard scans with a merge.
        """
        pol = self.cfg.index_policy
        if pol != "auto":
            return pol
        if self.sharded:
            return "ivf"
        with self._lock:
            n = self._approx_live
        if n <= self.thresholds.flat_max_rows:
            return "flat"
        if n >= self.thresholds.hnsw_min_rows:
            return "hnsw"
        return "ivf"

    def tuned_nprobe(self) -> int:
        """The tuner-owned nprobe (cfg default until a tuner exists)."""
        t = self._nprobe_tuner
        return self.cfg.nprobe if t is None else t.knob

    def tuned_ef(self, k: Optional[int] = None) -> int:
        """The tuner-owned HNSW beam width, floored at k."""
        t = self._ef_tuner
        ef = self.cfg.hnsw_ef if t is None else t.knob
        return max(ef, k or self.cfg.k)

    def _graph_invalidate(self) -> None:
        with self._graph_lock:
            self._graph = None

    def _graph_apply(self, kind: str, rows, ids) -> None:
        """Incrementally mirror one write into the derived graph.  Caller
        holds the writer lock, so graph mutation order == state order; a
        no-op until a graph exists (it then rebuilds lazily including this
        write).  `rows` f32[N, D] for inserts and `ids` are tensors or host
        arrays; they come to the host only when a graph exists."""
        with self._graph_lock:
            g = self._graph
            if g is None:
                return
            ids = np.atleast_1d(_host(ids))
            if kind == "insert":
                for r, i in zip(_host(rows), ids):
                    g.add(r, int(i))
            else:
                for i in ids:
                    g.delete(int(i))

    def _build_graph_from(self, state: ivf.IVFState) -> HNSW:
        """Fresh HNSW graph over the live rows of `state`.  The graph is
        host numpy, so this is the one place the rows come to the host."""
        rows, ids = ivf.flat_rows_host(state)
        live = np.nonzero(ids >= 0)[0]
        g = HNSW(self.cfg.dim, m=self.cfg.hnsw_m,
                 ef_construction=max(self.cfg.hnsw_ef, 2 * self.cfg.hnsw_m),
                 metric=self.cfg.metric)
        g.build(rows[live], ids[live])
        return g

    def _ensure_graph(self) -> HNSW:
        """The derived graph, (re)building it from the live rows if absent.

        The build runs under the writer lock (serialized against mutators,
        so no mirror update can be lost between the snapshot read and the
        install) — the cost lands on the first graph query after an
        invalidation.  Queries against an existing graph never touch the
        writer lock.
        """
        with self._graph_lock:
            g = self._graph
        if g is not None:
            return g
        with self._hot_writer():
            with self._graph_lock:
                g = self._graph
            if g is None:
                g = self._build_graph_from(self._state)
                with self._graph_lock:
                    self._graph = g
            return g

    def _query_graph(self, q: np.ndarray, k: int,
                     ef: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Serve a host query batch from the HNSW graph (path "hnsw").

        Returns (ids i64[B, k], scores f32[B, k]) in the engine's score
        convention (larger = better; "ip" scores are raw inner products,
        "l2" scores are negated distances so rankings match the IVF paths).
        Searches serialize on the graph lock — the single-threaded
        pointer-chasing baseline the paper measures against.
        """
        g = self._ensure_graph()
        ef = ef or self.tuned_ef(k)
        with self._graph_lock:
            ids, ds = g.search_batch_scored(q, k, ef=ef)
        scores = np.where(np.isfinite(ds), -ds, -np.inf).astype(np.float32)
        return ids, scores

    # ------------------------------------------------------------------
    # Recall probe (background MemoryOp kind "probe")
    # ------------------------------------------------------------------
    def recall_probe_due(self) -> bool:
        """True when the recall tuner wants a fresh measurement: probing
        armed (`cfg.target_recall > 0`), built, HOT, and at least
        `thresholds.probe_interval_ops` ops since the last probe."""
        if self.cfg.target_recall <= 0:
            return False
        with self._lock:
            return (self._built and self._residency_tier == "hot"
                    and self._probe_ops >= self.thresholds.probe_interval_ops)

    def recall_probe(self, sample: Optional[int] = None,
                     k: Optional[int] = None) -> dict:
        """One recall measurement + tuner step (the "probe" op kind).

        Snapshots the state, samples live rows as queries, runs them down
        the collection's LIVE serving path, scores against the exact
        brute-force oracle on the same snapshot, and feeds recall@k to the
        path's knob tuner (`nprobe` on the probed path, `ef` on the graph
        path; the flat path is exact — measured, never retuned).  Read-only
        w.r.t. the row store: no writer lock, no state swap — retuning has
        zero query downtime (in-flight queries keep the knob they resolved;
        later ones pick up the new value atomically).

        The snapshot stays on its device: the flat rows, the sampled
        queries, the oracle and the served path all run there, and only
        the ids come to the host, to draw the sample (the graph path's
        queries go to the host, where the graph is).
        """
        k = k or self.cfg.k
        sample = sample or self.thresholds.probe_sample
        with self._lock:
            if not self._built or self._residency_tier != "hot":
                return {"skipped": self._residency_tier, "recall": None}
            state = self._state
            self._probe_ops = 0
            seq = self._probe_seq
            self._probe_seq += 1
        # the flat view of the snapshot (list tier, then spill; sharded:
        # shard after shard) is the oracle's ground truth, in the
        # reference's slot order.  A sharded snapshot's rows are read one
        # shard at a time; only its ids are gathered whole.
        if self.sharded:
            flat_ids = [ivf._flat_ids(st) for st in state]
            ids_host = np.concatenate([f.cpu().numpy() for f in flat_ids])
        else:
            rows, ids = ivf._flat_rows(state)
            ids_host = ids.cpu().numpy()
        live = np.nonzero(ids_host >= 0)[0]
        # Probe the path the policy serves steady traffic with — NOT the
        # batch router's choice for the probe's own batch size: a
        # probe_sample-row batch would route to the exact full scan and the
        # nprobe tuner would never observe the probed path it owns.
        pol = self.index_policy()
        if self.sharded:
            path, nprobe = "sharded", 0
        elif pol == "flat":
            path, nprobe = "full_scan", 0
        elif pol == "hnsw":
            path, nprobe = "hnsw", 0
        else:
            path = "probed"
            nprobe = max(1, min(self.tuned_nprobe(), self.cfg.n_clusters))
        out = {"path": path, "k": k, "sample": 0, "recall": 1.0,
               "knob": None, "retuned": False, "seq": seq}
        if len(live) == 0:            # nothing to measure — vacuously met
            with self._lock:
                self._last_probe = out
            return out
        rng = np.random.default_rng(
            (zlib.crc32(self.name.encode()) + seq) & 0x7FFFFFFF)
        sel = rng.choice(live, size=min(sample, len(live)), replace=False)
        if self.sharded:
            qs = self._sharded_flat_rows(state, flat_ids, sel)
            true = metrics.brute_force_topk_parts(
                qs, (ivf._flat_rows(st) for st in state), k,
                self.cfg.metric, device=self.device)
        else:
            qs = rows[torch.from_numpy(sel).to(rows.device)]
            true = metrics.brute_force_topk(qs, rows, ids, k,
                                            self.cfg.metric,
                                            device=rows.device)
            del rows, ids    # free the flat copy before the served path
        tuner = None
        if self.sharded:
            got, _ = dce.dist_query(state, qs, self.cfg, self.mesh, k)
        elif path == "full_scan":
            got, _ = ivf.query_full_scan(state, qs, self.cfg, k)
        elif path == "hnsw":
            tuner = self._ef_tuner
            got, _ = self._query_graph(qs.cpu().numpy(), k)
        else:
            tuner = self._nprobe_tuner
            got, _ = ivf.query_probed(state, qs, self.cfg, k, nprobe)
        rec = metrics.recall_at_k(_host(got), true)
        out.update(recall=rec, sample=int(len(sel)))
        if tuner is not None:
            before = tuner.knob
            after = tuner.observe(rec)
            out.update(knob=after, retuned=after != before)
        with self._lock:
            self._last_probe = out
        return out

    def _sharded_flat_rows(self, state, flat_ids, sel: np.ndarray
                           ) -> torch.Tensor:
        """Rows f32[len(sel), D] on shard 0's device at positions `sel` of
        the shards' concatenated flat views (`flat_ids` per shard)."""
        offs = np.cumsum([0] + [int(f.numel()) for f in flat_ids])
        shard_of = np.searchsorted(offs, sel, side="right") - 1
        out = torch.empty((len(sel), self.cfg.dim), dtype=torch.float32,
                          device=self.device)
        for s, st in enumerate(state):
            pos = np.nonzero(shard_of == s)[0]
            if len(pos):
                local = torch.from_numpy(sel[pos] - offs[s]).to(st.device)
                out[torch.from_numpy(pos).to(self.device)] = \
                    ivf._gather_flat_rows(st, local).to(self.device)
        return out

    # ------------------------------------------------------------------
    def resolve_query(self, batch: int, k, nprobe, path) -> Tuple[int, int, str]:
        """Resolve query params against collection defaults + the router.

        The resolved triple is part of the batch signature, so sync,
        future, and cross-collection-batched execution of the same request
        all take the identical execution path.

        nprobe is tuner-owned: a caller passing None gets the recall
        tuner's current knob (cfg default until a tuner exists), clamped
        exactly like `ivf.query_probed` clamps it — the resolved value IS
        the executed value, so two tenants tuned to different nprobe split
        fusion groups cleanly.  Off the probe path nprobe is not an
        execution parameter and is pinned to 0, so tuner divergence never
        splits full-scan or graph-path groups.

        The execution path follows the resolved index policy: "flat"
        always full-scans, "hnsw" serves from the derived graph, "ivf"
        keeps the template route.
        """
        k = k or self.cfg.k
        if not nprobe:
            nprobe = self.tuned_nprobe()
        nprobe = max(1, min(int(nprobe), self.cfg.n_clusters))
        if path is None:
            policy = self.index_policy()
            if policy == "flat":
                path = "full_scan"
            elif policy == "hnsw" and not self.sharded:
                path = "hnsw"
            else:
                path = templates.route("query", batch, self.cfg,
                                       self.thresholds).path
        if path != "probed":
            nprobe = 0        # unused off the probe path; keep groups whole
        return k, nprobe, path

    def batch_signature(self, batch: int, k, nprobe, path):
        """Fusion key: collections whose pending queries share this key can
        stack states and run as one lane-batched dispatch.

        `(cfg, store_dtype, spill_capacity, mesh, k, nprobe, path)` as in
        the reference: `cfg` pins the state shapes, `spill_capacity` the
        spill block, the resolved `(k, nprobe, path)` triple the templates,
        and the store policy is explicit so int8 and f32 lanes never fuse.
        The mesh is None for an unsharded collection; sharded lanes fuse
        only with lanes on an equal mesh (same devices and shape).
        """
        k, nprobe, path = self.resolve_query(batch, k, nprobe, path)
        return (self.cfg, self.cfg.store_dtype, self.spill_capacity,
                self.mesh if self.sharded else None, k, nprobe, path)

    def host_counters(self) -> dict:
        """`counters` and `writer_counters` in one dict, read under the
        pointer lock: host values only, no device sync."""
        with self._lock:
            return {**self.counters, **self.writer_counters}

    def stats(self) -> dict:
        """Counters + index occupancy snapshot.  Syncs device scalars —
        cheap but not free; poll `maintenance_pressure()` on hot paths."""
        with self._lock:
            state = self._state
            tier = self._residency_tier
            host = self._host_state
            counters = dict(self.counters)
            version = self._version
            shard_versions = list(self._shard_versions)
            pressure = [dict(p) for p in self._shard_pressure]
        if tier == "hot" and self.sharded:
            # the reference's keys for its global state: list_capacity is
            # the global slot axis (L * S); index_bytes counts each tensor
            # once (the shards on a device share their centroids)
            leaves = {(t.device, t.data_ptr()): t.numel() * t.element_size()
                      for st in state for t in st if t is not None}
            s = {"n_clusters": state[0].n_clusters, "dim": state[0].dim,
                 "list_capacity": state[0].list_capacity * self._n_shards,
                 "live": sum(int(ivf.live_count(st)) for st in state),
                 "spill": sum(int(st.spill_size) for st in state),
                 "deleted": sum(int(st.num_deleted) for st in state),
                 **ivf.footprint(state[0]),
                 "index_bytes": sum(leaves.values())}
        elif tier == "hot":
            s = ivf.stats(state)
        else:
            # no device state to sync; sizes are static, occupancy comes
            # from the host copy when one is in memory (cold = disk only)
            s = {"n_clusters": self.cfg.n_clusters, "dim": self.cfg.dim,
                 "list_capacity": self.cfg.list_capacity,
                 "index_bytes": self._index_nbytes,
                 "bytes_per_row": self.cfg.dim * (5 if self.cfg.quantized
                                                  else 4),
                 "scan_bytes_per_row": self.cfg.dim * (
                     1 if self.cfg.quantized else 4),
                 "store_dtype": self.cfg.store_dtype}
            if host is not None:
                s["live"] = sum(int(ivf.live_count(t)) for t in _shards(host))
                s["spill"] = sum(int(t.spill_size) for t in _shards(host))
                s["deleted"] = sum(int(t.num_deleted) for t in _shards(host))
        if self.sharded:
            s["shards"] = self._n_shards
            s["shard_versions"] = shard_versions
        s.update(counters)
        s["version"] = version
        s["residency"] = tier
        s["pressure"] = {"tombstones": sum(p["tombstones"] for p in pressure),
                         "spilled": sum(p["spilled"] for p in pressure),
                         "shards": pressure}
        s["index_policy"] = self.index_policy()
        if self._nprobe_tuner is not None:
            s["tuner"] = {"nprobe": self._nprobe_tuner.stats(),
                          "ef": self._ef_tuner.stats()}
        with self._lock:
            s["last_probe"] = (None if self._last_probe is None
                               else dict(self._last_probe))
        return s
