"""Cross-collection batched query execution (lane/pad/stack/demux); port of
``src/repro/api/batch.py``.

Pending queries against *different* collections that resolved to the same
execution signature — identical `EngineConfig` shapes, store policy, spill
capacity, `(k, nprobe)` and routed path — are fused: per-collection query
batches concatenate into **lanes**, lanes **pad** to a common batch Bmax
with zero rows, collection states **stack** along a new leading G axis, and
one lane-batched query (`fused_query`) answers all of them: every scan in
it is one launch of a scan kernel with a lane axis (``csrc/scan_scores.cu``,
``csrc/scan_scores_q8.cu``), where the reference runs its template under
`jax.vmap`.  The results are then **demuxed** back to the per-op futures
by row span.

Two stacking regimes, one invariant:

* Unsharded lanes stack their states (`stack_states`) and run `fused_query`.
* Mesh-sharded lanes stack per shard (`distributed.dist_stack_states`:
  shard s of every lane, ``[G, ...]`` on shard s's device) and run
  `distributed.dist_fused_query_stacked`: each shard's scan is one lane
  launch, and the merge of the shards' candidates is batched over lanes.

Correctness invariant (tested): the fused path returns what the
per-collection sync path returns — lane `g` only ever scans collection
`g`'s rows, each lane's arithmetic is the single-collection template's,
and padding rows are discarded on demux.

Stacking is the one cost fusion adds (a copy of every lane's state per
dispatch), so the service threads a `StackCache` through `execute_group`:
stacked states are tagged with the lanes' atomically-read versions and
reused until any lane writes.

Thread-safety: `execute_group` reads each collection's
`versioned_snapshot()` (a writer or rebuild swaps the pointer, never
mutates a published state) and `demux` only settles futures.  Neither
takes a collection or service lock, so a fused dispatch can never deadlock
against writers.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.core import distributed as dce
from repro_torch.core import index as ivf
from repro_torch.core import locking
from repro_torch.device import as_tensor


class NotResident(RuntimeError):
    """A fused lane's collection was demoted off the device between flush
    and dispatch (its snapshot is None) — the stacked execution cannot
    proceed.  The service catches this, re-promotes the lane and retries
    (or falls back to per-lane queries, which promote themselves)."""


def fused_query(stacked: ivf.IVFState, q: torch.Tensor, cfg: EngineConfig,
                k: int, nprobe: int, path: str):
    """One dispatch over G stacked (unsharded) collection states.

    stacked: IVFState whose every non-None leaf has a leading G axis
    q:       f32[G, Bmax, D] padded per-lane query batches
    Returns (ids i32[G, Bmax, k], scores f32[G, Bmax, k]).
    """
    if path == "full_scan":
        return ivf.query_full_scan(stacked, q, cfg, k)
    return ivf.query_probed(stacked, q, cfg, k, nprobe)


stack_states = ivf.stack_states


def _stack(snaps, mesh):
    """Stack G snapshots for one fused dispatch: leaf by leaf for unsharded
    lanes, per shard for mesh-sharded ones."""
    if mesh is not None:
        return dce.dist_stack_states(snaps, mesh)
    return stack_states(snaps)


def _nbytes(state) -> int:
    shards = (state,) if isinstance(state, ivf.IVFState) else state
    return sum(leaf.numel() * leaf.element_size() for st in shards
               for leaf in st if leaf is not None)


def _drop_group(entries: OrderedDict, key) -> None:
    """Drop the entries of `key`'s lanes at any version (the caller holds
    the cache's lock)."""
    mesh, tag = key
    for k in [k for k in entries
              if k[0] == mesh and len(k[1]) == len(tag)
              and all(a is b for (a, _), (b, _) in zip(k[1], tag))]:
        del entries[k]


class StackCache:
    """Reuse the stacked G-state across fused dispatches.

    Query-heavy windows re-dispatch the same tenant groups far more often
    than those tenants write, so the cache keys each stacked state by the
    lanes' *versioned snapshots* — `(collection, version)` pairs read
    atomically (`Collection.versioned_snapshot`) — and serves the stack
    straight back while every lane's version is unchanged.  Any write to
    any lane bumps its version, missing the key.  Versions only grow, so
    the miss also drops the group's stacks of older versions, which can
    never hit again: a group holds at most one entry.  LRU eviction
    (`maxsize` group entries) bounds the extra device memory.

    Thread-safety: the entry dict is guarded by a lock; the stack build
    itself runs outside it.  Two racing flushes over the same group may
    both build — harmless, last one cached.  A hit is proof (via the
    atomic version tag) that the stack equals re-stacking the lanes'
    current snapshots.
    """

    def __init__(self, maxsize: int = 4):
        self.maxsize = maxsize
        self._lock = locking.make_lock("_lock")
        # key -> (stacked_state, nbytes)
        self._entries: OrderedDict = OrderedDict()
        # collections evicted via evict(): a fused task already in flight
        # when its tenant was dropped must not re-insert that tenant's
        # stack after the eviction (weak refs — the set never pins)
        self._dropped: "weakref.WeakSet" = weakref.WeakSet()
        self.hits = 0
        self.misses = 0

    def stacked(self, collections, mesh) -> ivf.IVFState:
        snaps, tag = [], []
        for c in collections:
            state, version = c.versioned_snapshot()
            if state is None:
                raise NotResident(c.name)
            snaps.append(state)
            tag.append((c, version))
        key = (mesh, tuple(tag))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit[0]
            _drop_group(self._entries, key)    # before the new stack
        stacked = _stack(snaps, mesh)
        nbytes = _nbytes(stacked)
        with self._lock:
            self.misses += 1
            # serve but never cache a stack whose tenant was dropped while
            # it was built: caching would pin the dropped state; replace
            # any stack of the group a racing flush cached meanwhile
            if not any(c in self._dropped for c in collections):
                _drop_group(self._entries, key)
                self._entries[key] = (stacked, nbytes)
                self._entries.move_to_end(key)
                while len(self._entries) > self.maxsize:
                    self._entries.popitem(last=False)
        return stacked

    def device_bytes(self) -> int:
        """Device bytes the cached stacks pin."""
        with self._lock:
            return sum(nb for _, nb in self._entries.values())

    def pop_lru(self) -> bool:
        """Evict the least-recently-used stack; False when empty."""
        with self._lock:
            if not self._entries:
                return False
            self._entries.popitem(last=False)
            return True

    def evict(self, collection) -> None:
        """Drop every entry whose group includes `collection` (called by
        `MemoryService.drop_collection`, so a dropped tenant's stacked copy
        is released now), and mark it so a fused dispatch racing the drop
        cannot re-insert it."""
        with self._lock:
            self._dropped.add(collection)
            for key in [k for k in self._entries
                        if any(c is collection for c, _ in k[1])]:
                del self._entries[key]

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries),
                    "device_bytes": sum(
                        nb for _, nb in self._entries.values())}


def execute_group(collections, queries: List[np.ndarray],
                  cfg: EngineConfig, k: int, nprobe: int, path: str,
                  mesh=None, cache: Optional[StackCache] = None,
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Run one fused dispatch for same-signature lanes.

    collections: G distinct Collection objects (one per lane), on one device
    queries:     G query batches f32[B_g, D], numpy or tensors (B_g may
                 differ per lane)
    mesh:        None for unsharded lanes; the lanes' `ShardMesh` when
                 they are sharded (every lane on this mesh, by signature)
    cache:       optional `StackCache` reusing the stacked state across
                 dispatches while the lanes' versions are unchanged
    Returns per-lane host (ids [B_g, k], scores [B_g, k]), padding removed.
    """
    if path == "hnsw":
        raise ValueError("execute_group cannot stack path='hnsw' lanes; "
                         "the service dispatches graph-path groups per-lane")
    dev = collections[0].device
    lanes = [as_tensor(q, torch.float32, dev) for q in queries]
    lanes = [q[None] if q.dim() == 1 else q for q in lanes]
    sizes = [int(q.shape[0]) for q in lanes]
    padded = torch.zeros((len(lanes), max(sizes), cfg.dim),
                         dtype=torch.float32, device=dev)
    for g, q in enumerate(lanes):
        padded[g, :sizes[g]] = q
    if cache is not None:
        stacked = cache.stacked(collections, mesh)
    else:
        snaps = [c.snapshot() for c in collections]
        for c, s in zip(collections, snaps):
            if s is None:
                raise NotResident(c.name)
        stacked = _stack(snaps, mesh)
    for c, b in zip(collections, sizes):
        c._bump(queries=b)
    if mesh is not None:
        ids, scores = dce.dist_fused_query_stacked(stacked, padded, cfg, mesh,
                                                   k, nprobe, path)
    else:
        ids, scores = fused_query(stacked, padded, cfg, k, nprobe, path)
    ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
    return [(ids[g, :b], scores[g, :b]) for g, b in enumerate(sizes)]


def demux(entries, results) -> None:
    """Resolve each pending op's future from its lane slice.

    entries: per-lane lists of (future, start, stop) row spans
    results: per-lane (ids, scores) from `execute_group`

    Each future is settled exactly once, from host arrays the calling
    worker owns; no locks are taken.
    """
    for lane_entries, (ids, scores) in zip(entries, results):
        for fut, start, stop in lane_entries:
            fut._set_result((ids[start:stop], scores[start:stop]))
