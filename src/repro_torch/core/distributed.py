"""The mesh-sharded tier; port of ``src/repro/core/distributed.py``.

The reference shards one global `IVFState` over a `jax.sharding.Mesh`:
every device owns an equal slice of every IVF list's slots plus its own
spill buffer, the centroids are replicated, and each op runs the
single-device core inside `shard_map`.  The port keeps the partitioning
and holds it as what each device sees there: a sharded state is a tuple
of S shard-local `IVFState`s, shard i on ``mesh.devices[i]``, and shard i
is exactly the reference's ``split_host(state, S)[i]`` (same fields,
shapes, dtypes, ``-1`` sentinels and order).  The shards on one device
share one ``centroids`` tensor, so the resident bytes are
``ivf.state_nbytes(cfg, spill, S)`` as in the reference.

Every op is a loop over shards of the port's single-device core, each on
its shard's device.  On one card the loop runs the S shards one after
another on that card; on several cards the same layout needs no change.
Only the merges move data between devices, to shard 0's: the ``[B, k]``
candidates of a query and the ``[C, D]`` partial sums of k-means.

  * query  — each shard full-scans its slots and keeps its top k; the
             ``[B, S*k]`` candidates concatenate in shard order and a
             final top-k breaks ties by the lower position, as
             ``jax.lax.top_k`` after the reference's all-gather does.
  * fused query — G sharded collections' lanes stack per shard (``[G,
             ...]`` on that shard's device) and every shard's scan is one
             lane launch; the merge is batched over lanes.
  * insert — rows route block-wise: shard s takes rows [s*B/S, (s+1)*B/S).
  * build  — k-means with per-shard assignment and partial sums; the sum
             of the S partials on shard 0's device, in shard order, takes
             the place of the reference's ``psum``.  Empty clusters keep
             their old centroid (no re-seeding, unlike `core/kmeans.py`).
  * delete — shard-local tombstoning with per-shard hit counts.
  * rebuild / replay — shard-local compaction against the kept centroids
             and per-shard delta replay; siblings' tensors are untouched
             (the same storage, not a copy).

`split_host` / `assemble_host` convert between the reference's global
layout (``[C, L*S, D]`` lists, stacked per-shard scalars) and per-shard
states; `reshard_host` re-packs saved shards for another shard count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.core import index as ivf
from repro_torch.core.kmeans import _gumbel_topk
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

ShardedState = Tuple[ivf.IVFState, ...]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The port's mesh: the reference's row-major shard order over named
    axes, and one device per shard.  Frozen and hashable: it is part of
    the batch signature, so only lanes on equal meshes fuse.  `owners`,
    on a mesh whose shards span processes (`repro_torch.launch.mesh.
    process_mesh`), is the rank of the process that holds each shard; a
    shard another process holds is on the ``meta`` device here."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]
    owners: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes "
                             f"{self.axis_names}")
        if math.prod(self.shape) != len(self.devices) or not self.devices:
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")
        if self.owners is not None and len(self.owners) != len(self.devices):
            raise ValueError(f"{len(self.owners)} owners for "
                             f"{len(self.devices)} shards")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Union[None, str, torch.device,
                             Sequence[Union[str, torch.device]]] = None
              ) -> ShardMesh:
    """A `ShardMesh` of ``prod(shape)`` shards.  `devices` is one device
    per shard, or one device for every shard; None puts every shard on the
    card (`resolve_device`: with no card and no device named, it raises)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [resolve_device(devices)] * n
    return ShardMesh(shape, tuple(axis_names),
                     tuple(resolve_device(d) for d in devices))


def _check(state, mesh: ShardMesh) -> None:
    if (not isinstance(state, tuple) or isinstance(state, ivf.IVFState)
            or len(state) != mesh.size):
        raise ValueError(f"expected a {mesh.size}-shard state (a tuple of "
                         "shard-local IVFStates)")


def _on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def _blocks(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The n contiguous row blocks of x (the reference's ``P(ax)`` split)."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n} shards")
    b = x.shape[0] // n
    return [x[s * b:(s + 1) * b] for s in range(n)]


def share_centroids(shards: Sequence[ivf.IVFState]) -> ShardedState:
    """The shards with one ``centroids`` tensor per device (the first
    shard's on it).  Only for shards whose centroids are equal, as the
    replicated centroids of one sharded state always are."""
    first = {}
    out = []
    for st in shards:
        cent = first.setdefault(st.centroids.device, st.centroids)
        out.append(st._replace(centroids=cent))
    return tuple(out)


def empty_dist_state(cfg: EngineConfig, mesh: ShardMesh,
                     spill_capacity_per_shard: int = 4096) -> ShardedState:
    """S empty shard-local states on the mesh (the reference's global
    arrays, split)."""
    return share_centroids([
        ivf.empty_state(cfg, spill_capacity_per_shard, device=dev)
        for dev in mesh.devices])


def _merge_topk(parts, k: int, dev: torch.device):
    """Concatenate per-shard (ids, scores) along the last axis in shard
    order on `dev`; top k with ties to the lower position."""
    ids = torch.cat([_on(i, dev) for i, _ in parts], dim=-1)
    sc = torch.cat([_on(s, dev) for _, s in parts], dim=-1)
    pos = torch.sort(sc, dim=-1, descending=True, stable=True).indices
    pos = pos[..., :k]
    return ids.gather(-1, pos), sc.gather(-1, pos)


# ---------------------------------------------------------------------------
# Distributed k-means + build
# ---------------------------------------------------------------------------

def dist_build(gen: Optional[torch.Generator], x: torch.Tensor,
               ids: torch.Tensor, cfg: EngineConfig, mesh: ShardMesh,
               spill_capacity_per_shard: int = 4096, *,
               seed_idx: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[ShardedState, torch.Tensor]:
    """Build over rows x f32[N, D] (ids i32[N]; -1 = ignore), shard s
    taking the block [s*N/S, (s+1)*N/S).  Returns (state, spilled i32[S]).

    Seeds: C // S rows per shard by Gumbel top-k over its valid rows, each
    shard from its own stream derived from `gen`, gathered in shard order
    (tiled when fewer than C).  `seed_idx` (S index tensors) replaces those
    draws, for parity with the reference's."""
    n = mesh.size
    c = cfg.n_clusters
    xs = [_on(b, d) for b, d in zip(_blocks(x, n), mesh.devices)]
    idss = [_on(b, d) for b, d in zip(_blocks(ids, n), mesh.devices)]
    valid = [i >= 0 for i in idss]
    if seed_idx is None:
        nseed = max(c // n, 1)
        base = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                 device=gen.device))
        seed_idx = [_gumbel_topk(
            torch.Generator(device=d).manual_seed((base + s) % (2**31 - 1)),
            v, nseed) for s, (d, v) in enumerate(zip(mesh.devices, valid))]
    dev0 = mesh.devices[0]
    cent = torch.cat([_on(xb[_on(si, xb.device)], dev0)
                      for xb, si in zip(xs, seed_idx)])[:c]
    if cent.shape[0] < c:
        cent = cent.repeat(-(-c // cent.shape[0]), 1)[:c]
    cent = cent.contiguous()

    def assign(s, cs):
        idx, _ = ops.kmeans_assign(xs[s], cs, use_kernel=cfg.use_kernel,
                                   fused_conversion=cfg.fused_conversion)
        return torch.where(valid[s], idx, -1).to(torch.int32)

    def per_device(cent):
        copies = {}
        return [copies.setdefault(d, _on(cent, d)) for d in mesh.devices]

    for _ in range(cfg.kmeans_iters):
        sums = counts = None
        for s, cs in enumerate(per_device(cent)):
            sm, ct = ops.segsum_gemm(xs[s], assign(s, cs), n_clusters=c,
                                     use_kernel=cfg.use_kernel)
            sums = _on(sm, dev0) if sums is None else sums + _on(sm, dev0)
            counts = _on(ct, dev0) if counts is None else counts + _on(ct, dev0)
        new = sums / counts.clamp_min(1.0)[:, None]
        new = torch.where((counts > 0)[:, None], new, cent)
        if cfg.metric == "ip":
            new = new / torch.linalg.norm(new, dim=1,
                                          keepdim=True).clamp_min(1e-6)
        cent = new.contiguous()

    states, spilled = [], []
    for s, cs in enumerate(per_device(cent)):
        st = ivf.empty_state(cfg, spill_capacity_per_shard,
                             device=mesh.devices[s])._replace(centroids=cs)
        st, sp = ivf._pack(st, xs[s], idss[s], assign(s, cs), cfg)
        states.append(st)
        spilled.append(_on(sp, dev0))
    return tuple(states), torch.stack(spilled)


# ---------------------------------------------------------------------------
# Distributed query (+ the fused lanes x shards form)
# ---------------------------------------------------------------------------

def dist_query(state: ShardedState, q: torch.Tensor, cfg: EngineConfig,
               mesh: ShardMesh, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q f32[B, D] -> (ids i32[B, k], scores f32[B, k]) on shard 0's
    device: a full scan and top k per shard, then the merge."""
    _check(state, mesh)
    parts = [ivf.query_full_scan(st, _on(q, st.device), cfg, k)
             for st in state]
    return _merge_topk(parts, k, mesh.devices[0])


def dist_stack_states(states: Sequence[ShardedState],
                      mesh: ShardMesh) -> ShardedState:
    """Stack G same-shaped sharded states lane-wise, per shard: shard s of
    the result is the G lanes' shard-s states stacked ``[G, ...]`` on
    shard s's device (no data crosses devices)."""
    for st in states:
        _check(st, mesh)
    return tuple(ivf.stack_states([st[s] for st in states])
                 for s in range(mesh.size))


def dist_fused_query_stacked(stacked: ShardedState, q: torch.Tensor,
                             cfg: EngineConfig, mesh: ShardMesh, k: int,
                             nprobe: int, path: str):
    """One dispatch over G sharded collections' lanes.

    stacked: a `dist_stack_states` result; q: f32[G, Bmax, D] padded lane
    batches.  Returns (ids i32[G, Bmax, k], scores f32[G, Bmax, k]).  Each
    shard's scan is one lane launch over its [G, rows/shard, ...] stack;
    the merge is `dist_query`'s, batched over lanes.  `nprobe` and `path`
    are the batch signature's: the sharded tier always full-scans, as the
    per-op `dist_query` it equals does."""
    _check(stacked, mesh)
    parts = [ivf.query_full_scan(st, _on(q, st.device), cfg, k)
             for st in stacked]
    return _merge_topk(parts, k, mesh.devices[0])


def dist_fused_query(states: Sequence[ShardedState], q: torch.Tensor,
                     cfg: EngineConfig, mesh: ShardMesh, k: int,
                     nprobe: int, path: str):
    """`dist_fused_query_stacked` over freshly stacked states."""
    return dist_fused_query_stacked(dist_stack_states(states, mesh), q, cfg,
                                    mesh, k, nprobe, path)


# ---------------------------------------------------------------------------
# Distributed insert / delete
# ---------------------------------------------------------------------------

def dist_insert(state: ShardedState, x: torch.Tensor, ids: torch.Tensor,
                cfg: EngineConfig, mesh: ShardMesh
                ) -> Tuple[ShardedState, torch.Tensor]:
    """Insert x f32[B, D], B divisible by S: shard s takes the block
    [s*B/S, (s+1)*B/S).  Copies what it writes (`ivf.insert_shared`), so
    readers of `state` are unaffected.  Returns (state, spilled i32[S])."""
    _check(state, mesh)
    out, spilled = [], []
    for st, xb, ib in zip(state, _blocks(x, mesh.size),
                          _blocks(ids, mesh.size)):
        st, sp = ivf.insert_shared(st, _on(xb, st.device),
                                   _on(ib, st.device), cfg)
        out.append(st)
        spilled.append(_on(sp, mesh.devices[0]))
    return tuple(out), torch.stack(spilled)


def dist_delete(state: ShardedState, ids: torch.Tensor, mesh: ShardMesh
                ) -> Tuple[ShardedState, torch.Tensor]:
    """Tombstone `ids` on every shard, shard-locally, on copies.  Returns
    (state, n_hit i32[S]): per-shard counts of slots tombstoned."""
    _check(state, mesh)
    out, hits = [], []
    for st in state:
        st, n = ivf.delete_shared(st, _on(ids, st.device))
        out.append(st)
        hits.append(_on(n, mesh.devices[0]))
    return tuple(out), torch.stack(hits)


# ---------------------------------------------------------------------------
# Shard-local rebuild (compaction) + delta replay
# ---------------------------------------------------------------------------

def compact_shard(st: ivf.IVFState, cfg: EngineConfig
                  ) -> Tuple[ivf.IVFState, torch.Tensor]:
    """One shard's live rows reassigned against its centroids and packed
    into a fresh state (its spill drained); returns (state, spilled i32[]).  Only the live rows are
    gathered, in slot order: packing the reference's whole flat view puts
    them in the same places, since dead slots rank after every cluster."""
    ids = ivf._flat_ids(st)
    live = (ids >= 0).nonzero().squeeze(1)
    fresh = ivf.empty_state(cfg, st.spill.shape[0], device=st.device
                            )._replace(centroids=st.centroids)
    if live.numel() == 0:
        return fresh, torch.zeros((), dtype=torch.int32, device=st.device)
    n_list = st.lists.shape[0] * st.lists.shape[1]
    in_lists = int((live < n_list).sum())
    rows = torch.empty((live.numel(), st.dim), dtype=torch.float32,
                       device=st.device)
    torch.index_select(st.lists.flatten(0, 1), 0, live[:in_lists],
                       out=rows[:in_lists])
    torch.index_select(st.spill, 0, live[in_lists:] - n_list,
                       out=rows[in_lists:])
    idx, _ = ops.kmeans_assign(rows, st.centroids, use_kernel=cfg.use_kernel,
                               fused_conversion=cfg.fused_conversion)
    return ivf._pack(fresh, rows, ids[live], idx, cfg)


def dist_rebuild(state: ShardedState, cfg: EngineConfig, mesh: ShardMesh,
                 shard: int = -1) -> Tuple[ShardedState, torch.Tensor]:
    """Shard-local compaction of shard `shard` (every shard when < 0)
    against the kept centroids; the other shards' states pass through
    (the same tensors).  Returns (state, spilled i32[S]), 0 for shards
    left alone."""
    _check(state, mesh)
    out, spilled = list(state), []
    for i, st in enumerate(state):
        sp = torch.zeros((), dtype=torch.int32, device=st.device)
        if shard < 0 or i == shard:
            out[i], sp = compact_shard(st, cfg)
        spilled.append(_on(sp.to(torch.int32), mesh.devices[0]))
    return tuple(out), torch.stack(spilled)


def dist_adopt_shard(current: ShardedState, rebuilt: ShardedState,
                     shard: int, mesh: ShardMesh) -> ShardedState:
    """`current` with shard `shard` taken from `rebuilt` (the sharded
    counterpart of the unsharded rebuild's swap).  `Collection` adopts the
    one shard it compacted (`compact_shard`) the same way, holding only
    that shard's snapshot while it recomputes."""
    _check(current, mesh)
    out = list(current)
    out[shard] = rebuilt[shard]
    return tuple(out)


def dist_replay(state: ShardedState, log: Sequence[ivf.DeltaOp], shard: int,
                cfg: EngineConfig, mesh: ShardMesh
                ) -> Tuple[ShardedState, int, int]:
    """Re-apply a per-shard delta log onto shard `shard` only, in place
    (the caller owns that shard's state alone, as after
    `dist_adopt_shard`).  Insert ops carry the shard's own row block,
    delete ops the whole id list.  Returns (state, n_spilled,
    n_tombstoned) for the replayed shard."""
    _check(state, mesh)
    st = state[shard]
    for op in log:
        if op.kind not in ("insert", "delete"):
            raise ValueError(f"unknown delta op kind {op.kind!r}")
    log = [ivf.DeltaOp(op.kind,
                       None if op.rows is None else _on(op.rows, st.device),
                       _on(op.ids, st.device)) for op in log]
    st, spilled, tombstoned = ivf.replay(st, log, cfg)
    out = list(state)
    out[shard] = st
    return tuple(out), spilled, tombstoned


# ---------------------------------------------------------------------------
# Host-side layout helpers (persistence, resharding, the parity tests)
# ---------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def split_host(state, n_shards: int) -> List[ivf.IVFState]:
    """A state in the reference's global layout (any NamedTuple of host
    arrays or tensors with IVFState's fields) -> n_shards shard-local
    IVFStates of numpy arrays (slab i of every sharded leaf is shard i)."""
    g = ivf.IVFState(*[None if getattr(state, f, None) is None
                       else _np(getattr(state, f))
                       for f in ivf.IVFState._fields])
    c = g.centroids.shape[0]
    l = g.lists.shape[1] // n_shards
    sc = g.spill.shape[0] // n_shards
    out = []
    for i in range(n_shards):
        slots, per_list, rows = (slice(i * l, (i + 1) * l),
                                 slice(i * c, (i + 1) * c),
                                 slice(i * sc, (i + 1) * sc))
        st = ivf.IVFState(
            centroids=g.centroids,
            lists=g.lists[:, slots], list_ids=g.list_ids[:, slots],
            list_sizes=g.list_sizes[per_list],
            spill=g.spill[rows], spill_ids=g.spill_ids[rows],
            spill_size=g.spill_size[i:i + 1].reshape(()),
            num_deleted=g.num_deleted[i:i + 1].reshape(()))
        if g.q_lists is not None:
            st = st._replace(
                q_lists=g.q_lists[:, slots], q_scales=g.q_scales[per_list],
                q_zeros=g.q_zeros[per_list], q_norms=g.q_norms[:, slots],
                q_spill=g.q_spill[rows],
                q_spill_scales=g.q_spill_scales[rows],
                q_spill_zeros=g.q_spill_zeros[rows],
                q_spill_norms=g.q_spill_norms[rows])
        out.append(st)
    return out


# the axis each leaf's shards concatenate along in the global layout
# (None: replicated, stored once; "stack": per-shard scalars)
_GLOBAL_AXIS = {"centroids": None, "lists": 1, "list_ids": 1,
                "list_sizes": 0, "spill": 0, "spill_ids": 0,
                "spill_size": "stack", "num_deleted": "stack",
                "q_lists": 1, "q_scales": 0, "q_zeros": 0, "q_norms": 1,
                "q_spill": 0, "q_spill_scales": 0, "q_spill_zeros": 0,
                "q_spill_norms": 0}


def assemble_host(shards: Sequence[ivf.IVFState]) -> ivf.IVFState:
    """Shard-local states (host arrays or tensors) -> one IVFState of numpy
    arrays in the reference's global layout."""
    out = {}
    for f in ivf.IVFState._fields:
        leaves = [getattr(s, f) for s in shards]
        if leaves[0] is None:
            out[f] = None
            continue
        leaves = [_np(a) for a in leaves]
        axis = _GLOBAL_AXIS[f]
        out[f] = (leaves[0] if axis is None
                  else np.stack([a.reshape(()) for a in leaves])
                  if axis == "stack" else np.concatenate(leaves, axis=axis))
    return ivf.IVFState(**out)


def reshard_host(shards: Sequence[ivf.IVFState], cfg: EngineConfig,
                 mesh: ShardMesh, spill_capacity: int) -> ShardedState:
    """Re-pack saved shard-local states (host arrays or tensors) onto
    `mesh` (any shard count).

    Every live row of the saved shards (each shard's lists, then its
    spill, shard by shard) is dealt round-robin into ``mesh.size`` groups,
    and each group is inserted into an empty state on its shard's device
    against the saved centroids, as the reference's host reshard does:
    rows that overflow a group's lists land in its spill buffer, rows past
    its capacity are dropped."""
    rows_all, ids_all = [], []
    for st in shards:
        d = st.centroids.shape[1]
        rows = np.concatenate([_np(st.lists).reshape(-1, d), _np(st.spill)])
        ids = np.concatenate([_np(st.list_ids).reshape(-1),
                              _np(st.spill_ids)])
        live = ids >= 0
        rows_all.append(rows[live])
        ids_all.append(ids[live])
    rows = np.concatenate(rows_all)
    ids = np.concatenate(ids_all)
    cent = torch.from_numpy(np.array(_np(shards[0].centroids)))
    out = []
    n = mesh.size
    for i, dev in enumerate(mesh.devices):
        st = ivf.empty_state(cfg, spill_capacity, device=dev)._replace(
            centroids=_on(cent, dev))
        if len(ids[i::n]):
            st, _ = ivf.insert(
                st, torch.from_numpy(np.ascontiguousarray(rows[i::n])).to(dev),
                torch.from_numpy(np.ascontiguousarray(ids[i::n])).to(dev),
                cfg)
        out.append(st)
    return share_centroids(out)
