"""Tile-aligned IVF index, f32 tier; port of ``src/repro/core/index.py``.

The state layout is the reference's, field for field:

  centroids  : f32[C, D]
  lists      : f32[C, L, D]     dense padded lists
  list_ids   : i32[C, L]        external ids; -1 = empty/tombstoned slot
  list_sizes : i32[C]           high-water marks (tombstones not reclaimed
                                until rebuild, as in the paper's maintenance)
  spill_*    :                  fixed-capacity overflow buffer for rows whose
                                target list is full; drained at rebuild

so states cross between the packages through numpy (`repro_torch.convert`).
Every function keeps its tensors on the state's device.  Where the reference
donates a state to a jitted function, the port writes into it in place:
`insert`, `delete` and `replay` mutate the state they are given (its caller
must be the sole owner); `insert_shared` / `delete_shared` copy what they
write, so concurrent readers of the old state are unaffected.

The int8 store policy (``store_dtype="int8"``) is the next slice of the port;
its ``q_*`` fields stay ``None`` here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


class IVFState(NamedTuple):
    """IVF index state.  The eight required fields are the exact f32 tier;
    the optional ``q_*`` tail (the reference's int8 scan store) is always
    ``None`` in this slice of the port."""
    centroids: torch.Tensor      # f32[C, D]
    lists: torch.Tensor          # f32[C, L, D]
    list_ids: torch.Tensor       # i32[C, L]
    list_sizes: torch.Tensor     # i32[C]
    spill: torch.Tensor          # f32[S, D]
    spill_ids: torch.Tensor      # i32[S]
    spill_size: torch.Tensor     # i32[]
    num_deleted: torch.Tensor    # i32[]
    q_lists: Optional[torch.Tensor] = None
    q_scales: Optional[torch.Tensor] = None
    q_zeros: Optional[torch.Tensor] = None
    q_norms: Optional[torch.Tensor] = None
    q_spill: Optional[torch.Tensor] = None
    q_spill_scales: Optional[torch.Tensor] = None
    q_spill_zeros: Optional[torch.Tensor] = None
    q_spill_norms: Optional[torch.Tensor] = None

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def list_capacity(self) -> int:
        return self.lists.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lists.device


def _f32_only(cfg: EngineConfig) -> None:
    if cfg.quantized:
        raise NotImplementedError(
            "store_dtype='int8' is not ported yet: it is the int8 slice of "
            "the port (ROADMAP.md §1, with the scan_scores_q8 kernel)")


def empty_state(cfg: EngineConfig, spill_capacity: int = 4096, *,
                device: DeviceLike = None) -> IVFState:
    _f32_only(cfg)
    dev = resolve_device(device)
    c, l, d = cfg.n_clusters, cfg.list_capacity, cfg.dim
    return IVFState(
        centroids=torch.zeros((c, d), dtype=torch.float32, device=dev),
        lists=torch.zeros((c, l, d), dtype=torch.float32, device=dev),
        list_ids=torch.full((c, l), -1, dtype=torch.int32, device=dev),
        list_sizes=torch.zeros((c,), dtype=torch.int32, device=dev),
        spill=torch.zeros((spill_capacity, d), dtype=torch.float32,
                          device=dev),
        spill_ids=torch.full((spill_capacity,), -1, dtype=torch.int32,
                             device=dev),
        spill_size=torch.zeros((), dtype=torch.int32, device=dev),
        num_deleted=torch.zeros((), dtype=torch.int32, device=dev),
    )


def empty_host_state(cfg: EngineConfig, spill_capacity: int = 4096) -> IVFState:
    """Numpy mirror of `empty_state` — no device allocation (the byte
    accounting of `state_nbytes` reads it)."""
    _f32_only(cfg)
    c, l, d = cfg.n_clusters, cfg.list_capacity, cfg.dim
    return IVFState(
        centroids=np.zeros((c, d), np.float32),
        lists=np.zeros((c, l, d), np.float32),
        list_ids=np.full((c, l), -1, np.int32),
        list_sizes=np.zeros((c,), np.int32),
        spill=np.zeros((spill_capacity, d), np.float32),
        spill_ids=np.full((spill_capacity,), -1, np.int32),
        spill_size=np.zeros((), np.int32),
        num_deleted=np.zeros((), np.int32),
    )


def _leaves(state: IVFState):
    return [leaf for leaf in state if leaf is not None]


def state_nbytes(cfg: EngineConfig, spill_capacity: int = 4096) -> int:
    """Exact resident byte size of a collection state with these shapes
    (equals `footprint(state)["index_bytes"]` without allocating)."""
    return int(sum(leaf.nbytes
                   for leaf in _leaves(empty_host_state(cfg, spill_capacity))))


def live_count(state: IVFState) -> torch.Tensor:
    return (state.list_ids >= 0).sum() + (state.spill_ids >= 0).sum()


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def build(gen: torch.Generator, x: torch.Tensor, ids: torch.Tensor,
          cfg: EngineConfig,
          spill_capacity: int = 4096) -> Tuple[IVFState, torch.Tensor]:
    """Bulk-build an index over rows x f32[N, D] (ids i32[N]; -1 = ignore).

    k-means (GEMM kernels) -> pack rows into padded lists.  Returns
    (state, n_spilled).  Rows that overflow both their list and the spill
    buffer are dropped and counted.
    """
    from repro_torch.core.kmeans import kmeans as _kmeans

    _f32_only(cfg)
    centroids, assign = _kmeans(gen, x, ids >= 0, cfg)
    state = empty_state(cfg, spill_capacity,
                        device=x.device)._replace(centroids=centroids)
    return _pack(state, x, ids, assign, cfg)


def _scatter_lists(state: IVFState, x, ids, cl, offsets, ok) -> None:
    """Write rows where `ok` into their (cluster, offset) slots, in place.
    Rows that do not fit are selected out first: the reference's
    ``mode="drop"`` scatter has no PyTorch counterpart."""
    sel = ok.nonzero().squeeze(1)
    ci, oi = cl[sel].long(), offsets[sel].long()
    state.lists[ci, oi] = x[sel]
    state.list_ids[ci, oi] = ids[sel]
    state.list_sizes.add_(torch.bincount(
        ci, minlength=state.n_clusters).to(torch.int32))


def _append_spill(state: IVFState, x, ids, over) -> None:
    """Append the `over` rows to the spill buffer in place; rows past its
    capacity are dropped (and were counted by the caller)."""
    s_cap = state.spill.shape[0]
    spos = state.spill_size.long() + torch.cumsum(over.long(), 0) - 1
    sel = (over & (spos < s_cap)).nonzero().squeeze(1)
    state.spill[spos[sel]] = x[sel]
    state.spill_ids[spos[sel]] = ids[sel]
    state.spill_size.copy_(
        torch.clamp(state.spill_size + over.sum(), max=s_cap))


def _pack(state: IVFState, x: torch.Tensor, ids: torch.Tensor,
          assign: torch.Tensor,
          cfg: EngineConfig) -> Tuple[IVFState, torch.Tensor]:
    """Scatter assigned rows into padded lists; overflow goes to spill.
    Writes into `state` (a fresh one from `build`) in place."""
    l_cap = state.list_capacity
    c = state.n_clusters
    valid = ids >= 0
    cl = torch.where(valid, assign, c + 1).to(torch.int32)  # invalid sort last
    rank = _batch_ranks(cl)
    offsets = state.list_sizes[cl.clamp(0, c - 1).long()] + rank
    ok = valid & (cl >= 0) & (cl < c) & (offsets < l_cap)
    _scatter_lists(state, x, ids, cl, offsets, ok)
    over = valid & ~ok
    _append_spill(state, x, ids, over)
    return state, over.sum().to(torch.int32)


def rebuild(gen: torch.Generator, state: IVFState,
            cfg: EngineConfig) -> Tuple[IVFState, torch.Tensor]:
    """Full rebuild: drain lists + spill, re-cluster, re-pack.

    Reclaims tombstoned slots and drains the spill buffer (the paper's
    'index template' operation — large, latency-insensitive, GEMM-heavy).
    """
    rows, ids = _flat_rows(state)
    return build(gen, rows, ids, cfg, spill_capacity=state.spill.shape[0])


# ---------------------------------------------------------------------------
# Insert
# ---------------------------------------------------------------------------

def _batch_ranks(cl: torch.Tensor) -> torch.Tensor:
    """rank of row i among earlier batch rows assigned to the same cluster.

    Sort-based: stable-sort by cluster, position within the cluster run is
    arange - run_start.
    """
    b = cl.shape[0]
    rank = torch.zeros((b,), dtype=torch.int32, device=cl.device)
    if b == 0:
        return rank
    order = torch.argsort(cl, stable=True)
    sorted_cl = cl[order]
    first = torch.zeros((b,), dtype=torch.bool, device=cl.device)
    first[1:] = sorted_cl[1:] != sorted_cl[:-1]
    ar = torch.arange(b, device=cl.device)
    run_start = torch.cummax(torch.where(first, ar, 0), 0).values
    rank[order] = (ar - run_start).to(torch.int32)
    return rank


def _insert(state: IVFState, x: torch.Tensor, ids: torch.Tensor,
            cfg: EngineConfig, *, copy: bool) -> Tuple[IVFState, torch.Tensor]:
    """Insert rows x f32[B, D] with external ids i32[B].

    Assignment is the `kmeans_assign` GEMM kernel (the paper: inserts map to
    dense matmuls).  Returns (new_state, n_spilled_or_dropped i32[]).
    """
    _f32_only(cfg)
    l_cap = state.list_capacity
    cl, _ = ops.kmeans_assign(
        x, state.centroids, use_kernel=cfg.use_kernel,
        fused_conversion=cfg.fused_conversion)
    rank = _batch_ranks(cl)
    offsets = state.list_sizes[cl.long()] + rank
    fits = offsets < l_cap
    if copy:
        state = state._replace(
            lists=state.lists.clone(), list_ids=state.list_ids.clone(),
            list_sizes=state.list_sizes.clone(), spill=state.spill.clone(),
            spill_ids=state.spill_ids.clone(),
            spill_size=state.spill_size.clone())
    _scatter_lists(state, x, ids, cl, offsets, fits)
    over = ~fits
    _append_spill(state, x, ids, over)
    return state, over.sum().to(torch.int32)


def insert(state: IVFState, x: torch.Tensor, ids: torch.Tensor,
           cfg: EngineConfig) -> Tuple[IVFState, torch.Tensor]:
    """`_insert` in place: only for the state's sole owner (the reference
    donates the state here)."""
    return _insert(state, x, ids, cfg, copy=False)


def insert_shared(state: IVFState, x: torch.Tensor, ids: torch.Tensor,
                  cfg: EngineConfig) -> Tuple[IVFState, torch.Tensor]:
    """`_insert` on copies: safe while concurrent readers hold `state`."""
    return _insert(state, x, ids, cfg, copy=True)


# ---------------------------------------------------------------------------
# Delete (tombstoning)
# ---------------------------------------------------------------------------

def _delete(state: IVFState, ids: torch.Tensor, *,
            copy: bool) -> Tuple[IVFState, torch.Tensor]:
    """Tombstone `ids` i32[B]; slots are reclaimed at the next rebuild.

    Returns (new_state, n_hit i32[]) where n_hit counts the slots actually
    tombstoned — ids not present in the index contribute nothing, so callers
    tracking tombstone pressure stay truthful.  One `isin` per tier takes
    the place of the reference's loop over ids.
    """
    ids = ids.to(state.list_ids.device)
    l_hit = torch.isin(state.list_ids, ids)
    s_hit = torch.isin(state.spill_ids, ids)
    n = (l_hit.sum() + s_hit.sum()).to(torch.int32)
    if copy:
        list_ids = state.list_ids.masked_fill(l_hit, -1)
        spill_ids = state.spill_ids.masked_fill(s_hit, -1)
    else:
        list_ids = state.list_ids.masked_fill_(l_hit, -1)
        spill_ids = state.spill_ids.masked_fill_(s_hit, -1)
    new = state._replace(list_ids=list_ids, spill_ids=spill_ids,
                         num_deleted=state.num_deleted + n)
    return new, n


def delete(state: IVFState, ids: torch.Tensor) -> Tuple[IVFState, torch.Tensor]:
    """`_delete` in place: only for the state's sole owner."""
    return _delete(state, ids, copy=False)


def delete_shared(state: IVFState,
                  ids: torch.Tensor) -> Tuple[IVFState, torch.Tensor]:
    """`_delete` on copies: safe while concurrent readers hold `state`."""
    return _delete(state, ids, copy=True)


# ---------------------------------------------------------------------------
# Delta replay (lost-update-safe rebuilds)
# ---------------------------------------------------------------------------

class DeltaOp(NamedTuple):
    """One logged write applied to a collection since a rebuild snapshot.

    kind: "insert" | "delete".  For inserts `rows` is f32[B, D] and `ids`
    i32[B]; for deletes `rows` is None and `ids` the tombstoned ids.  Ops
    are appended under the collection's writer lock, so log order is
    exactly state-application order — replaying the log onto a rebuilt
    snapshot reproduces the live state.
    """
    kind: str
    rows: Optional[torch.Tensor]
    ids: torch.Tensor


def replay_insert(state: IVFState, rows: torch.Tensor, ids: torch.Tensor,
                  cfg: EngineConfig) -> Tuple[IVFState, torch.Tensor]:
    """Re-apply one logged insert to a sole-owner state (in place)."""
    return insert(state, rows, ids, cfg)


def replay_delete(state: IVFState,
                  ids: torch.Tensor) -> Tuple[IVFState, torch.Tensor]:
    """Re-apply one logged delete to a sole-owner state (in place)."""
    return delete(state, ids)


def replay(state: IVFState, log, cfg: EngineConfig) -> Tuple[IVFState, int, int]:
    """Re-apply a delta log (list of `DeltaOp`) in order to `state`.

    The caller must be the state's sole owner (e.g. the freshly rebuilt
    index before its swap): replay writes into it in place.  Returns
    (state, n_spilled, n_tombstoned) — rows the replayed inserts pushed to
    the spill buffer and slots the replayed deletes tombstoned, both still
    pending in the replayed state.
    """
    # accumulate device scalars and sync once at the end, not once per op
    spilled = torch.zeros((), dtype=torch.int32, device=state.device)
    tombstoned = torch.zeros((), dtype=torch.int32, device=state.device)
    for op in log:
        if op.kind == "insert":
            state, s = replay_insert(state, op.rows, op.ids, cfg)
            spilled = spilled + s
        elif op.kind == "delete":
            state, n = replay_delete(state, op.ids)
            tombstoned = tombstoned + n
        else:
            raise ValueError(f"unknown delta op kind {op.kind!r}")
    return state, int(spilled), int(tombstoned)


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------

def _flat_rows(state: IVFState) -> Tuple[torch.Tensor, torch.Tensor]:
    c, l, d = state.lists.shape
    rows = torch.cat([state.lists.reshape(c * l, d), state.spill], dim=0)
    ids = torch.cat([state.list_ids.reshape(c * l), state.spill_ids], dim=0)
    return rows, ids


def flat_rows_host(state: IVFState) -> Tuple[np.ndarray, np.ndarray]:
    """Host (rows f32[N, D], ids[N]) view of every slot — list tier then
    spill.  ids < 0 mark empty/tombstoned slots; callers mask."""
    rows, ids = _flat_rows(state)
    return rows.cpu().numpy(), ids.cpu().numpy()


def _metric_norms(rows: torch.Tensor, metric: str) -> Optional[torch.Tensor]:
    if metric == "l2":
        return (rows.float() ** 2).sum(1)
    return None


def _order_scores(scores: torch.Tensor, metric: str) -> torch.Tensor:
    # topk maximizes; the l2 path returns distances (smaller better) -> negate
    return -scores if metric == "l2" else scores


def _scan(q, rows, ids, cfg: EngineConfig) -> torch.Tensor:
    return ops.scan_scores(
        q, rows, ids, _metric_norms(rows, cfg.metric), metric=cfg.metric,
        use_kernel=cfg.use_kernel, fused_conversion=cfg.fused_conversion)


def query_full_scan(state: IVFState, q: torch.Tensor, cfg: EngineConfig,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Throughput template: fused GEMM scan of the whole database.

    Returns (ids i32[B, k], scores f32[B, k]); l2 scores are negated
    distances, as in the reference.
    """
    _f32_only(cfg)
    rows, ids = _flat_rows(state)
    scores = _scan(q, rows, ids, cfg)
    top, idx = torch.topk(_order_scores(scores, cfg.metric), k, dim=1)
    return ids[idx], top


def query_full_scan_rows(state: IVFState, q: torch.Tensor, cfg: EngineConfig,
                         k: int):
    """Like query_full_scan but also returns the vectors f32[B, k, D]."""
    _f32_only(cfg)
    rows, ids = _flat_rows(state)
    scores = _scan(q, rows, ids, cfg)
    top, idx = torch.topk(_order_scores(scores, cfg.metric), k, dim=1)
    return ids[idx], top, rows[idx]


def query_probed(state: IVFState, q: torch.Tensor, cfg: EngineConfig,
                 k: int, nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latency template: IVF probe path for small query batches.

    Centroid scores are one small scan; each query then gathers its nprobe
    lists (contiguous slabs) plus the spill buffer and runs one fused scan
    over [nprobe*L + spill] rows, query by query to bound the working set.
    """
    _f32_only(cfg)
    c, l, d = state.lists.shape
    # clamp so topk's k <= axis holds even when a caller asks for more
    # probes than there are clusters
    nprobe = max(1, min(nprobe, c))
    cvalid = torch.arange(c, dtype=torch.int32, device=state.device)
    cscores = _scan(q, state.centroids, cvalid, cfg)
    probes = torch.topk(_order_scores(cscores, cfg.metric), nprobe,
                        dim=1).indices
    s_cap = state.spill.shape[0]
    out_ids, out_scores = [], []
    for i in range(q.shape[0]):
        pi = probes[i]
        rows = torch.empty((nprobe * l + s_cap, d), dtype=torch.float32,
                           device=state.device)
        torch.index_select(state.lists, 0, pi,
                           out=rows[:nprobe * l].view(nprobe, l, d))
        rows[nprobe * l:] = state.spill
        rids = torch.cat([state.list_ids[pi].reshape(nprobe * l),
                          state.spill_ids])
        s = _scan(q[i:i + 1], rows, rids, cfg)
        top, idx = torch.topk(_order_scores(s, cfg.metric)[0], k)
        out_ids.append(rids[idx])
        out_scores.append(top)
    if not out_ids:
        return (torch.empty((0, k), dtype=torch.int32, device=state.device),
                torch.empty((0, k), dtype=torch.float32, device=state.device))
    return torch.stack(out_ids), torch.stack(out_scores)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

def footprint(state: IVFState) -> dict:
    """Resident-size accounting for the scan store (f32 tier: 4 bytes per
    component, streamed and stored)."""
    return {
        "bytes_per_row": state.dim * 4,
        "scan_bytes_per_row": state.dim * 4,
        "index_bytes": sum(int(leaf.numel()) * leaf.element_size()
                           for leaf in _leaves(state)),
        "store_dtype": "float32",
    }


def stats(state: IVFState) -> dict:
    sizes = state.list_sizes.cpu().numpy()
    return {
        "n_clusters": state.n_clusters,
        "dim": state.dim,
        "list_capacity": state.list_capacity,
        "live": int(live_count(state)),
        "spill": int(state.spill_size),
        "deleted": int(state.num_deleted),
        "max_list": int(sizes.max()),
        "mean_list": float(sizes.mean()),
        **footprint(state),
    }
