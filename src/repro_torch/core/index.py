"""Tile-aligned IVF index; port of ``src/repro/core/index.py``.

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

Under the int8 store policy (``store_dtype="int8"``) the optional ``q_*``
fields hold the affine int8 scan store; queries scan it with the
``scan_scores_q8`` kernel and rescore the top ``rescore_k`` rows exactly in
f32 from the lists.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.core.spans import span
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


class IVFState(NamedTuple):
    """IVF index state.  The eight required fields are the exact f32 tier.
    The optional ``q_*`` tail is the int8 quantized scan store, present iff
    the collection's ``EngineConfig.store_dtype == "int8"``: per-list affine
    codes for the lists tier, per-row codes for the spill tier, and the
    dequantized rows' norms (so l2 coarse scans never read the f32 rows)."""
    centroids: torch.Tensor      # f32[C, D]
    lists: torch.Tensor          # f32[C, L, D]
    list_ids: torch.Tensor       # i32[C, L]
    list_sizes: torch.Tensor     # i32[C]
    spill: torch.Tensor          # f32[S, D]
    spill_ids: torch.Tensor      # i32[S]
    spill_size: torch.Tensor     # i32[]
    num_deleted: torch.Tensor    # i32[]
    q_lists: Optional[torch.Tensor] = None         # i8[C, L, D]
    q_scales: Optional[torch.Tensor] = None        # f32[C] per-list scale
    q_zeros: Optional[torch.Tensor] = None         # f32[C] per-list zero
    q_norms: Optional[torch.Tensor] = None         # f32[C, L] dequant norms
    q_spill: Optional[torch.Tensor] = None         # i8[S, D]
    q_spill_scales: Optional[torch.Tensor] = None  # f32[S] per-row scale
    q_spill_zeros: Optional[torch.Tensor] = None   # f32[S] per-row zero
    q_spill_norms: Optional[torch.Tensor] = None   # f32[S] dequant norms

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

    @property
    def quantized(self) -> bool:
        return self.q_lists is not None


def empty_state(cfg: EngineConfig, spill_capacity: int = 4096, *,
                device: DeviceLike = None) -> IVFState:
    dev = resolve_device(device)
    c, l, d = cfg.n_clusters, cfg.list_capacity, cfg.dim
    state = IVFState(
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
    if cfg.quantized:
        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)
        state = state._replace(
            q_lists=full((c, l, d), 0, torch.int8),
            q_scales=full((c,), 1.0, torch.float32),
            q_zeros=full((c,), 0.0, torch.float32),
            q_norms=full((c, l), 0.0, torch.float32),
            q_spill=full((spill_capacity, d), 0, torch.int8),
            q_spill_scales=full((spill_capacity,), 1.0, torch.float32),
            q_spill_zeros=full((spill_capacity,), 0.0, torch.float32),
            q_spill_norms=full((spill_capacity,), 0.0, torch.float32),
        )
    return state


def empty_host_state(cfg: EngineConfig, spill_capacity: int = 4096) -> IVFState:
    """Numpy mirror of `empty_state` — no device allocation (the restore
    template of save/load and the byte accounting of `state_nbytes`)."""
    c, l, d = cfg.n_clusters, cfg.list_capacity, cfg.dim
    state = IVFState(
        centroids=np.zeros((c, d), np.float32),
        lists=np.zeros((c, l, d), np.float32),
        list_ids=np.full((c, l), -1, np.int32),
        list_sizes=np.zeros((c,), np.int32),
        spill=np.zeros((spill_capacity, d), np.float32),
        spill_ids=np.full((spill_capacity,), -1, np.int32),
        spill_size=np.zeros((), np.int32),
        num_deleted=np.zeros((), np.int32),
    )
    if cfg.quantized:
        state = state._replace(
            q_lists=np.zeros((c, l, d), np.int8),
            q_scales=np.ones((c,), np.float32),
            q_zeros=np.zeros((c,), np.float32),
            q_norms=np.zeros((c, l), np.float32),
            q_spill=np.zeros((spill_capacity, d), np.int8),
            q_spill_scales=np.ones((spill_capacity,), np.float32),
            q_spill_zeros=np.zeros((spill_capacity,), np.float32),
            q_spill_norms=np.zeros((spill_capacity,), np.float32),
        )
    return state


_Q_FIELDS = tuple(f for f in IVFState._fields if f.startswith("q_"))


def _leaves(state: IVFState):
    return [leaf for leaf in state if leaf is not None]


def state_nbytes(cfg: EngineConfig, spill_capacity: int = 4096,
                 n_shards: int = 1) -> int:
    """Exact resident byte size of a collection state with these shapes
    (equals `footprint(state)["index_bytes"]` without allocating).  A
    sharded state holds the centroids once and every other leaf once per
    shard (`distributed.empty_dist_state`)."""
    t = empty_host_state(cfg, spill_capacity)
    total = sum(leaf.nbytes for leaf in _leaves(t))
    cent = t.centroids.nbytes
    return int(cent + n_shards * (total - cent))


def live_count(state: IVFState) -> torch.Tensor:
    return (state.list_ids >= 0).sum() + (state.spill_ids >= 0).sum()


# ---------------------------------------------------------------------------
# Int8 quantized scan store (store_dtype == "int8")
#
# Affine quantization, as in the reference: row ~= scale * code + zero with
# codes in [-127, 127], scale/zero shared per IVF list (lists tier) or per
# row (spill tier).  The f32 rows stay the source of truth; the quantized
# store is a derived coarse-scan stream, re-derived for exactly the lists
# and spill rows each write touches.  The port re-derives in place, a chunk
# of lists at a time, so no temporary holds more than _QUANT_CHUNK_BYTES of
# f32 rows (the reference gathers one slab per inserted row at once).
# ---------------------------------------------------------------------------

_QUANT_CHUNK_BYTES = 1 << 28


def _affine_encode(x: torch.Tensor, dims: Tuple[int, ...]):
    """(codes i8, scale, zero) with x ~= scale*codes + zero over `dims`."""
    mn = x.amin(dim=dims)
    mx = x.amax(dim=dims)
    zero = 0.5 * (mn + mx)
    scale = torch.clamp((mx - mn) / 254.0, min=1e-8)
    bshape = scale.shape + (1,) * len(dims)
    codes = torch.clamp(torch.round((x - zero.reshape(bshape))
                                    / scale.reshape(bshape)), -127, 127)
    return codes.to(torch.int8), scale, zero


def _quantize_lists(lists: torch.Tensor, list_ids: torch.Tensor):
    """Per-list affine quantization of [..., L, D] slabs.  Empty and
    tombstoned slots are masked to 0 for the range fit; returns (codes,
    scale, zero, norms) with the DEQUANTIZED rows' norms."""
    masked = torch.where((list_ids >= 0)[..., None], lists, 0.0)
    codes, scale, zero = _affine_encode(masked, (-2, -1))
    deq = codes.float() * scale[..., None, None] + zero[..., None, None]
    return codes, scale, zero, (deq * deq).sum(-1)


def _quantize_rows(rows: torch.Tensor, ids: torch.Tensor):
    """Per-row affine quantization of [..., D] rows (the spill tier)."""
    masked = torch.where((ids >= 0)[..., None], rows, 0.0)
    codes, scale, zero = _affine_encode(masked, (-1,))
    deq = codes.float() * scale[..., None] + zero[..., None]
    return codes, scale, zero, (deq * deq).sum(-1)


def _requantize_lists(state: IVFState,
                      touched: Optional[torch.Tensor] = None) -> None:
    """Re-derive the int8 store of the distinct lists `touched` (every list
    when None) in place, a chunk of lists at a time."""
    c, l, d = state.lists.shape
    step = max(1, _QUANT_CHUNK_BYTES // (l * d * 4))
    total = c if touched is None else touched.numel()
    for i in range(0, total, step):
        sel = (slice(i, min(i + step, c)) if touched is None
               else touched[i:i + step])
        codes, sc, zr, nrm = _quantize_lists(state.lists[sel],
                                             state.list_ids[sel])
        state.q_lists[sel] = codes
        state.q_scales[sel] = sc
        state.q_zeros[sel] = zr
        state.q_norms[sel] = nrm


def _write_spill_codes(state: IVFState, rows: torch.Tensor,
                       ids: torch.Tensor, pos) -> None:
    """Per-row encode of spill `rows` into slots `pos` (indices or a
    slice), in place."""
    codes, sc, zr, nrm = _quantize_rows(rows, ids)
    state.q_spill[pos] = codes
    state.q_spill_scales[pos] = sc
    state.q_spill_zeros[pos] = zr
    state.q_spill_norms[pos] = nrm


def _quantize_state(state: IVFState) -> None:
    """Full requantization of every tier (build / rebuild / pack time)."""
    _requantize_lists(state)
    _write_spill_codes(state, state.spill, state.spill_ids, slice(None))


def _requantize_touched(state: IVFState, x: torch.Tensor,
                        clusters: torch.Tensor, rows: torch.Tensor,
                        spos: torch.Tensor) -> None:
    """Incremental coherence after an insert batch, in place: re-derive the
    lists the rows landed in (`clusters`, one per written row; duplicates
    give identical values, so each distinct list is encoded once) and
    encode the appended spill rows x[rows] at their slots `spos`.  Deletes
    need no counterpart: they only flip ids, and every scan masks ids < 0.
    """
    with span("ame.index.insert.requantize"):
        _requantize_lists(state, torch.unique(clusters))
        _write_spill_codes(state, x[rows],
                           torch.zeros(rows.shape[0], dtype=torch.int32,
                                       device=x.device), spos)


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

    centroids, assign = _kmeans(gen, x, ids >= 0, cfg)
    state = empty_state(cfg, spill_capacity,
                        device=x.device)._replace(centroids=centroids)
    return _pack(state, x, ids, assign, cfg)


def _scatter_lists(state: IVFState, x, ids, cl, offsets,
                   ok) -> torch.Tensor:
    """Write rows where `ok` into their (cluster, offset) slots, in place;
    returns the cluster of each written row.  Rows that do not fit are
    selected out first: the reference's ``mode="drop"`` scatter has no
    PyTorch counterpart."""
    sel = ok.nonzero().squeeze(1)
    ci, oi = cl[sel].long(), offsets[sel].long()
    state.lists[ci, oi] = x[sel]
    state.list_ids[ci, oi] = ids[sel]
    state.list_sizes.add_(torch.bincount(
        ci, minlength=state.n_clusters).to(torch.int32))
    return ci


def _append_spill(state: IVFState, x, ids,
                  over) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append the `over` rows to the spill buffer in place; rows past its
    capacity are dropped (and were counted by the caller).  Returns (rows
    of x written, their spill slots)."""
    s_cap = state.spill.shape[0]
    spos = state.spill_size.long() + torch.cumsum(over.long(), 0) - 1
    sel = (over & (spos < s_cap)).nonzero().squeeze(1)
    state.spill[spos[sel]] = x[sel]
    state.spill_ids[spos[sel]] = ids[sel]
    state.spill_size.copy_(
        torch.clamp(state.spill_size + over.sum(), max=s_cap))
    return sel, spos[sel]


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
    if cfg.quantized:
        _quantize_state(state)
    return state, over.sum().to(torch.int32)


def rebuild(gen: torch.Generator, state: IVFState,
            cfg: EngineConfig) -> Tuple[IVFState, torch.Tensor]:
    """Full rebuild: drain lists + spill, re-cluster, re-pack.

    Reclaims tombstoned slots and drains the spill buffer (the paper's
    'index template' operation — large, latency-insensitive, GEMM-heavy).
    """
    with span("ame.index.rebuild.flat_copy"):
        rows, ids = _flat_rows(state)
    with span("ame.index.rebuild.cluster"):
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
    l_cap = state.list_capacity
    cl, _ = ops.kmeans_assign(
        x, state.centroids, use_kernel=cfg.use_kernel,
        fused_conversion=cfg.fused_conversion)
    rank = _batch_ranks(cl)
    offsets = state.list_sizes[cl.long()] + rank
    fits = offsets < l_cap
    if copy:
        state = own_insert_fields(state, cfg)
    touched = _scatter_lists(state, x, ids, cl, offsets, fits)
    over = ~fits
    rows, spos = _append_spill(state, x, ids, over)
    if cfg.quantized:
        _requantize_touched(state, x, touched, rows, spos)
    return state, over.sum().to(torch.int32)


def own_insert_fields(state: IVFState, cfg: EngineConfig) -> IVFState:
    """`state` with a copy of every field an insert writes, the int8
    store's included: an in-place insert into the result leaves every
    reader of `state` unaffected."""
    written = ("lists", "list_ids", "list_sizes", "spill", "spill_ids",
               "spill_size") + (_Q_FIELDS if cfg.quantized else ())
    with span("ame.index.insert.clone"):
        return state._replace(**{f: getattr(state, f).clone()
                                 for f in written})


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
    with span("ame.index.delete.mask"):
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

# The flat views and the rescore below are lane-aware: on a stacked state
# (every leaf with a leading lane axis G, see `stack_states`) they
# concatenate along the slot axis per lane and return [G, ...] results.

def stack_states(states) -> IVFState:
    """Stack G same-shaped states along a new leading lane axis (leaf by
    leaf; the int8 store's leaves are None under the f32 policy and stay
    None): the stacked state the lane-aware templates below take."""
    return IVFState(*[None if leaves[0] is None else torch.stack(leaves)
                      for leaves in zip(*states)])


def _flat_ids(state: IVFState) -> torch.Tensor:
    return torch.cat([state.list_ids.flatten(-2), state.spill_ids], dim=-1)


def _flat_rows(state: IVFState) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = torch.cat([state.lists.flatten(-3, -2), state.spill], dim=-2)
    return rows, _flat_ids(state)


def flat_rows_host(state: IVFState) -> Tuple[np.ndarray, np.ndarray]:
    """Host (rows f32[N, D], ids i32[N]) copy of every slot — list tier then
    spill.  ids < 0 mark empty/tombstoned slots; callers mask.

    Each leaf is copied to the host on its own, straight into its place in
    the result, so no device temporary of the whole state is made (the
    device-side `_flat_rows` concatenates)."""
    n_list = state.lists.shape[0] * state.lists.shape[1]
    n = n_list + state.spill.shape[0]
    rows = np.empty((n, state.dim), np.float32)
    ids = np.empty((n,), np.int32)
    for out, lists, spill in ((rows, state.lists.flatten(0, 1), state.spill),
                              (ids, state.list_ids.flatten(), state.spill_ids)):
        torch.from_numpy(out[:n_list]).copy_(lists)
        torch.from_numpy(out[n_list:]).copy_(spill)
    return rows, ids


def _metric_norms(rows: torch.Tensor, metric: str) -> Optional[torch.Tensor]:
    if metric == "l2":
        return (rows.float() ** 2).sum(-1)
    return None


def _order_scores(scores: torch.Tensor, metric: str) -> torch.Tensor:
    # topk maximizes; the l2 path returns distances (smaller better) -> negate
    return -scores if metric == "l2" else scores


def _scan(q, rows, ids, cfg: EngineConfig, rows2=None,
          ids2=None) -> torch.Tensor:
    """Scores of q against `rows` (ids), then against a second segment
    `rows2` (ids2) if given, in one launch."""
    norms2 = None if rows2 is None else _metric_norms(rows2, cfg.metric)
    return ops.scan_scores(
        q, rows, ids, _metric_norms(rows, cfg.metric), metric=cfg.metric,
        use_kernel=cfg.use_kernel, fused_conversion=cfg.fused_conversion,
        db2=rows2, ids2=ids2, db2_norms=norms2)


# --- int8 asymmetric two-stage query (coarse quantized scan -> f32 rescore)

def _flat_codes(state: IVFState):
    """Quantized analogue of `_flat_rows`: the int8 coarse-scan stream with
    per-row-expanded scale/zero/norm sidebands (the lists tier repeats its
    per-list scalars over L slots; the spill tier is already per-row)."""
    l = state.q_lists.shape[-2]
    codes = torch.cat([state.q_lists.flatten(-3, -2), state.q_spill], dim=-2)
    scales = torch.cat([state.q_scales.repeat_interleave(l, dim=-1),
                        state.q_spill_scales], dim=-1)
    zeros = torch.cat([state.q_zeros.repeat_interleave(l, dim=-1),
                       state.q_spill_zeros], dim=-1)
    norms = torch.cat([state.q_norms.flatten(-2), state.q_spill_norms],
                      dim=-1)
    return codes, scales, zeros, norms


def _lane_index(state: IVFState, idx: torch.Tensor) -> tuple:
    """The leading index that makes `leaf[(*lane, idx)]` read lane g's own
    slots for idx [G, ...] of a stacked state; () for one collection."""
    if state.lists.dim() == 3:
        return ()
    g = state.lists.shape[0]
    return (torch.arange(g, device=idx.device).view(
        g, *([1] * (idx.dim() - 1))),)


def _take(state: IVFState, flat: torch.Tensor, idx: torch.Tensor):
    """flat[idx] per lane: `flat` [(G,) N(, D)] indexed along its slot axis
    by idx [(G,) ...]."""
    return flat[(*_lane_index(state, idx), idx)]


def _take_tiers(state: IVFState, tier1: torch.Tensor, tier2: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """`_take` of the list tier's flat leaf `tier1` [(G,) C*L(, D)] and the
    spill tier's `tier2` [(G,) S(, D)] as one slot axis (`_flat_rows`
    order), without concatenating them."""
    lane = _lane_index(state, idx)
    n1, n2 = tier1.shape[len(lane)], tier2.shape[len(lane)]
    first = tier1[(*lane, idx.clamp(0, n1 - 1))]
    if n2 == 0:
        return first
    second = tier2[(*lane, (idx - n1).clamp(0, n2 - 1))]
    spilled = (idx >= n1).view(*idx.shape, *[1] * (first.dim() - idx.dim()))
    return torch.where(spilled, second, first)


def _gather_flat_rows(state: IVFState, cand: torch.Tensor) -> torch.Tensor:
    """f32 rows for flat candidate indices [(G,) ..., R] (lists first, then
    spill — `_flat_rows` order) without materialising the flat copy."""
    return _take_tiers(state, _list_tier(state)[0], state.spill, cand)


def _rescore_topk(q: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
                  metric: str, k: int):
    """Exact f32 rescore of candidate rows f32[(G,) B, R, D] -> top-k.

    An elementwise product and a sum, never a matrix product, so it stays
    exact f32 whatever the global TF32 flag says: the rescore exists to
    erase the coarse tier's quantization error.  Returns (ids, scores,
    rows) at the final k.
    """
    s = (rows * q.float()[..., None, :]).sum(-1)
    if metric == "l2":
        s = (rows * rows).sum(-1) - 2.0 * s
    mask_val = float("inf") if metric == "l2" else float("-inf")
    s = torch.where(ids >= 0, s, mask_val)
    top, ii = torch.topk(_order_scores(s, metric), k, dim=-1)
    return (ids.gather(-1, ii), top,
            torch.take_along_dim(rows, ii[..., None], dim=-2))


def _rescore_r(cfg: EngineConfig, k: int, n: int) -> int:
    """Coarse-survivor count: rescore_k clamped to [k, n]."""
    return min(max(cfg.rescore_k, k), n)


def _scan_q8(q, codes, ids, scales, zeros, norms, cfg: EngineConfig):
    return ops.scan_scores_q8(
        q, codes, ids, scales, zeros, norms if cfg.metric == "l2" else None,
        metric=cfg.metric, use_kernel=cfg.use_kernel)


def _query_full_scan_q8(state: IVFState, q: torch.Tensor, cfg: EngineConfig,
                        k: int):
    """Two-stage full scan: int8 coarse scan over every row, exact f32
    rescore of the top `rescore_k` survivors (the f32 tier is touched only
    for B * rescore_k gathered rows)."""
    with span("ame.index.full_scan.flat_copy"):
        codes, scales, zeros, norms = _flat_codes(state)
        ids = _flat_ids(state)
    with span("ame.index.full_scan.scan"):
        coarse = _scan_q8(q, codes, ids, scales, zeros, norms, cfg)
        r = _rescore_r(cfg, k, codes.shape[-2])
        del codes, scales, zeros, norms
        cand = torch.topk(_order_scores(coarse, cfg.metric), r,
                          dim=-1).indices
        rows = _gather_flat_rows(state, cand)
        return _rescore_topk(q, rows, _take(state, ids, cand), cfg.metric, k)


def _list_tier(state: IVFState) -> Tuple[torch.Tensor, torch.Tensor]:
    """The list tier's rows [(G,) C*L, D] and ids [(G,) C*L]: views of the
    store, the first of a full scan's two segments (the spill tier, rows
    and ids, is the second)."""
    return state.lists.flatten(-3, -2), state.list_ids.flatten(-2)


def query_full_scan(state: IVFState, q: torch.Tensor, cfg: EngineConfig,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Throughput template: fused GEMM scan of the whole database, the
    list tier and the spill tier read where they lie (one launch, two
    segments of rows).

    Returns (ids i32[B, k], scores f32[B, k]); l2 scores are negated
    distances, as in the reference.  Under the int8 store policy this is
    the two-stage pipeline: quantized coarse scan, then an exact f32
    rescore of the top `cfg.rescore_k`.  On a stacked state (q f32[G, B,
    D]) every lane is answered by one lane scan: (ids, scores) [G, B, k].
    """
    if cfg.quantized:
        out_ids, top, _ = _query_full_scan_q8(state, q, cfg, k)
        return out_ids, top
    with span("ame.index.full_scan.flat_copy"):
        rows, ids = _list_tier(state)
    with span("ame.index.full_scan.scan"):
        scores = _scan(q, rows, ids, cfg, state.spill, state.spill_ids)
        top, idx = torch.topk(_order_scores(scores, cfg.metric), k, dim=-1)
        return _take_tiers(state, ids, state.spill_ids, idx), top


def query_full_scan_rows(state: IVFState, q: torch.Tensor, cfg: EngineConfig,
                         k: int):
    """Like query_full_scan but also returns the vectors f32[B, k, D]
    (under the int8 policy the exact f32 rows, never dequantized ones)."""
    if cfg.quantized:
        return _query_full_scan_q8(state, q, cfg, k)
    with span("ame.index.full_scan.flat_copy"):
        rows, ids = _list_tier(state)
    with span("ame.index.full_scan.scan"):
        scores = _scan(q, rows, ids, cfg, state.spill, state.spill_ids)
        top, idx = torch.topk(_order_scores(scores, cfg.metric), k, dim=1)
        return (_take_tiers(state, ids, state.spill_ids, idx), top,
                _gather_flat_rows(state, idx))


def query_probed(state: IVFState, q: torch.Tensor, cfg: EngineConfig,
                 k: int, nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latency template: IVF probe path for small query batches.

    Centroid scores are one small scan; each query then gathers its nprobe
    lists (contiguous slabs) plus the spill buffer and runs one fused scan
    over [nprobe*L + spill] rows, query by query to bound the working set
    (the reference's `lax.map`).  Under the int8 policy the probed slabs
    stream as int8 codes with their per-list scalars, and the survivors
    are rescored in f32.

    On a stacked state (every leaf with a leading lane axis G, q f32[G, B,
    D]) each of those scans is one lane launch for all G collections —
    1 + B launches — and (ids, scores) are [G, B, k]; a single collection
    is the G = 1 case.
    """
    with span("ame.index.probed"):
        if state.lists.dim() == 3:
            ids, scores = _query_probed_lanes(
                IVFState(*[None if t is None else t[None] for t in state]),
                q[None], cfg, k, nprobe)
            return ids[0], scores[0]
        return _query_probed_lanes(state, q, cfg, k, nprobe)


def _query_probed_lanes(state: IVFState, q: torch.Tensor, cfg: EngineConfig,
                        k: int, nprobe: int):
    """`query_probed` on a stacked state (every leaf with its lane axis)."""
    g, c, l, _ = state.lists.shape
    # clamp so topk's k <= axis holds even when a caller asks for more
    # probes than there are clusters
    nprobe = max(1, min(nprobe, c))
    cvalid = torch.arange(c, dtype=torch.int32,
                          device=state.device).expand(g, c).contiguous()
    cscores = _scan(q, state.centroids, cvalid, cfg)
    probes = torch.topk(_order_scores(cscores, cfg.metric), nprobe,
                        dim=-1).indices
    out_ids, out_scores = [], []
    for i in range(q.shape[1]):
        pi = probes[:, i]                                  # [G, nprobe]
        qi = q[:, i:i + 1].contiguous()                    # [G, 1, D]
        if cfg.quantized:
            ids_i, top = _probe_q8(state, qi, pi, cfg, k)
        else:
            rows = _gather_slabs(state.lists, pi, state.spill)
            rids = _gather_slabs(state.list_ids, pi, state.spill_ids)
            s = _scan(qi, rows, rids, cfg)[:, 0]
            del rows
            top, idx = torch.topk(_order_scores(s, cfg.metric), k, dim=-1)
            ids_i = rids.gather(1, idx)
        out_ids.append(ids_i)
        out_scores.append(top)
    if not out_ids:
        return (torch.empty((g, 0, k), dtype=torch.int32, device=state.device),
                torch.empty((g, 0, k), dtype=torch.float32,
                            device=state.device))
    return torch.stack(out_ids, 1), torch.stack(out_scores, 1)


def _gather_slabs(src: torch.Tensor, pi: torch.Tensor,
                  tail: torch.Tensor) -> torch.Tensor:
    """[G, nprobe * L + S, ...]: lane g's probed lists src[g][pi[g]] as
    contiguous slabs, then its spill-tier `tail[g]` (src [G, C, L, ...],
    pi [G, nprobe], tail [G, S, ...]); one copy of each."""
    g, nprobe = pi.shape
    l, inner = src.shape[2], src.shape[3:]
    with span("ame.index.probed.gather"):
        out = torch.empty((g, nprobe * l + tail.shape[1], *inner),
                          dtype=src.dtype, device=src.device)
        for j in range(g):
            torch.index_select(src[j], 0, pi[j],
                               out=out[j, :nprobe * l].view(nprobe, l, *inner))
        out[:, nprobe * l:] = tail
        return out


def _probe_q8(state: IVFState, qi: torch.Tensor, pi: torch.Tensor,
              cfg: EngineConfig, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query per lane, qi f32[G, 1, D], over lane g's probed lists
    pi[g] and its spill: int8 coarse scan, then the survivors' f32 rows
    (probed-slab indices map through pi) rescored exactly.  Returns (ids
    i32[G, k], scores f32[G, k])."""
    g, _, l, _ = state.lists.shape
    n_probe_rows = pi.shape[1] * l
    codes = _gather_slabs(state.q_lists, pi, state.q_spill)
    rids = _gather_slabs(state.list_ids, pi, state.spill_ids)
    norms = _gather_slabs(state.q_norms, pi, state.q_spill_norms)
    scales = torch.cat([state.q_scales.gather(1, pi).repeat_interleave(
        l, dim=1), state.q_spill_scales], dim=1)
    zeros = torch.cat([state.q_zeros.gather(1, pi).repeat_interleave(
        l, dim=1), state.q_spill_zeros], dim=1)
    s = _scan_q8(qi, codes, rids, scales, zeros, norms, cfg)    # [G, 1, N]
    r = _rescore_r(cfg, k, codes.shape[1])
    del codes
    cand = torch.topk(_order_scores(s, cfg.metric), r, dim=-1).indices
    lane = torch.arange(g, device=state.device).view(g, 1, 1)
    li = cand.clamp(0, n_probe_rows - 1)
    lists = pi.gather(1, (li // l).view(g, -1)).view_as(li)
    in_rows = state.lists[lane, lists, li % l]
    sp = state.spill[lane, (cand - n_probe_rows).clamp(
        0, state.spill.shape[1] - 1)]
    rows = torch.where((cand >= n_probe_rows)[..., None], sp, in_rows)
    out_ids, top, _ = _rescore_topk(qi, rows, rids[lane, cand], cfg.metric,
                                    k)
    return out_ids[:, 0], top[:, 0]


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

def footprint(state: IVFState) -> dict:
    """Resident-size accounting for the scan store.  `bytes_per_row`: under
    the int8 policy a row costs its retained exact f32 copy (the rescore
    tier) plus its 1-byte code; `scan_bytes_per_row`: what the coarse scan
    streams per row (1 byte a component under int8, 4 under f32);
    `index_bytes`: every leaf of the state."""
    return {
        "bytes_per_row": state.dim * (5 if state.quantized else 4),
        "scan_bytes_per_row": state.dim * (1 if state.quantized else 4),
        "index_bytes": sum(int(leaf.numel()) * leaf.element_size()
                           for leaf in _leaves(state)),
        "store_dtype": "int8" if state.quantized else "float32",
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
