"""Logical-axis sharding rules and the collectives of the model mesh.

Port of ``src/repro/models/sharding.py``.  Tensors are placed by *logical*
axis names, which the table below maps onto mesh axes; a thread-local
context holds the active mesh, and without one every function here is the
identity, as in the reference.

Physical mapping:
  batch   -> ('pod', 'data')   DP
  fsdp    -> ('data',)         parameter sharding (ZeRO-3)
  model   -> ('model',)        TP: heads / ffn hidden / vocab / experts
  seq_kv  -> ('model',)        KV-cache sequence sharding for small-kv decode

The mesh is the port's `ShardMesh` (`repro_torch.core.distributed`):
shard i on ``mesh.devices[i]`` in the reference's row-major order, and
devices may repeat (eight shards on one card).  One process drives every
shard, or (`repro_torch.launch.mesh.process_mesh`) each process of a
process group drives its run of them, the other processes' shards held as
stand-ins on the ``meta`` device (`is_local`), so that the model code's
loops over shards run unchanged.  Where the reference's GSPMD holds one
global array with a sharding, the port holds a `Placed`: one local piece
per shard, each on its shard's device, and the placement that cut them.
The model code runs Megatron-style tensor parallelism on the local pieces
(`repro_torch.models.lm`); every movement of data from one shard to
another goes through the collectives at the end of this file (`all_sum`,
`all_max`, `all_gather`, `fetch`, `to_home`, `gather_whole`, `argmax`),
each of which runs in shard order and knows its kind, its group and its
bytes: a `CollectiveCounter` counts what each moves by the reference's
ring formulas.  On one card a collective is an add or a concatenation on
that card; on several cards its operands are copied device to device;
across processes they are exchanged by one all-gather of bytes
(`_exchange`) and then added or concatenated as on one card, so a mesh
over processes computes the one-process mesh's bits.

Training differentiates through them: each collective is an
``autograd.Function`` whose backward is its transpose (a sum's is a sum,
a gather's a reduce-scatter, a fetch's a send back to the source, the
whole values' (`to_home`) a local slice), each computed in shard order.
A piece the placement replicates is a copy on each shard, whose gradient
covers only its own shard's use; `replica_sum` adds the copies' gradients
(the transpose of the reference's implicit GSPMD psum, its data-parallel
gradient sum).  Over processes the collectives of a step are chained
(`chain`), so every process runs their backwards in one order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.distributed import ShardMesh

# one entry per dimension: None, an axis name, or a tuple of axis names (a
# PartitionSpec's entries); missing trailing entries are None
Placement = Tuple[object, ...]

_state = threading.local()


def current_mesh() -> Optional[ShardMesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[ShardMesh]):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def axis_sizes(mesh: ShardMesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def _axes(mesh: ShardMesh, logical: Optional[str]):
    if logical is None:
        return None
    names = set(mesh.axis_names)
    table = {
        "batch": tuple(a for a in ("pod", "data") if a in names),
        "fsdp": ("data",) if "data" in names else (),
        "expert": ("model",) if "model" in names else (),
        "model": ("model",) if "model" in names else (),
        "seq_kv": ("model",) if "model" in names else (),
        # sequence over the data axes (long-context, batch too small to DP)
        "seq_data": tuple(a for a in ("pod", "data") if a in names),
        "seq_all": tuple(a for a in ("pod", "data", "model") if a in names),
    }
    ax = table.get(logical, ())
    return ax if ax else None


def _entry(axes: Tuple[str, ...]):
    """A one-axis tuple as its name, as ``PartitionSpec`` holds it."""
    return axes[0] if len(axes) == 1 else axes


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one placement entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec(*logical: Optional[str]) -> Optional[Placement]:
    """The placement of logical axes under the current mesh (None without
    one), before any divisibility guard."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return tuple(None if ax is None else _entry(ax)
                 for ax in (_axes(mesh, l) for l in logical))


def placement(shape, *logical: Optional[str],
              mesh: Optional[ShardMesh] = None) -> Placement:
    """The placement `shard` gives a tensor of `shape` on `mesh` (default:
    the current one): a logical mapping is dropped (replicated) when the
    dim does not divide the mapped axes, and a mesh axis goes to the first
    dim that takes it."""
    mesh = mesh or current_mesh()
    if len(shape) != len(logical):
        raise ValueError(f"{len(logical)} logical axes for shape "
                         f"{tuple(shape)}")
    sizes = axis_sizes(mesh)
    out = []
    used: set = set()
    for dim, l in zip(shape, logical):
        ax = _axes(mesh, l)
        if ax is not None:
            ax = tuple(a for a in ax if a not in used)
        if not ax:
            out.append(None)
            continue
        n = math.prod(sizes[a] for a in ax)
        if n and dim % n == 0:
            out.append(_entry(ax))
            used.update(ax)
        else:
            out.append(None)
    return tuple(out)


# ---------------------------------------------------------------------------
# shards, pieces and placed tensors
# ---------------------------------------------------------------------------

def coords(mesh: ShardMesh, i: int) -> Dict[str, int]:
    """Shard i's coordinate on each axis (row-major, as the reference
    lays devices out)."""
    out = {}
    for name, n in reversed(list(zip(mesh.axis_names, mesh.shape))):
        out[name] = i % n
        i //= n
    return out


def groups(mesh: ShardMesh, axes: Sequence[str]) -> List[List[int]]:
    """The shards grouped by their coordinates off `axes` (the members of
    one collective over `axes`), each group in row-major order over
    `axes`."""
    out: Dict[tuple, List[int]] = {}
    for i in range(mesh.size):
        c = coords(mesh, i)
        key = tuple(c[a] for a in mesh.axis_names if a not in axes)
        out.setdefault(key, []).append(i)
    return list(out.values())


def local_slices(shape, spec_: Placement, mesh: ShardMesh,
                 i: int) -> Tuple[slice, ...]:
    """The slices of a tensor of `shape` that shard i holds under `spec_`
    (an entry of several axes splits its dim row-major over them)."""
    sizes, c = axis_sizes(mesh), coords(mesh, i)
    spec_ = tuple(spec_) + (None,) * (len(shape) - len(spec_))
    out = []
    for dim, entry in zip(shape, spec_):
        k, n = 0, 1
        for a in entry_axes(entry):
            k, n = k * sizes[a] + c[a], n * sizes[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry}")
        step = dim // n
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


def local_shape(shape, spec_: Placement, mesh: ShardMesh) -> Tuple[int, ...]:
    return tuple(s.stop - s.start
                 for s in local_slices(shape, spec_, mesh, 0))


@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """A tensor of `shape` held as one local piece per shard of `mesh`
    (``parts[i]`` on ``mesh.devices[i]``), cut by `spec`: the port's
    counterpart of a global array with a ``NamedSharding``."""
    parts: Tuple[torch.Tensor, ...]
    spec: Placement
    mesh: ShardMesh
    shape: Tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @torch.no_grad()
    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: `home`), each slice
        copied from a shard that holds it (a collective, ``all-gather``
        over the distinct slices: `gather_whole`); a value, outside
        autograd."""
        return gather_whole(self, device)


def distinct(shape, spec_: Placement, mesh: ShardMesh) -> List[int]:
    """The shards that hold each slice of a tensor of `shape` placed by
    `spec_` first, in shard order: one per slice (the others hold replicas
    of theirs)."""
    out, seen = [], set()
    for i in range(mesh.size):
        key = tuple((s.start, s.stop)
                    for s in local_slices(shape, spec_, mesh, i))
        if key not in seen:
            seen.add(key)
            out.append(i)
    return out


def place(x: torch.Tensor, spec_: Placement, mesh: ShardMesh, *,
          copy: bool = False) -> Placed:
    """`x` cut by `spec_` onto `mesh`.  A piece on x's own device is a view
    unless `copy` (parameters are copied, so each shard holds its bytes
    and the whole tensor can be freed)."""
    parts = []
    for i, dev in enumerate(mesh.devices):
        piece = x[local_slices(x.shape, spec_, mesh, i)]
        if copy or piece.device != dev:
            piece = piece.to(dev, copy=True).contiguous()
        parts.append(piece)
    return Placed(tuple(parts), tuple(spec_), mesh, tuple(x.shape))


def shard(x, *logical: Optional[str]):
    """`x` placed by logical axes on the current mesh (a `Placed`, with the
    divisibility guard of `placement`); the identity without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return place(x, placement(x.shape, *logical, mesh=mesh), mesh)


@dataclasses.dataclass(frozen=True, eq=False)
class Joined:
    """A tensor of `shape` whose pieces side by side along `dim` are placed
    differently (mamba2's conv window: the model-cut x channels, then the
    replicated B/C channels): per shard one buffer, ``parts[i]``, holding
    its local piece of each in that order; ``pieces`` are the `Placed`
    views of those pieces, so a write into a buffer shows in them."""
    parts: Tuple[torch.Tensor, ...]
    pieces: Tuple[Placed, ...]
    dim: int

    @property
    def mesh(self) -> ShardMesh:
        return self.pieces[0].mesh

    @property
    def shape(self) -> Tuple[int, ...]:
        shape = list(self.pieces[0].shape)
        shape[self.dim] = sum(p.shape[self.dim] for p in self.pieces)
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def full(self, device=None) -> torch.Tensor:
        return torch.cat([p.full(device) for p in self.pieces], self.dim)


def join(parts: Sequence[torch.Tensor], specs: Sequence[Placement],
         widths: Sequence[int], mesh: ShardMesh, shape, dim: int) -> Joined:
    """Per-shard buffers `parts` read as pieces of whole widths `widths`
    along `dim`, piece j placed by ``specs[j]`` (`shape`: the whole
    tensor's, `dim` holding the widths' sum)."""
    pieces, start = [], [0] * len(parts)
    for spec_, width in zip(specs, widths):
        whole = tuple(shape[:dim]) + (width,) + tuple(shape[dim + 1:])
        n = local_shape(whole, spec_, mesh)[dim]
        views = tuple(p.narrow(dim, s, n) for p, s in zip(parts, start))
        start = [s + n for s in start]
        pieces.append(Placed(views, tuple(spec_), mesh, whole))
    if start[0] != parts[0].shape[dim]:
        raise ValueError(f"pieces of {start[0]} of {parts[0].shape[dim]} "
                         "local columns")
    return Joined(tuple(parts), tuple(pieces), dim)


def tree_map(fn, tree):
    """`fn` on every leaf of a cache tree (NamedTuples, dicts; None and
    `Placed`/`Joined` are leaves)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def local_tree(tree, i: int):
    """Shard i's pieces of a tree of placed leaves, in the same tree."""
    return tree_map(lambda t: t.parts[i], tree)


def full_tree(tree, device=None):
    """A tree of placed leaves with each leaf whole (`Placed.full`)."""
    return tree_map(lambda t: t.full(device), tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement bound to a mesh (``jax.sharding.NamedSharding``)."""
    mesh: ShardMesh
    spec: Placement

    def place(self, x: torch.Tensor) -> Placed:
        return place(x, self.spec, self.mesh, copy=True)



# ---------------------------------------------------------------------------
# processes: which shards this process holds
# ---------------------------------------------------------------------------

def process_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def spans_processes(mesh: ShardMesh) -> bool:
    return mesh.owners is not None and len(set(mesh.owners)) > 1


def is_local(mesh: ShardMesh, i: int) -> bool:
    """Whether this process holds shard i (always, on a one-process mesh;
    elsewhere shard i's tensors are stand-ins on the ``meta`` device, which
    carry a shape and a dtype and no data: a read of one raises)."""
    return mesh.owners is None or mesh.owners[i] == process_rank()


def home(mesh: ShardMesh) -> torch.device:
    """Where a mesh call's whole values live (the loss and the aux loss,
    the global grad norm, a gathered tensor, greedy tokens): shard 0's
    device, or on a mesh that spans processes this process's first
    shard's, where every process holds them with the same bits."""
    if mesh.owners is None:
        return mesh.devices[0]
    return mesh.devices[mesh.owners.index(process_rank())]


def stand_in(shape, dtype: torch.dtype) -> torch.Tensor:
    """A tensor of another process's shard: its shape and dtype only."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the counter: what each collective moves
# ---------------------------------------------------------------------------

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")

# Module state, not thread-local: autograd may run a backward, or recompute
# a checkpointed layer, on its own thread.
_RECORDERS: List["CollectiveCounter"] = []
_SCOPE: List[str] = []
_INSIDE: List[bool] = []     # a collective's own arithmetic is running


def wire_bytes(kind: str, n: int, in_bytes: int,
               out_bytes: int) -> Fraction:
    """The bytes one device of a group of n puts on the wire for one
    collective with `in_bytes` in and `out_bytes` out per device: the
    reference's ring costs (``src/repro/launch/hlo_analysis.py``
    ``parse``), exact."""
    ring = Fraction(n - 1, max(n, 1))
    return {"all-gather": out_bytes * ring,
            "reduce-scatter": in_bytes * ring,
            "all-reduce": 2 * in_bytes * ring,
            "all-to-all": in_bytes * ring,
            "collective-permute": Fraction(out_bytes)}[kind]


@contextlib.contextmanager
def scope(name: str):
    """Name the collectives run inside (a module path, joined with '.'
    to the enclosing scopes'), for `CollectiveCounter.by_path`."""
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def scope_path() -> str:
    return ".".join(_SCOPE)


def inside_collective() -> bool:
    """Whether the ops running now are a collective's own arithmetic (the
    adds and copies that stand for it on one device, its exchange between
    processes), which a count of a device's work (`launch.op_analysis`)
    leaves out: it takes the collective's bytes from its record."""
    return bool(_INSIDE)


@contextlib.contextmanager
def _arithmetic():
    _INSIDE.append(True)
    try:
        yield
    finally:
        _INSIDE.pop()


class CollectiveCounter:
    """Counts every collective run inside it (``with CollectiveCounter()
    as c:``), forward, backward and recompute: per kind the wire bytes one
    device moves (`wire_bytes`, exact fractions), the raw bytes (max of in
    and out), the number of ops, and the wire bytes by `scope` path.  A
    collective over one shard moves nothing and is not counted.  Counting
    changes no value (each member's out is then a tensor of its own:
    `_own`); without a counter nothing is recorded."""

    def __init__(self):
        self.wire: Dict[str, Fraction] = {}
        self.raw: Dict[str, int] = {}
        self.ops: Dict[str, int] = {}
        self.by_path: Dict[str, Dict[str, Fraction]] = {}

    def record_collective(self, kind: Optional[str], n: int, in_bytes: int,
                          out_bytes: int, path: str, members=()) -> None:
        """One collective (`kind` None: nothing crosses between devices)
        over groups of `n`, `in_bytes` and `out_bytes` per device;
        `members` (per out: its shard, None for a whole value, the bytes
        that shard's device reads and writes, the out) are for a count of
        each device's work."""
        if kind is None or n <= 1:
            return
        w = wire_bytes(kind, n, in_bytes, out_bytes)
        self.wire[kind] = self.wire.get(kind, 0) + w
        self.raw[kind] = self.raw.get(kind, 0) + max(in_bytes, out_bytes)
        self.ops[kind] = self.ops.get(kind, 0) + 1
        at = self.by_path.setdefault(path, {})
        at[kind] = at.get(kind, 0) + w

    def bytes(self) -> Dict[str, float]:
        """Wire bytes by kind, as a record holds them."""
        return {k: float(v) for k, v in sorted(self.wire.items())}

    def __enter__(self):
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _size(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _storage(t: torch.Tensor) -> int:
    return id(t.untyped_storage())


_MANY = object()      # a storage that inputs of several shards share


def _own(outs, ins=(), who=None, ins_who=None) -> list:
    """`outs`, each a tensor of its own: an out that shares its storage
    with an earlier out, or with an input of a shard other than its own
    (out k is shard ``who[k]``'s, input j shard ``ins_who[j]``'s; without
    them any sharing), is cloned.  On one card the members of a group share
    one result and a fetch's reader holds a view of its source; a count by
    shard (`launch.op_analysis`) and autograd each need them apart."""
    mine: Dict[int, object] = {}
    for j, t in enumerate(ins):
        if isinstance(t, torch.Tensor):
            key = _storage(t)
            w = None if ins_who is None else ins_who[j]
            mine[key] = w if mine.get(key, w) == w else _MANY
    seen, res = set(), []
    for k, o in enumerate(outs):
        if isinstance(o, torch.Tensor):
            key = _storage(o)
            w = None if who is None else who[k]
            if key in seen or (key in mine and (w is None
                                                or mine[key] != w)):
                o = o.clone()
                key = _storage(o)
            seen.add(key)
        res.append(o)
    return res


def _finish(outs, kind: Optional[str], n: int, in_bytes: int,
            out_bytes: int, path: Optional[str], members, ins=(),
            ins_who=None, strict: bool = False) -> list:
    """The end of one collective, `outs` computed from `ins` (input j
    shard ``ins_who[j]``'s, by default shard j's).  Inside autograd
    (`strict`) each out is made a tensor of its own (`_own`); with a
    counter on, too, but for out k (shard ``members[k][0]``'s, None a
    whole value) a view of its own shard's input, and the call is
    recorded: its kind, group size and bytes in and out per device, and
    per out its shard and the bytes that shard's device reads and writes
    for it (``members[k][1]``)."""
    if strict:
        outs = _own(outs, ins)
    if not _RECORDERS:
        return outs
    outs = _own(outs, ins, [w for w, _ in members],
                range(len(ins)) if ins_who is None else ins_who)
    path = scope_path() if path is None else path
    rec = [(w, int(b), o) for (w, b), o in zip(members, outs)]
    for r in tuple(_RECORDERS):
        r.record_collective(kind, n, int(in_bytes), int(out_bytes),
                            path or "(step)", rec)
    return outs


# ---------------------------------------------------------------------------
# moving parts between processes
# ---------------------------------------------------------------------------

_ALIGN = 16
_PINNED: Dict[object, torch.Tensor] = {}   # gloo's page-locked staging


def _staging(key, nbytes: int) -> torch.Tensor:
    """A page-locked host buffer of `nbytes` (reused across calls: each
    call's copies finish before it returns)."""
    have = _PINNED.get(key)
    if have is None or have.numel() < nbytes:
        have = _PINNED[key] = torch.empty(nbytes, dtype=torch.uint8,
                                          pin_memory=True)
    return have[:nbytes]


def _exchange(mesh: ShardMesh, items: Sequence[Tuple[int, torch.Tensor]]
              ) -> List[torch.Tensor]:
    """Each (shard, tensor) item readable here: this process's as they
    are, the others' received (on `home`).  Every process calls it with the
    same items in the same order, another process's as stand-ins: one
    all-gather over the processes of each one's items packed as bytes
    (through page-locked host buffers on gloo with a card).  Nothing is
    summed in transit, so the arithmetic after it is the one-process
    mesh's, in its order."""
    dist = torch.distributed
    me, world = process_rank(), dist.get_world_size()
    dev = home(mesh)
    where, size = [], [0] * world
    for i, t in items:
        o = mesh.owners[i]
        nb = _nbytes(t)
        where.append((o, size[o], nb))
        size[o] += -(-nb // _ALIGN) * _ALIGN
    width = max(max(size), _ALIGN)
    buf = torch.empty(width, dtype=torch.uint8, device=dev)
    for (o, off, nb), (_, t) in zip(where, items):
        if o == me and nb:
            buf[off:off + nb] = t.detach().contiguous().reshape(-1).view(
                torch.uint8).to(dev)
    if dist.get_backend() == "gloo" and dev.type == "cuda":
        send = _staging("send", width)
        send.copy_(buf)
        got = [_staging(("recv", r), width) for r in range(world)]
        dist.all_gather(got, send)
        got = [g.to(dev) if r != me and size[r] else None
               for r, g in enumerate(got)]
    else:
        got = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(got, buf)
    out = []
    for (o, off, nb), (_, t) in zip(where, items):
        out.append(t if o == me else got[o][off:off + nb].view(
            t.dtype).view(t.shape))
    return out


def _spans(mesh: ShardMesh, members: Sequence[int]) -> bool:
    return mesh.owners is not None and len(
        {mesh.owners[i] for i in members}) > 1


def _readable(mesh: ShardMesh, items) -> List[torch.Tensor]:
    """`_exchange` of the items of groups that span processes; on one
    process the items as they are."""
    items = list(items)
    if not spans_processes(mesh) or not items:
        return [t for _, t in items]
    return _exchange(mesh, items)


def _visible(mesh: ShardMesh, gs, parts) -> Dict[int, torch.Tensor]:
    """The parts of the groups `gs` that span processes, readable here
    ({} on a mesh of one process)."""
    if not spans_processes(mesh):
        return {}
    keys = [j for g in gs if _spans(mesh, g) for j in g]
    return dict(zip(keys, _readable(mesh, [(j, parts[j]) for j in keys])))


@functools.lru_cache(maxsize=256)
def _groups(mesh: ShardMesh, axes: Tuple[str, ...]
            ) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(g) for g in groups(mesh, axes))


# ---------------------------------------------------------------------------
# the collectives: each over mesh axes, in shard order; a member's
# arithmetic is the same whichever process runs it, so a mesh that spans
# processes computes the one-process mesh's bits.  The members of a group
# on one card share one result.
# ---------------------------------------------------------------------------

Axes = Union[str, Sequence[str]]

# the ordering of the collectives' backwards on a mesh that spans
# processes: every collective of a differentiated step takes the token the
# one before it made, so autograd runs their transposes in the reverse of
# the forward order on every process (`chain`)
_CHAIN: List[Optional[torch.Tensor]] = []


@contextlib.contextmanager
def chain(mesh: ShardMesh):
    """Differentiate a step on `mesh` inside: on a mesh that spans
    processes the collectives' backwards (and a checkpointed layer's
    recompute, which each collective's backward starts) then run in one
    order on every process; elsewhere it does nothing."""
    if not spans_processes(mesh):
        yield
        return
    _CHAIN.append(torch.zeros((), device=home(mesh), requires_grad=True))
    try:
        yield
    finally:
        _CHAIN.pop()


class _Collective(torch.autograd.Function):
    """One collective inside autograd: ``op.forward(parts)``, and
    ``op.backward(grads)`` its transpose (lists over shards).  The out of a
    shard another process holds is a stand-in without a gradient; `token`
    (a mesh that spans processes) chains the collectives (`chain`)."""

    @staticmethod
    def forward(ctx, op, token, *parts):
        ctx.op = op
        ctx.set_materialize_grads(False)
        if token is not None:
            ctx.save_for_backward(token)
        with _arithmetic():
            # an out must be a tensor of its own: not an input, another
            # out or a view of either
            outs = _finish(*op.forward(list(parts)), strict=True)
        ctx.mark_non_differentiable(*[
            o for k, o in enumerate(outs)
            if not op.differentiable or not op.local_out(k)])
        ctx.n_out = len(outs)
        return tuple(outs) + ((token.new_zeros(()),) if token is not None
                              else ())

    @staticmethod
    def backward(ctx, *grads):
        op = ctx.op
        token = ctx.saved_tensors    # unpacked first: a checkpointed layer's
        #                              recompute runs here, in chain order
        gins = [None] * (len(ctx.needs_input_grad) - 2)
        if op.differentiable:
            grads = list(grads[:ctx.n_out])
            with _arithmetic():
                gins = _finish(*op.backward(grads), strict=True)
        gins = [g if ctx.needs_input_grad[2 + j] else None
                for j, g in enumerate(gins)]
        tok = torch.zeros((), device=token[0].device) if token else None
        return (None, tok, *gins)


def _run(op, parts) -> List[torch.Tensor]:
    """`op` on `parts`: inside autograd where a part requires grad (on a
    mesh that spans processes, always inside `chain`), else plainly."""
    mesh = op.mesh
    multi = spans_processes(mesh)
    if not torch.is_grad_enabled() or not (
            (multi and _CHAIN) or any(isinstance(p, torch.Tensor)
                                      and p.requires_grad for p in parts)):
        with _arithmetic():
            return _finish(*op.forward(list(parts)))
    if multi and not _CHAIN:
        raise RuntimeError("a step differentiated over processes runs "
                           "inside sharding.chain(mesh)")
    token = _CHAIN[-1] if multi else None
    outs = _Collective.apply(op, token, *parts)
    if multi:
        _CHAIN[-1] = outs[-1]
        outs = outs[:-1]
    return list(outs)


def _axis_tuple(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _zeros_or(t: Optional[torch.Tensor], shape, dtype: torch.dtype,
              mesh: ShardMesh, i: int) -> torch.Tensor:
    """A gradient as a tensor: zeros where autograd gave none (a stand-in
    on a shard of another process)."""
    if t is not None:
        return t
    if not is_local(mesh, i):
        return stand_in(shape, dtype)
    return torch.zeros(tuple(shape), dtype=dtype, device=mesh.devices[i])


def _wide_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


class _Reduce:
    """`all_sum` / `all_max` over the groups of `axes`."""

    def __init__(self, mesh: ShardMesh, axes: Tuple[str, ...], how: str,
                 path: str):
        self.mesh, self.how, self.path = mesh, how, path
        self.groups = _groups(mesh, axes)
        self.differentiable = how == "sum"

    def local_out(self, k: int) -> bool:
        return is_local(self.mesh, k)

    def forward(self, parts):
        mesh = self.mesh
        self._like = [(p.shape, p.dtype) for p in parts]
        vis = _visible(mesh, self.groups, parts)
        out: List[Optional[torch.Tensor]] = [None] * len(parts)
        for g in self.groups:
            done: Dict[torch.device, torch.Tensor] = {}
            for i in g:
                if not is_local(mesh, i):
                    out[i] = stand_in(parts[i].shape, parts[i].dtype)
                    continue
                dev = mesh.devices[i]
                if dev not in done:
                    got = [vis.get(j, parts[j]).to(dev) for j in g]
                    acc = got[0]
                    if self.how == "max":
                        for t in got[1:]:
                            acc = torch.maximum(acc, t)
                    elif len(g) > 1:
                        acc = _wide(acc)
                        for t in got[1:]:
                            acc = acc + t
                    done[dev] = acc.to(parts[i].dtype)
                out[i] = done[dev]
        nb = [_nbytes(p) for p in parts]
        return (out, "all-reduce", len(self.groups[0]), max(nb), 0,
                self.path, [(i, 2 * b) for i, b in enumerate(nb)], parts)

    def backward(self, grads):
        # the transpose of a sum over a group: each member gets the sum of
        # the group's out gradients, in shard order
        return self.forward([_zeros_or(g, *self._like[i], self.mesh, i)
                             for i, g in enumerate(grads)])


def all_sum(parts: Sequence[torch.Tensor], mesh: ShardMesh,
            axis: Axes) -> List[torch.Tensor]:
    """Each shard's part summed over the shards of its group on `axis` (an
    axis name or several: ``psum``, an ``all-reduce``), in row-major shard
    order with f32 accumulation for 16-bit parts, then in the parts'
    dtype.  Every member computes the same sum in the same order, so the
    members of a group get the same bits.  Its transpose is itself."""
    return _run(_Reduce(mesh, _axis_tuple(axis), "sum", scope_path()),
                list(parts))


def all_max(parts: Sequence[torch.Tensor], mesh: ShardMesh,
            axis: Axes) -> List[torch.Tensor]:
    """Each shard's part's elementwise maximum over its group on `axis`
    (``pmax``, an ``all-reduce``); exact, so every member gets the same
    bits.  A value without a gradient (its use: the CE's steadying max)."""
    return _run(_Reduce(mesh, _axis_tuple(axis), "max", scope_path()),
                list(parts))


def replica_axes(spec_: Placement, mesh: ShardMesh) -> Tuple[str, ...]:
    """The mesh axes (of more than one shard) that `spec_` does not cut:
    the shards along them hold replicas of the same slice."""
    used = {a for e in spec_ for a in entry_axes(e)}
    return tuple(a for a, n in zip(mesh.axis_names, mesh.shape)
                 if a not in used and n > 1)


def replica_sum(parts: Sequence[torch.Tensor], spec_: Placement,
                mesh: ShardMesh) -> List[torch.Tensor]:
    """The gradient of a placed leaf from each piece's own: every piece's
    part summed with the parts of the pieces that hold the same slice (the
    shards along `replica_axes`), by `all_sum` (shard order, f32
    accumulation for 16-bit parts): the transpose of using one slice in
    several places, which gives every replica the same bits.  Each shard
    gets a tensor of its own (the optimizer updates them in place)."""
    axes = replica_axes(spec_, mesh)
    if not axes:
        return list(parts)
    return _own(all_sum(parts, mesh, axes))


class _Gather:
    """`all_gather` over the groups of one axis, along `dim`."""
    differentiable = True

    def __init__(self, mesh: ShardMesh, axis: str, dim: int, path: str):
        self.mesh, self.dim, self.path = mesh, dim, path
        self.groups = _groups(mesh, (axis,))

    def local_out(self, k: int) -> bool:
        return is_local(self.mesh, k)

    def forward(self, parts):
        mesh, dim = self.mesh, self.dim
        n = len(self.groups[0])
        self._like = [(p.shape, p.dtype) for p in parts]
        vis = _visible(mesh, self.groups, parts)
        out: List[Optional[torch.Tensor]] = [None] * len(parts)
        for g in self.groups:
            done: Dict[torch.device, torch.Tensor] = {}
            for i in g:
                if not is_local(mesh, i):
                    shape = list(parts[i].shape)
                    shape[dim] = sum(parts[j].shape[dim] for j in g)
                    out[i] = stand_in(shape, parts[i].dtype)
                    continue
                dev = mesh.devices[i]
                if dev not in done:
                    got = [vis.get(j, parts[j]).to(dev) for j in g]
                    done[dev] = got[0] if len(g) == 1 else torch.cat(got,
                                                                     dim)
                out[i] = done[dev]
        nb = [_nbytes(p) for p in parts]
        return (out, "all-gather", n, max(nb), n * max(nb), self.path,
                [(i, (n + 1) * b) for i, b in enumerate(nb)], parts)

    def backward(self, grads):
        # the transpose (a reduce-scatter): each member's slice of every
        # member's out gradient, summed in shard order
        mesh, dim, like = self.mesh, self.dim, self._like
        n = len(self.groups[0])
        gs = []
        for i, g in enumerate(grads):
            shape = list(like[i][0])
            shape[dim] *= n
            gs.append(_zeros_or(g, shape, like[i][1], mesh, i))
        offs = {}
        for g in self.groups:
            o = 0
            for j in g:
                offs[j] = (o, like[j][0][dim])
                o += like[j][0][dim]
        vis = {}
        if spans_processes(mesh):
            keys, items = [], []
            for g in self.groups:
                for m in g:
                    for j in g:
                        if _spans(mesh, (m, j)):
                            keys.append((m, j))
                            items.append((m, gs[m].narrow(dim, *offs[j])))
            vis = dict(zip(keys, _readable(mesh, items)))
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for g in self.groups:
            for j in g:
                if not is_local(mesh, j):
                    continue
                dev = mesh.devices[j]
                got = [vis[(m, j)] if (m, j) in vis else
                       gs[m].narrow(dim, *offs[j]) for m in g]
                acc = _wide(got[0].to(dev))
                for t in got[1:]:
                    acc = acc + t.to(dev)
                out[j] = acc.to(like[j][1])
        nb = [_size(*x) for x in like]
        return (out, "reduce-scatter", n, n * max(nb), max(nb), self.path,
                [(j, (n + 1) * b) for j, b in enumerate(nb)], gs)


def all_gather(parts: Sequence[torch.Tensor], mesh: ShardMesh, axis: str,
               dim: int) -> List[torch.Tensor]:
    """Each shard's part concatenated along `dim` with the parts of its
    group on `axis`, in axis order (``all_gather(tiled=True)``).  Its
    transpose is a ``reduce-scatter``: each part's gradient is its slice
    of the members' gradients summed in shard order (f32 accumulation for
    16-bit parts)."""
    return _run(_Gather(mesh, axis, dim, scope_path()), list(parts))


def gather_axes(parts: Sequence[torch.Tensor], spec_: Placement,
                mesh: ShardMesh, axes: Sequence[str]
                ) -> Tuple[List[torch.Tensor], Placement]:
    """Parts placed by `spec_` gathered over each mesh axis of `axes` that
    splits one of their dims; returns (parts, what remains of the
    placement)."""
    parts = list(parts)
    left = []
    for dim, entry in enumerate(spec_):
        keep = []
        for a in reversed(entry_axes(entry)):      # the innermost first
            if a in axes and axis_sizes(mesh)[a] > 1:
                parts = all_gather(parts, mesh, a, dim)
            else:
                keep.insert(0, a)
        left.append(_entry(tuple(keep)) if keep else None)
    return parts, tuple(left)


Take = Optional[Tuple[int, int, int]]      # (dim, start, length) or whole


def _take(t: torch.Tensor, take: Take) -> torch.Tensor:
    return t if take is None else t.narrow(*take)


def _taken(shape, take: Take) -> Tuple[int, ...]:
    shape = list(shape)
    if take is not None:
        shape[take[0]] = take[2]
    return tuple(shape)


class _Fetch:
    """`fetch`: member i reads (a slice of) shard ``srcs[i]``'s tensor."""
    differentiable = True

    def __init__(self, mesh: ShardMesh, srcs: Sequence[int],
                 takes: Sequence[Take], path: str):
        self.mesh, self.srcs, self.takes, self.path = mesh, tuple(srcs), \
            tuple(takes), path

    def local_out(self, k: int) -> bool:
        return is_local(self.mesh, k)

    def _done(self, outs, sizes, ins):
        """The record of a fetch (sizes: each member's slice's bytes) or of
        its transpose: a ``collective-permute`` where a member reads
        another shard; each reader's device writes its slice, each source's
        reads what its readers take."""
        srcs = self.srcs
        readers = [i for i, s in enumerate(srcs) if s != i]
        moved = [0] * len(srcs)
        for i in readers:
            moved[i] += sizes[i]
            moved[srcs[i]] += sizes[i]
        return (outs, "collective-permute",
                max(srcs.count(s) for s in set(srcs)), 0,
                max((sizes[i] for i in readers), default=0), self.path,
                list(enumerate(moved)), ins)

    def forward(self, parts):
        mesh, srcs, takes = self.mesh, self.srcs, self.takes
        self._like = {s: (parts[s].shape, parts[s].dtype) for s in set(srcs)}
        vis = {}
        if spans_processes(mesh):
            keys = [i for i, s in enumerate(srcs) if _spans(mesh, (i, s))]
            vis = dict(zip(keys, _readable(
                mesh, [(srcs[i], _take(parts[srcs[i]], takes[i]))
                       for i in keys])))
        out = []
        for i, (s, t) in enumerate(zip(srcs, takes)):
            if not is_local(mesh, i):
                out.append(stand_in(_taken(self._like[s][0], t),
                                    self._like[s][1]))
                continue
            got = vis[i] if i in vis else _take(parts[s], t)
            out.append(got.to(mesh.devices[i]))
        return self._done(out, [_nbytes(o) for o in out], parts)

    def backward(self, grads):
        # the transpose: each source gets its readers' gradients, each in
        # its slice, summed in shard order
        mesh, srcs, takes = self.mesh, self.srcs, self.takes
        gs = [_zeros_or(g, _taken(self._like[s][0], t), self._like[s][1],
                        mesh, i)
              for i, (g, s, t) in enumerate(zip(grads, srcs, takes))]
        vis = {}
        if spans_processes(mesh):
            keys = [i for i, s in enumerate(srcs) if _spans(mesh, (i, s))]
            vis = dict(zip(keys, _readable(mesh, [(i, gs[i])
                                                  for i in keys])))
        out: List[Optional[torch.Tensor]] = [None] * len(srcs)
        for s in sorted(set(srcs)):
            if not is_local(mesh, s):
                continue
            shape, dtype = self._like[s]
            dev = mesh.devices[s]
            acc = torch.zeros(shape, dtype=_wide_dtype(dtype), device=dev)
            for i in range(len(srcs)):
                if srcs[i] == s:
                    g = (vis[i] if i in vis else gs[i]).to(dev)
                    _take(acc, takes[i]).add_(g)
            out[s] = acc.to(dtype)
        return self._done(out, [_nbytes(g) for g in gs], gs)


def fetch(parts: Sequence[Optional[torch.Tensor]], mesh: ShardMesh,
          srcs: Sequence[int], takes: Optional[Sequence[Take]] = None
          ) -> List[torch.Tensor]:
    """Member i's copy of (a slice ``takes[i]`` of) shard ``srcs[i]``'s
    tensor ``parts[srcs[i]]`` on its device (the parts no member reads may
    be None): the layer a layer-cut leaf's owner hands its group, the
    routing a block's first shard hands its expert shards.  A
    ``collective-permute`` where a member reads another shard; its
    transpose sends each reader's gradient back to the source."""
    takes = list(takes) if takes is not None else [None] * len(srcs)
    return _run(_Fetch(mesh, srcs, takes, scope_path()), list(parts))


class _ToHome:
    """`to_home`: shards' values as whole values on every process."""
    differentiable = True

    def __init__(self, mesh: ShardMesh, srcs: Sequence[int], path: str):
        self.mesh, self.srcs, self.path = mesh, tuple(srcs), path

    def local_out(self, k: int) -> bool:
        return True

    def forward(self, parts):
        mesh, srcs = self.mesh, self.srcs
        per = {}
        for s, p in zip(srcs, parts):
            per[s] = per.get(s, 0) + _nbytes(p)
        dev = home(mesh)
        out = [g.to(dev, copy=True)
               for g in _readable(mesh, list(zip(srcs, parts)))]
        # whole values: every device writes each and reads its own
        return (out, "all-gather", len(per), max(per.values()),
                sum(per.values()), self.path,
                [(None, 2 * _nbytes(p)) for p in parts])

    def backward(self, grads):
        # whole values are every process's, with the same gradients: each
        # source takes its own from its process's copy, nothing on the wire
        mesh = self.mesh
        out = [None if g is None or not is_local(mesh, s)
               else g.to(mesh.devices[s]) for s, g in zip(self.srcs, grads)]
        return (out, None, 1, 0, 0, self.path, [(s, 0) for s in self.srcs],
                grads, [None] * len(grads))


def to_home(parts: Sequence[torch.Tensor], mesh: ShardMesh,
            srcs: Sequence[int]) -> List[torch.Tensor]:
    """``parts[k]``, a value of shard ``srcs[k]``, as a whole value on
    `home` (every process gets each with the same bits: an
    ``all-gather`` over the sources); the per-block CE means and MoE
    router fractions before the step's mean, a leaf's norm before the
    global one.  Its transpose hands each source its gradient from its own
    process's copy, with nothing on the wire."""
    return _run(_ToHome(mesh, srcs, scope_path()), list(parts))


def _holders(placed: Placed) -> List[List[int]]:
    """The shards holding each distinct slice, in the order of
    `distinct`."""
    mesh = placed.mesh
    by: Dict[tuple, List[int]] = {}
    for i in range(mesh.size):
        key = tuple((s.start, s.stop) for s in local_slices(
            placed.shape, placed.spec, mesh, i))
        by.setdefault(key, []).append(i)
    return list(by.values())


@torch.no_grad()
def gather_whole(placed: Placed, device=None) -> torch.Tensor:
    """`Placed.full`: the whole tensor on `device` (default `home`), each
    distinct slice from a shard of this process that holds it, else from
    the first that does (an ``all-gather`` over the distinct slices)."""
    mesh = placed.mesh
    dev = torch.device(device) if device is not None else home(mesh)
    hold = _holders(placed)
    procs = set(mesh.owners or ())
    send = [h[0] for h in hold
            if mesh.owners is not None and {mesh.owners[i] for i in h}
            != procs]
    with _arithmetic():
        vis = dict(zip(send, _readable(mesh, [(i, placed.parts[i])
                                              for i in send])))
        out = torch.empty(placed.shape, dtype=placed.dtype, device=dev)
        for h in hold:
            mine = [i for i in h if is_local(mesh, i)]
            src = placed.parts[mine[0]] if mine else vis[h[0]]
            out[local_slices(placed.shape, placed.spec, mesh, h[0])] = \
                src.to(dev)
        width = max(_nbytes(placed.parts[h[0]]) for h in hold)
        whole = math.prod(placed.shape) * placed.parts[0].element_size()
        return _finish([out], "all-gather", len(hold), width, whole, None,
                       [(None, width + whole)])[0]


@torch.no_grad()
def argmax(logits: Placed, limit: int) -> torch.Tensor:
    """The argmax over the last dim of placed logits [B, V] (the vocab over
    some axes or whole), the columns at and past `limit` left out, ties to
    the lower index as ``torch.argmax``: each shard's local argmax, then
    across the vocab shards in order a later one wins only when strictly
    greater (an ``all-reduce`` of (value, index) pairs), then the batch
    blocks gathered (`gather_whole`).  Returns int64 [B] on `home`."""
    with scope("argmax"):
        return _argmax(logits, limit)


def _argmax(logits: Placed, limit: int) -> torch.Tensor:
    mesh = logits.mesh
    vocab_axes = entry_axes(logits.spec[-1] if len(logits.spec) ==
                            len(logits.shape) else None)
    pairs = []
    for i, part in enumerate(logits.parts):
        v0 = local_slices(logits.shape, logits.spec, mesh, i)[-1].start
        col = v0 + torch.arange(part.shape[-1], device=part.device)
        masked = torch.where(col < limit, part, float("-inf"))
        v, idx = masked.max(-1)
        pairs.append((v, idx + v0))
    gs = _groups(mesh, vocab_axes)
    with _arithmetic():
        wide = [i for g in gs if _spans(mesh, g) for i in g]
        got = iter(_readable(mesh, [(i, t) for i in wide
                                    for t in pairs[i]]))
        seen = {i: (next(got), next(got)) for i in wide}
        out: List[Optional[torch.Tensor]] = [None] * mesh.size
        for g in gs:
            mine = [i for i in g if is_local(mesh, i)]
            if not mine:
                for i in g:
                    out[i] = stand_in(pairs[i][1].shape, pairs[i][1].dtype)
                continue
            dev = mesh.devices[mine[0] if _spans(mesh, g) else g[0]]
            best_v = best_i = None
            for i in g:
                v, idx = (t.to(dev) for t in seen.get(i, pairs[i]))
                if best_v is None:
                    best_v, best_i = v, idx
                else:
                    take = v > best_v
                    best_v = torch.where(take, v, best_v)
                    best_i = torch.where(take, idx, best_i)
            for i in g:
                out[i] = best_i.to(mesh.devices[i]) if is_local(mesh, i) \
                    else stand_in(best_i.shape, best_i.dtype)
        nb = [sum(_nbytes(t) for t in p) for p in pairs]
        out = _finish(out, "all-reduce", len(gs[0]), nb[0], 0, None,
                      [(i, b + _nbytes(o)) for i, (b, o) in
                       enumerate(zip(nb, out))], [p[1] for p in pairs])
    batch = Placed(tuple(out), (logits.spec[0] if logits.spec else None,),
                   mesh, (logits.shape[0],))
    return batch.full()
