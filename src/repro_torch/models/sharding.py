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

The mesh is the port's single-controller `ShardMesh`
(`repro_torch.core.distributed`): one process drives every shard, shard i
on ``mesh.devices[i]`` in the reference's row-major order, and devices may
repeat (eight shards on one card).  Where the reference's GSPMD holds one
global array with a sharding, the port holds a `Placed`: one local piece
per shard, each on its shard's device, and the placement that cut them.
The model code runs Megatron-style tensor parallelism on the local pieces
(`repro_torch.models.lm`); the only traffic between shards is the
collectives at the end of this file, each of which runs in shard order.
On one card a collective is an add or a concatenation on that card; on
several cards its operands are copied device to device (``.to(dev)``).

Training differentiates through them: one process builds one autograd
graph over every shard, so the backward of `all_gather` (a concatenation)
already sums the uses of a gathered piece, and that of `all_sum` hands
each part the sum of its group's output gradients.  A piece the placement
replicates is a copy on each shard, whose gradient covers only its own
shard's use; `replica_sum` adds the copies' gradients (the transpose of
the reference's implicit GSPMD psum, its data-parallel gradient sum).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
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
        """The whole tensor on `device` (default: shard 0's), each slice
        copied from the first shard that holds it (`distinct`); a value,
        outside autograd."""
        dev = torch.device(device) if device is not None else \
            self.parts[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for i in distinct(self.shape, self.spec, self.mesh):
            out[local_slices(self.shape, self.spec, self.mesh, i)] = \
                self.parts[i].to(dev)
        return out


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
# collectives: each over mesh axes, in shard order, computed once per
# device of a group (the shards of a group on one card share the result)
# ---------------------------------------------------------------------------

Axes = Union[str, Sequence[str]]


def _axis_tuple(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def all_sum(parts: Sequence[torch.Tensor], mesh: ShardMesh,
            axis: Axes) -> List[torch.Tensor]:
    """Each shard's part summed over the shards of its group on `axis` (an
    axis name or several: ``psum``), in row-major shard order with f32
    accumulation for 16-bit parts, then in the parts' dtype.  Every member
    computes the same sum in the same order, so the members of a group get
    the same bits."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for g in groups(mesh, _axis_tuple(axis)):
        done: Dict[torch.device, torch.Tensor] = {}
        for i in g:
            dev = mesh.devices[i]
            if dev not in done:
                acc = parts[g[0]].to(dev)
                if len(g) > 1:
                    if acc.dtype in (torch.bfloat16, torch.float16):
                        acc = acc.float()
                    for j in g[1:]:
                        acc = acc + parts[j].to(dev)
                done[dev] = acc.to(parts[i].dtype)
            out[i] = done[dev]
    return out


def all_max(parts: Sequence[torch.Tensor], mesh: ShardMesh,
            axis: Axes) -> List[torch.Tensor]:
    """Each shard's part's elementwise maximum over its group on `axis`
    (``pmax``); exact, so every member gets the same bits."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for g in groups(mesh, _axis_tuple(axis)):
        done: Dict[torch.device, torch.Tensor] = {}
        for i in g:
            dev = mesh.devices[i]
            if dev not in done:
                acc = parts[g[0]].to(dev)
                for j in g[1:]:
                    acc = torch.maximum(acc, parts[j].to(dev))
                done[dev] = acc
            out[i] = done[dev]
    return out


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
    out, seen = [], set()
    for t in all_sum(parts, mesh, axes):
        if id(t) in seen:
            t = t.clone()
        seen.add(id(t))
        out.append(t)
    return out


def all_gather(parts: Sequence[torch.Tensor], mesh: ShardMesh, axis: str,
               dim: int) -> List[torch.Tensor]:
    """Each shard's part concatenated along `dim` with the parts of its
    group on `axis`, in axis order (``all_gather(tiled=True)``)."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for g in groups(mesh, (axis,)):
        done: Dict[torch.device, torch.Tensor] = {}
        for i in g:
            dev = mesh.devices[i]
            if dev not in done:
                done[dev] = (parts[g[0]].to(dev) if len(g) == 1 else
                             torch.cat([parts[j].to(dev) for j in g], dim))
            out[i] = done[dev]
    return out


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


def argmax(logits: Placed, limit: int) -> torch.Tensor:
    """The argmax over the last dim of placed logits [B, V] (the vocab over
    some axes or whole), the columns at and past `limit` left out, ties to
    the lower index as ``torch.argmax``: each shard's local argmax, then
    across the vocab shards in order a later one wins only when strictly
    greater.  Returns int64 [B] on shard 0's device."""
    mesh = logits.mesh
    vocab_axes = entry_axes(logits.spec[-1] if len(logits.spec) ==
                            len(logits.shape) else None)
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for g in groups(mesh, vocab_axes):
        dev = mesh.devices[g[0]]
        best_v = best_i = None
        for i in g:
            part = logits.parts[i]
            v0 = local_slices(logits.shape, logits.spec, mesh, i)[-1].start
            col = v0 + torch.arange(part.shape[-1], device=part.device)
            masked = torch.where(col < limit, part, float("-inf"))
            v, idx = masked.max(-1)
            v, idx = v.to(dev), (idx + v0).to(dev)
            if best_v is None:
                best_v, best_i = v, idx
            else:
                take = v > best_v
                best_v = torch.where(take, v, best_v)
                best_i = torch.where(take, idx, best_i)
        for i in g:
            out[i] = best_i.to(mesh.devices[i])
    batch = Placed(tuple(out), (logits.spec[0] if logits.spec else None,),
                   mesh, (logits.shape[0],))
    return batch.full()
