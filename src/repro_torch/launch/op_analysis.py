"""Trip-count-aware op analysis of one step, for the roofline (the
counterpart of ``src/repro/launch/hlo_analysis.py``).

The reference parses the optimized HLO of a compiled step.  The port runs
eagerly and compiles nothing, so there is no HLO: what the card runs is
the sequence of aten ops the step dispatches, one kernel each.
`OpCounter`, a ``TorchDispatchMode``, sees every one of them (the
forward, autograd's backward and a checkpointed layer's recompute alike)
and counts:

* dot FLOPs, with ``torch.utils.flop_counter``'s registry (mm, bmm, addmm,
  baddbmm, the convolutions and the sdpa kernels), as ``FlopCounterMode``
  counts them, also by the dtype of the operands;
* HBM bytes, ``hbm_bytes_est``: each op's inputs read and outputs written.
  Eager PyTorch fuses nothing, so this is what the card moves.  As in the
  reference, a view moves nothing, an indexed read moves the rows it
  touches (2 x out + indices) and an indexed write the rows it updates (2
  x updates + indices); an op that only writes its destination (``copy_``,
  ``zeros_like``) does not read it;
* ``hbm_bytes_lower``: the step's arguments read once and its fresh
  outputs written once (so ``lower <= est``);
* the peak of live bytes the step allocates, from storage allocations and
  frees (a weak reference on each new storage: PyTorch keeps one Python
  object per live storage, meta storages included), each allocation
  rounded up to 512 bytes as the CUDA caching allocator counts it;
* each count by aten op (``hbm_by_op``) and by the ``nn.Module`` path that
  issued it (layer indices folded to ``*``): the counterpart of the
  reference's ``op_name`` metadata, which `launch.profile` reads.  A
  forward op takes the innermost module running; a backward op the
  innermost module whose forward created the autograd node being run
  (each module call's range of autograd sequence numbers).  No hook is
  put on a tensor: ``ModuleTracker``'s gradient hooks hold activations in
  reference cycles until the garbage collector runs, which would move the
  peak from run to run.

Over a mesh (`OpCounter(mesh=)`, the step of a model placed on a
`ShardMesh` of meta devices) every collective of
`repro_torch.models.sharding` is counted from its record (kind, group
size, bytes in and out: the wire bytes one device moves by the reference's
ring formulas, the raw bytes, by `sharding.scope` path; and each member's
device charged the bytes it reads and writes, as an op ``collective``, its
out the member's), not from the ops that stand for it on one device
(`sharding.inside_collective`), and every other op is attributed to the
shard it computes for: the shard whose tensors it reads (a shard's params,
inputs and what its ops and its collectives made); a fresh tensor (a
factory's) is charged to the first shard that reads it, and work on whole
values (the loss, the global norm: `HOME`) to every device.  The counts
hold each shard's device's (``shards``), which `extend` extends shard by
shard; `busiest` then takes one device's: the busiest shard's (by dot
FLOPs, then bytes), with ``by_shard`` saying what each shard did.  The meta
device cannot tell the shards' tensors apart, which is why the
attribution follows the tensors; an op that reads two shards' tensors
outside a collective is a move the collectives missed, and raises.  The
shards repeat one another's ops on tensors of the same shapes, so a
functional op's meta result is made once per signature (`OpCounter._meta`).

Repeated work is counted once and multiplied, as `rollup` multiplies a
``while`` body by its trip count.  `extend` traces the step at a few
corners, each repeated loop cut to ``lo`` or ``lo + 1`` trips (the layer
stacks through the config, the loops in the model code through
`repro_torch.models.loops`), and extends every count linearly to the real
trip counts: the difference of two corners is one body's cost.  The counts
of identical iterations are linear in the trip count, so FLOPs and bytes
come out exact (tested against the unrolled step, op for op); the peak is
extended the same way and is exact where the peak falls at the same place
in the step at every depth.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
import weakref
from fractions import Fraction
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.nn.modules.module import (register_module_forward_hook,
                                     register_module_forward_pre_hook)
from torch.utils.flop_counter import flop_registry

from repro_torch.core.distributed import ShardMesh
from repro_torch.models import sharding, specs

ALLOC_UNIT = 512           # the CUDA caching allocator's rounding
TOP_LEVEL = "(step)"       # ops issued outside every module
MODEL_LEVEL = "(model)"    # the root module's own ops (embed, head, ...)
HOME = "home"              # over a mesh: whole values, every device's

_NO_KERNEL = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}
# ops that write their destination (or a fresh output) without reading it
_WRITE_ONLY = {"copy_", "zeros_like", "ones_like", "new_zeros"}
_INDEX_READ = {"index", "gather", "index_select"}
_INDEX_WRITE = {"index_put_"}


_LEAVES = (int, float, bool, str, bytes, type(None), torch.dtype,
           torch.device, torch.memory_format, torch.layout)
_NAMES: Dict[object, str] = {}      # an op packet's name
_FUNCTIONAL: Dict[object, bool] = {}   # an op neither writes nor views


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a nest of modules, dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        out = []
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif not isinstance(x, _LEAVES):
                out += _tensors(x)
        return out
    if isinstance(tree, _LEAVES):
        return []
    if isinstance(tree, dict):
        return _tensors(tuple(tree.values()))
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, Mapping):
        tree = tree.values()
    if isinstance(tree, (list, tuple)) or hasattr(tree, "__iter__") and \
            not isinstance(tree, (str, bytes)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _signature(x):
    """A hashable stand-in for an op's arguments: each tensor by its shape,
    strides, dtype and device."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in x.items())
    return x


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> Tuple[int, set]:
    """(bytes of the distinct storages under `tree`, their ids)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total, seen


def _round(n: int) -> int:
    return -(-n // ALLOC_UNIT) * ALLOC_UNIT


def module_path(name: str) -> str:
    """A module's qualified name with its layer indices folded to ``*``
    (the root module's own ops: `MODEL_LEVEL`)."""
    return re.sub(r"(?<=\.)\d+(?=\.|$)|^\d+(?=\.|$)", "*", name) \
        or MODEL_LEVEL


@dataclasses.dataclass
class Counts:
    """One step's counts; integers, so `combine` extends them exactly."""

    dot_flops: int = 0
    dot_flops_by_dtype: Dict[str, int] = dataclasses.field(default_factory=dict)
    hbm_bytes_est: int = 0
    hbm_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_module: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)      # path -> {"dot_flops", "hbm_bytes", "ops"}
    n_ops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0            # peak of the step's live allocations
    # collectives (over a mesh): wire bytes one device moves by kind
    # (exact fractions), raw bytes (max of in and out), op count, and the
    # wire bytes by scope path
    collective_wire: Dict[str, Fraction] = dataclasses.field(
        default_factory=dict)
    collective_raw: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_by_module: Dict[str, Dict[str, Fraction]] = \
        dataclasses.field(default_factory=dict)
    # over a mesh: each shard's {"dot_flops", "hbm_bytes", "ops"}, and the
    # shard whose counts these are (-1: no mesh; `busiest`)
    by_shard: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    device_shard: int = -1
    # a mesh trace's counts of each shard's device (`busiest` picks one)
    shards: Dict[int, "Counts"] = dataclasses.field(default_factory=dict)

    @property
    def hbm_bytes_lower(self) -> int:
        return self.argument_bytes + self.output_bytes - self.alias_bytes


_NESTED = ("by_module", "collective_by_module", "by_shard")


def combine(terms: List[Tuple[int, Counts]]) -> Counts:
    """sum(weight x counts), key by key (a mesh trace's shards each
    alone)."""
    out = Counts()
    shards: Dict[int, list] = {}
    for w, c in terms:
        for k, sub in c.shards.items():
            shards.setdefault(k, []).append((w, sub))
        for f in dataclasses.fields(Counts):
            if f.name in ("device_shard", "shards"):
                continue
            a, b = getattr(out, f.name), getattr(c, f.name)
            if f.name in _NESTED:
                for path, d in b.items():
                    acc = a.setdefault(path, {})
                    for k, v in d.items():
                        acc[k] = acc.get(k, 0) + w * v
            elif isinstance(b, dict):
                for k, v in b.items():
                    a[k] = a.get(k, 0) + w * v
            else:
                setattr(out, f.name, a + w * b)
    for f in ("dot_flops_by_dtype", "hbm_by_op", "collective_wire",
              "collective_raw", "collective_ops"):
        setattr(out, f, {k: v for k, v in getattr(out, f).items() if v})
    for f in _NESTED:
        setattr(out, f, {p: d for p, d in getattr(out, f).items()
                         if any(d.values())})
    out.shards = {k: combine(v) for k, v in shards.items()}
    return out


def busiest(counts: Counts) -> Counts:
    """One device's counts of a mesh trace: the busiest shard's (by dot
    FLOPs, then bytes, the lower index on a tie), with the step's
    collectives and each shard's summary (``by_shard``)."""
    k = max(counts.shards, key=lambda i: (counts.shards[i].dot_flops,
                                          counts.shards[i].hbm_bytes_est,
                                          -i))
    out = dataclasses.replace(counts.shards[k], shards={}, device_shard=k)
    for f in ("collective_wire", "collective_raw", "collective_ops",
              "collective_by_module"):
        setattr(out, f, getattr(counts, f))
    out.by_shard = {str(i): {"dot_flops": c.dot_flops,
                             "hbm_bytes": c.hbm_bytes_est, "ops": c.n_ops}
                    for i, c in sorted(counts.shards.items())}
    return out


class OpCounter(TorchDispatchMode):
    """Counts every aten op run inside it into `counts` (see the module
    docstring); `run` counts one call of a step.  With `mesh`, the step of
    a model placed on it: `counts` then holds each shard's device's
    (`busiest` picks one)."""

    def __init__(self, mesh: Optional[ShardMesh] = None):
        super().__init__()
        self.counts = Counts()
        self.mesh = mesh
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._live_bytes = 0
        self._names: Dict[int, str] = {}     # id(module) -> folded path
        self._stack: List[Tuple[str, int]] = []   # (module, first seq nr)
        self._calls: List[Tuple[int, int, int, str]] = []  # seq range, depth
        self._by_seq: Dict[int, str] = {}
        self._hooks = ()
        # over a mesh: whose each storage is (a shard or HOME),
        # the ops charged to no one yet (by the fresh storage they made),
        # each one's counts, whose each live storage's bytes are
        self._tag: Dict[int, object] = {}
        self._pending: Dict[int, list] = {}
        self._by: Dict[object, Counts] = {}
        self._owner: Dict[int, object] = {}
        self._live_by: Dict[object, int] = {}
        self._peak_by: Dict[object, int] = {}
        self._made: Dict[tuple, tuple] = {}
        self._coll = sharding.CollectiveCounter()

    def record_collective(self, kind: Optional[str], n: int,
                          in_bytes: int, out_bytes: int, path: str,
                          members=()) -> None:
        """`sharding`'s counter hook: one collective, one device's wire
        bytes; over a mesh each member's out (a tensor of its own) becomes
        its shard's (None: a whole value, `HOME`), and where data crosses
        between devices the member's device is charged the bytes it reads
        and writes (an op named ``collective``)."""
        self._coll.record_collective(kind, n, in_bytes, out_bytes,
                                     module_path(path))
        if self.mesh is None:
            return
        moved = kind is not None and n > 1
        for who, nbytes, out in members:
            who = HOME if who is None else who
            if out is not None:
                self._alloc(out, set(), who)
                self._tag[id(out.untyped_storage())] = who
            if moved and nbytes:
                self._charge(self._counts(who), (self._path(), "collective",
                                                 0, None, nbytes))

    def _free(self, key: int) -> None:
        self._refs.pop(key, None)
        nb = self._live.pop(key, 0)
        self._live_bytes -= nb
        if self.mesh is not None:
            self._tag.pop(key, None)
            self._pending.pop(key, None)
            who = self._owner.pop(key, None)
            self._live_by[who] = self._live_by.get(who, 0) - nb

    def _alloc(self, t: torch.Tensor, inputs: set, who=None) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in inputs or key in self._live:
            return
        nb = _round(st.nbytes())
        self._live[key] = nb
        self._refs[key] = weakref.ref(st, lambda _r, k=key: self._free(k))
        self._live_bytes += nb
        self.counts.temp_bytes = max(self.counts.temp_bytes, self._live_bytes)
        if self.mesh is not None:
            self._owner[key] = who
            self._grow(who, nb)

    def _grow(self, who, nb: int) -> None:
        self._live_by[who] = self._live_by.get(who, 0) + nb
        if who is not None:
            self._peak_by[who] = max(self._peak_by.get(who, 0),
                                     self._live_by[who])

    # -- module attribution -------------------------------------------
    def _name(self, mod) -> str:
        return self._names.get(id(mod)) or type(mod).__name__

    def _pre(self, mod, _inputs) -> None:
        self._stack.append((self._name(mod),
                            torch._C._autograd._get_sequence_nr()))

    def _post(self, mod, _inputs, _out) -> None:
        name, s0 = self._stack.pop()
        if torch._C._current_graph_task_id() == -1:   # not a recompute
            self._calls.append((s0, torch._C._autograd._get_sequence_nr(),
                                len(self._stack), name))

    def _path(self) -> str:
        if self._stack:
            return self._stack[-1][0]
        node = torch._C._current_autograd_node()
        if node is None:
            scoped = sharding.scope_path()
            return module_path(scoped) if scoped else TOP_LEVEL
        seq = node._sequence_nr()
        if seq not in self._by_seq:
            inner = [(depth, name) for s0, s1, depth, name in self._calls
                     if s0 <= seq < s1]
            self._by_seq[seq] = max(inner)[1] if inner else TOP_LEVEL
        return self._by_seq[seq]

    def __enter__(self):
        self._hooks = (register_module_forward_pre_hook(self._pre),
                       register_module_forward_hook(self._post))
        sharding._RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            sharding._RECORDERS.remove(self)
            for h in self._hooks:
                h.remove()

    @staticmethod
    def _charge(c: Counts, rec) -> None:
        path, name, flops, dt, b = rec
        c.n_ops += 1
        mod = c.by_module.setdefault(path, {"dot_flops": 0, "hbm_bytes": 0,
                                            "ops": 0})
        mod["ops"] += 1
        if dt is not None:
            c.dot_flops += flops
            c.dot_flops_by_dtype[dt] = c.dot_flops_by_dtype.get(dt, 0) + flops
            mod["dot_flops"] += flops
        if b:
            c.hbm_bytes_est += b
            c.hbm_by_op[name] = c.hbm_by_op.get(name, 0) + b
            mod["hbm_bytes"] += b

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if sharding.inside_collective():    # counted from its record
            return func(*args, **kwargs)
        out = self._meta(func, args, kwargs) if self.mesh is not None \
            else func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_storages = {id(t.untyped_storage()) for t in ins}
        packet = func._overloadpacket
        flops, dt = 0, None
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "?"
        name = _NAMES.get(packet)
        if name is None:
            name = _NAMES[packet] = str(packet)
        rec = (self._path(), name, flops, dt,
               self._bytes(func, args, ins, outs, in_storages))
        if self.mesh is None:
            for t in outs:
                self._alloc(t, in_storages)
            self._charge(self.counts, rec)
            return out
        self._attribute(func, rec, ins, outs, in_storages)
        return out

    def _meta(self, func, args, kwargs):
        """``func(*args, **kwargs)``; over a mesh the shards repeat one
        another's ops on tensors of the same shapes, so a functional op (one
        that neither writes nor views its inputs) whose signature was seen
        before makes fresh meta tensors of the shapes it made then, without
        running its meta kernel again."""
        functional = _FUNCTIONAL.get(func)
        if functional is None:
            schema = func._schema
            functional = _FUNCTIONAL[func] = not func.is_view and all(
                a.alias_info is None for a in (*schema.arguments,
                                               *schema.returns))
        if not functional:
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        made = self._made.get(key)
        if made is None or made is False:
            out = func(*args, **kwargs)
            if made is None:
                leaves = out if isinstance(out, (tuple, list)) else (out,)
                ins = {id(t.untyped_storage()) for t in _tensors(
                    (args, kwargs))}
                # not an op that hands back an input (a view by another
                # name), nor one that makes anything but meta tensors
                self._made[key] = all(
                    isinstance(t, torch.Tensor) and t.device.type == "meta"
                    and id(t.untyped_storage()) not in ins
                    for t in leaves) and (type(out) if isinstance(
                        out, (tuple, list)) else None, [
                        (tuple(t.shape), t.stride(), t.dtype)
                        for t in leaves])
            return out
        kind, metas = made
        fresh = [torch.empty_strided(shape, stride, dtype=dt, device="meta")
                 for shape, stride, dt in metas]
        return fresh[0] if kind is None else kind(fresh)

    def _attribute(self, func, rec, ins, outs, in_storages) -> None:
        """Charge one op over a mesh to the shard it computes for (see the
        module docstring), or hold it until a shard reads what it made."""
        tags = {self._tag[k] for k in in_storages if k in self._tag}
        shards = tags - {HOME}
        if len(shards) > 1:
            raise RuntimeError(
                f"{func} reads the tensors of shards {sorted(shards)}: "
                "a move between shards outside the collectives of "
                "repro_torch.models.sharding")
        who = shards.pop() if shards else (HOME if tags else None)
        held = [k for k in in_storages if k in self._pending]
        out_keys = [id(t.untyped_storage()) for t in outs]
        for t in outs:
            self._alloc(t, in_storages, who)
        if who is None:
            recs = [rec] + [r for k in held for r in self._pending.pop(k)]
            key = next((k for k in out_keys if k not in in_storages),
                       out_keys[0] if out_keys else
                       (held[0] if held else None))
            if key is not None:
                self._pending.setdefault(key, []).extend(recs)
            else:
                self._charge(self._counts(HOME), rec)
            return
        c = self._counts(who)
        self._charge(c, rec)
        for k in held:
            for r in self._pending.pop(k):
                self._charge(c, r)
            if self._owner.get(k, who) is None:   # its bytes are who's now
                nb = self._live.get(k, 0)
                self._owner[k] = who
                self._live_by[None] = self._live_by.get(None, 0) - nb
                self._grow(who, nb)
        for k in out_keys:
            if self._tag.get(k) in (None, HOME):
                self._tag[k] = who

    def _counts(self, who) -> Counts:
        c = self._by.get(who)
        if c is None:
            c = self._by[who] = Counts()
        return c

    @staticmethod
    def _bytes(func, args, ins, outs, in_storages) -> int:
        name = func._overloadpacket.__name__
        if name in _NO_KERNEL or func.is_view:
            return 0
        schema = func._schema
        written = []
        for a, v in zip(schema.arguments, args):
            if a.alias_info is not None and a.alias_info.is_write:
                written += _tensors(v)
        if not written and outs and all(
                id(t.untyped_storage()) in in_storages for t in outs):
            return 0                                # a view by another name
        if name in _INDEX_READ:
            idx = sum(nbytes(t) for t in ins[1:])
            return 2 * sum(nbytes(t) for t in outs) + idx
        if name in _INDEX_WRITE:                # (self, indices, values)
            *idx, values = ins[1:]
            return 2 * nbytes(values) + sum(nbytes(t) for t in idx)
        distinct = {id(t): t for t in ins}
        if name in _WRITE_ONLY:     # copy_ reads its source, a factory none
            skip = {id(w) for w in written} if written else set(distinct)
            distinct = {k: t for k, t in distinct.items() if k not in skip}
        reads = sum(nbytes(t) for t in distinct.values())
        in_ids = {id(t) for t in ins}
        writes = sum(nbytes(t) for t in written) + sum(
            nbytes(t) for t in outs if id(t) not in in_ids)
        return reads + writes

    def run(self, fn: Callable, *args):
        """``fn(*args)`` counted; its arguments and outputs sized."""
        c = self.counts
        if self.mesh is not None:
            args_by = _placed_storages(args, self._tag)
        c.argument_bytes, arg_ids = storage_bytes(args)
        for a in args:
            if isinstance(a, torch.nn.Module):
                self._names.update((id(m), module_path(n))
                                   for n, m in a.named_modules())
        with self:
            out = fn(*args)
        coll = self._coll
        c.collective_wire, c.collective_raw = coll.wire, coll.raw
        c.collective_ops, c.collective_by_module = coll.ops, coll.by_path
        if self.mesh is not None:
            self.counts = self._per_device(args_by, _placed_storages(
                out, self._tag))
            return out
        c.output_bytes, out_ids = storage_bytes(out)
        c.alias_bytes = sum(
            t.untyped_storage().nbytes() for t in
            {id(t.untyped_storage()): t for t in _tensors(out)
             if id(t.untyped_storage()) in arg_ids}.values())
        return out

    def _per_device(self, args_by, outs_by) -> Counts:
        """Each shard's device's counts: its own work and the whole values'
        (every device's), its arguments and outputs, with the step's
        collectives (`busiest` picks one device)."""
        home = HOME
        for recs in self._pending.values():
            for r in recs:
                self._charge(self._counts(home), r)
        self._pending.clear()
        out = Counts()
        c = self.counts
        for f in ("collective_wire", "collective_raw", "collective_ops",
                  "collective_by_module"):
            setattr(out, f, getattr(c, f))
        shared = self._by.get(home)
        for k, mine in self._by.items():
            if k == home:
                continue
            dev = combine([(1, x) for x in (mine, shared) if x is not None])
            dev.temp_bytes = self._peak_by.get(k, 0) + self._peak_by.get(
                home, 0)
            a = {w: v for w, v in args_by.items() if w in (k, home)}
            o = {w: v for w, v in outs_by.items() if w in (k, home)}
            dev.argument_bytes = sum(b for b, _ in a.values())
            dev.output_bytes = sum(b for b, _ in o.values())
            dev.alias_bytes = sum(
                nb for w in o for key, nb in o[w][1].items()
                if key in a.get(w, (0, {}))[1])
            out.shards[k] = dev
        return out


def _placed_storages(tree, tags: Dict[int, object]
                     ) -> Dict[object, Tuple[int, Dict[int, int]]]:
    """{shard or `HOME`: (bytes, {storage id: bytes})} of the
    distinct storages under `tree`: a placed model's shards and a placed
    tensor's parts by shard (tagged so in `tags`, the roots of
    `OpCounter`'s attribution), a whole tensor by its tag or else as every
    device's (`HOME`)."""
    out: Dict[object, Dict[int, int]] = {}

    def add(t: torch.Tensor, who) -> None:
        st = t.untyped_storage()
        key = id(st)
        if who is None:
            who = tags.get(key, HOME)
        else:
            tags.setdefault(key, who)
        out.setdefault(who, {})[key] = st.nbytes()

    def walk(x, who=None) -> None:
        if isinstance(x, torch.Tensor):
            add(x, who)
        elif isinstance(x, specs.ShardedLM):
            for i, sh in enumerate(x.shards):
                for t in sh.values():
                    add(t, i)
        elif isinstance(x, (sharding.Placed, sharding.Joined)):
            for i, t in enumerate(x.parts):
                add(t, i)
        elif isinstance(x, Mapping):
            for v in x.values():
                walk(v, who)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v, who)
    walk(tree)
    return {who: (sum(d.values()), d) for who, d in out.items()}


# ---------------------------------------------------------------------------
# extension across trip counts
# ---------------------------------------------------------------------------

def extend(trace: Callable[[Dict[str, int]], Tuple[Counts, Dict[str, int]]],
           axes: Dict[str, int], lo: int = 2) -> Tuple[Counts, int]:
    """Counts at the real trip counts from traces at cut ones.

    `axes` maps each repeated loop known in advance (the layer stacks) to
    its real trip count.  ``trace(trips)`` traces the step with each loop
    cut to ``trips[name]`` (the model code's loops not named there to
    ``trips["*"]``) and returns (counts, {model-code loop: its real trip
    count}).  Every loop longer than `lo` is traced at ``lo`` and ``lo +
    1`` trips and extended linearly; the corners of several loops combine
    multilinearly (nested loops multiply).  Returns (counts, traces run).
    """
    base = {a: min(n, lo) for a, n in axes.items()}
    counts, seen = trace({**base, "*": lo})
    real = {**axes, **seen}
    base.update({a: min(n, lo) for a, n in seen.items()})
    done = {tuple(sorted(base.items())): counts}

    def at(trips: Dict[str, int]) -> Counts:
        key = tuple(sorted(trips.items()))
        if key not in done:
            done[key], again = trace({**trips, "*": lo})
            if again != seen:
                raise ValueError(f"the step's loops changed with their cut: "
                                 f"{seen}, then {again}")
        return done[key]

    long_ = sorted(a for a, n in real.items() if n > lo)
    terms = []
    for corner in itertools.product((0, 1), repeat=len(long_)):
        trips, w = dict(base), 1
        for a, up in zip(long_, corner):
            trips[a] = lo + up
            w *= (real[a] - lo) if up else (lo + 1 - real[a])
        if w:
            terms.append((w, at(trips)))
    return combine(terms), len(done)
