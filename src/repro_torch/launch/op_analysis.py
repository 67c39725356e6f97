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
from typing import Callable, Dict, List, Mapping, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.nn.modules.module import (register_module_forward_hook,
                                     register_module_forward_pre_hook)
from torch.utils.flop_counter import flop_registry

ALLOC_UNIT = 512           # the CUDA caching allocator's rounding
TOP_LEVEL = "(step)"       # ops issued outside every module
MODEL_LEVEL = "(model)"    # the root module's own ops (embed, head, ...)

_NO_KERNEL = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}
# ops that write their destination (or a fresh output) without reading it
_WRITE_ONLY = {"copy_", "zeros_like", "ones_like", "new_zeros"}
_INDEX_READ = {"index", "gather", "index_select"}
_INDEX_WRITE = {"index_put_"}


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a nest of modules, dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, Mapping):
        tree = tree.values()
    if isinstance(tree, (list, tuple)) or hasattr(tree, "__iter__") and \
            not isinstance(tree, (str, bytes)):
        return [t for x in tree for t in _tensors(x)]
    return []


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

    @property
    def hbm_bytes_lower(self) -> int:
        return self.argument_bytes + self.output_bytes - self.alias_bytes


def combine(terms: List[Tuple[int, Counts]]) -> Counts:
    """sum(weight x counts), key by key."""
    out = Counts()
    for w, c in terms:
        for f in dataclasses.fields(Counts):
            a, b = getattr(out, f.name), getattr(c, f.name)
            if f.name == "by_module":
                for path, d in b.items():
                    acc = a.setdefault(path, {})
                    for k, v in d.items():
                        acc[k] = acc.get(k, 0) + w * v
            elif isinstance(b, dict):
                for k, v in b.items():
                    a[k] = a.get(k, 0) + w * v
            else:
                setattr(out, f.name, a + w * b)
    for f in ("dot_flops_by_dtype", "hbm_by_op"):
        setattr(out, f, {k: v for k, v in getattr(out, f).items() if v})
    out.by_module = {p: d for p, d in out.by_module.items() if any(d.values())}
    return out


class OpCounter(TorchDispatchMode):
    """Counts every aten op run inside it into `counts` (see the module
    docstring); `run` counts one call of a step."""

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._live_bytes = 0
        self._names: Dict[int, str] = {}     # id(module) -> folded path
        self._stack: List[Tuple[str, int]] = []   # (module, first seq nr)
        self._calls: List[Tuple[int, int, int, str]] = []  # seq range, depth
        self._by_seq: Dict[int, str] = {}
        self._hooks = ()

    def _free(self, key: int) -> None:
        self._refs.pop(key, None)
        self._live_bytes -= self._live.pop(key, 0)

    def _alloc(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in inputs or key in self._live:
            return
        nb = _round(st.nbytes())
        self._live[key] = nb
        self._refs[key] = weakref.ref(st, lambda _r, k=key: self._free(k))
        self._live_bytes += nb
        self.counts.temp_bytes = max(self.counts.temp_bytes, self._live_bytes)

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
            return TOP_LEVEL
        seq = node._sequence_nr()
        if seq not in self._by_seq:
            inner = [(depth, name) for s0, s1, depth, name in self._calls
                     if s0 <= seq < s1]
            self._by_seq[seq] = max(inner)[1] if inner else TOP_LEVEL
        return self._by_seq[seq]

    def __enter__(self):
        self._hooks = (register_module_forward_pre_hook(self._pre),
                       register_module_forward_hook(self._post))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for h in self._hooks:
                h.remove()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_storages = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            self._alloc(t, in_storages)
        c = self.counts
        c.n_ops += 1
        path = self._path()
        mod = c.by_module.setdefault(path, {"dot_flops": 0, "hbm_bytes": 0,
                                            "ops": 0})
        mod["ops"] += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            c.dot_flops += f
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "?"
            c.dot_flops_by_dtype[dt] = c.dot_flops_by_dtype.get(dt, 0) + f
            mod["dot_flops"] += f
        b = self._bytes(func, args, ins, outs, in_storages)
        if b:
            name = str(packet)
            c.hbm_bytes_est += b
            c.hbm_by_op[name] = c.hbm_by_op.get(name, 0) + b
            mod["hbm_bytes"] += b
        return out

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
        c.argument_bytes, arg_ids = storage_bytes(args)
        for a in args:
            if isinstance(a, torch.nn.Module):
                self._names.update((id(m), module_path(n))
                                   for n, m in a.named_modules())
        with self:
            out = fn(*args)
        c.output_bytes, out_ids = storage_bytes(out)
        c.alias_bytes = sum(
            t.untyped_storage().nbytes() for t in
            {id(t.untyped_storage()): t for t in _tensors(out)
             if id(t.untyped_storage()) in arg_ids}.values())
        return out


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
