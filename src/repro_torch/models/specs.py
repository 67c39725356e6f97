"""Parameter and cache placements on a mesh: path-based rules +
divisibility sanitization, and a model placed by them.

Port of ``src/repro/models/specs.py``.  A mesh is a live `ShardMesh`
(`repro_torch.launch.mesh`) or, where only the placements are wanted, a
mapping of axis sizes (``{"data": 16, "model": 16}``, or ``{"pod": 2,
"data": 16, "model": 16}``): the dry run reads them that way to report the
per-device argument bytes of the reference's ``pod1`` (16 x 16) and
``pod2`` (2 x 16 x 16) meshes.  A placement is a tuple with one entry per
dimension: None, an axis name, or a tuple of axis names (a
``PartitionSpec``'s entries).  `place_params` cuts a model by them onto a
live mesh (`ShardedLM`: each shard holds its local piece of every leaf);
`gather_params` puts it back together.  `nest`, `flat_tree` and
`stacked_tree` move between '.'-joined keys and the reference's nested
params tree (a trainer's checkpoint layout).

Logical plan: TP over 'model' on heads / ffn-hidden / vocab / experts;
FSDP (ZeRO-3) over 'data' on the other big dim.  Any mapping whose dim
doesn't divide the axis product is dropped to replicated.  The reference
stacks a block group's leaves over a layer axis and places the stacked
leaf; the port's per-layer leaf takes that placement without its layer
axis.
"""
from __future__ import annotations

import functools
import math
import re
import types
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.models import sharding

Placement = Tuple[object, ...]

# (path regex, logical axes for the TRAILING dims of the param)
_RULES = [
    (r"embed/table$", ("model", "fsdp")),
    (r"head/w$", ("fsdp", "model")),
    # attention
    (r"(attn|cross)/wq$", ("fsdp", "model", None)),
    (r"(attn|cross)/wk$", ("fsdp", "model", None)),
    (r"(attn|cross)/wv$", ("fsdp", "model", None)),
    (r"(attn|cross)/wo$", ("model", None, "fsdp")),
    # moe (rank-3 expert weights) before dense mlp rules
    (r"mlp/wi$|mlp/wu$", (("expert", "fsdp", "model_ff"), ("fsdp", "model"))),
    (r"mlp/wo$", (("expert", "model_ff", "fsdp"), ("model", "fsdp"))),
    (r"mlp/router$", ("fsdp", None)),
    (r"mlp/shared/w[iu]$", ("fsdp", "model")),
    (r"mlp/shared/wo$", ("model", "fsdp")),
    # rwkv: time-mix projections column-parallel, wo row-parallel
    (r"/(wr|wk|wv|wg|ww|cwr)$", ("fsdp", "model")),
    (r"/wo$", ("model", "fsdp")),
    (r"/cwk$", ("fsdp", "model")),
    (r"/cwv$", ("model", "fsdp")),
    # mamba
    (r"/(w_x|w_z|w_dt)$", ("fsdp", "model")),
    (r"/w_bc$", ("fsdp", None)),
    (r"/out_proj$", ("model", "fsdp")),
]

_LOGICAL = {
    "model": ("model",),
    "model_ff": ("model",),
    "expert": ("model",),
    "fsdp": ("data",),
    None: (),
}

STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _match(path: str, ndim: int):
    for pat, spec in _RULES:
        if re.search(pat, path):
            if isinstance(spec[0], tuple):          # rank-dependent variants
                for variant in spec:
                    if len(variant) <= ndim:
                        return variant
                return spec[-1]
            return spec
    return None


def _sanitize(logical: Tuple, shape, sizes: Mapping[str, int]) -> Placement:
    ndim = len(shape)
    # pad leading dims (stacked layer axis etc.) with None
    full = (None,) * (ndim - len(logical)) + tuple(logical)
    out = []
    used = set()
    for dim, l in zip(shape, full):
        axes = _LOGICAL.get(l, ())
        axes = tuple(a for a in axes if a in sizes and a not in used)
        n = 1
        for a in axes:
            n *= sizes[a]
        if axes and n > 1 and dim % n == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return tuple(out)


def _reference_leaf(name: str, shape, cfg: ModelConfig):
    """(the reference's '/'-joined path, its stacked shape) of a port
    parameter: ``blocks.3.attn.wq`` [d, h, dh] -> ``blocks/attn/wq``
    [L, d, h, dh]."""
    parts = name.split(".")
    if parts[0] in STACKS:
        depth = {"blocks": cfg.num_layers, "enc_blocks": cfg.num_enc_layers,
                 "dec_blocks": cfg.num_dec_layers}[parts[0]]
        return "/".join([parts[0]] + parts[2:]), (depth, *shape)
    return "/".join(parts), tuple(shape)


Mesh = Union[ShardMesh, Mapping[str, int]]


def _sizes(mesh: Mesh) -> Mapping[str, int]:
    return sharding.axis_sizes(mesh) if isinstance(mesh, ShardMesh) else mesh


def param_specs(cfg: ModelConfig, sizes: Mesh,
                params=None, stacked: bool = False) -> Dict[str, Placement]:
    """{parameter name: placement} for every parameter of the port's model
    of `cfg` (built on the meta device unless `params`, an `lm.LM` or a
    {name: tensor} mapping, is given) on a mesh or its axis sizes; with
    `stacked`, a block leaf's is its stacked leaf's, the layer axis first
    (cut over 'model' where a stacked dense MLP's depth divides it, so a
    device holds whole layers of it: `shard_bytes` of a layer's bytes over
    that placement is a device's share of the stack, per layer)."""
    sizes = _sizes(sizes)
    if params is None:
        from repro_torch.models import lm
        params = lm.LM(cfg, device="meta")
    named = (dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else dict(params))
    out = {}
    for name, p in named.items():
        path, shape = _reference_leaf(name, p.shape, cfg)
        logical = _match(path, len(shape))
        if logical is None:          # norms / scalars / vectors: replicated
            out[name] = ()
            continue
        full = _sanitize(logical, shape, sizes)
        out[name] = full if stacked else full[len(shape) - p.dim():]
    return out


def cache_leaves(tree, prefix: str = ""):
    """(dotted path, tensor) of every leaf of a cache tree (NamedTuples and
    dicts; None leaves skipped)."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        yield prefix[:-1], tree
        return
    for key, value in items:
        yield from cache_leaves(value, f"{prefix}{key}.")


def cache_specs(cfg: ModelConfig, sizes: Mesh,
                caches) -> Dict[str, Placement]:
    """{cache leaf path: placement} with divisibility-guarded placement.

    Policy: batch over the data axes (DP); kv-heads / SSM heads / hidden
    over 'model' (TP).  When the batch is too small to shard (long_500k:
    B=1), the cache SEQUENCE axis takes the data axes instead.  Any mapping
    that does not divide is dropped.  (The port's own caches on a live mesh
    follow `attention.KVCache.shardit`, which replicates where this falls
    back to the sequence axis.)
    """
    sizes = _sizes(sizes)
    m = sizes.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = 1
    for a in batch_axes:
        dp *= sizes[a]

    def div(n: int, k: int) -> bool:
        return k > 0 and n % k == 0

    def assign(path: str, shape) -> Placement:
        nd = len(shape)
        last = path.split(".")[-1]
        spec = [None] * nd
        if last in ("k", "v") and nd in (4, 5):
            off = nd - 4               # stacked layer axis present?
            b, s, kvh = shape[off], shape[off + 1], shape[off + 2]
            model_used = False
            if div(kvh, m):
                spec[off + 2] = "model"
                model_used = True
            if div(b, dp):
                spec[off] = batch_axes
                if not model_used and div(s, m):
                    spec[off + 1] = "model"       # 'seq_kv' policy
            else:
                # small-batch long-context: sequence-shard over data axes
                seq_axes = list(batch_axes)
                if not model_used:
                    seq_axes.append("model")
                n = 1
                for a in seq_axes:
                    n *= sizes[a]
                if div(s, n):
                    spec[off + 1] = tuple(seq_axes)
                elif div(s, dp):
                    spec[off + 1] = batch_axes
            return tuple(spec)
        if last == "state" and nd >= 4:
            off = nd - 4               # [L?, B, H, ...]
            if div(shape[off], dp):
                spec[off] = batch_axes
            if div(shape[off + 1], m):
                spec[off + 1] = "model"
            return tuple(spec)
        if last in ("x_att", "x_ffn") and nd >= 2:
            if div(shape[nd - 2], dp):
                spec[nd - 2] = batch_axes
            if div(shape[nd - 1], m):
                spec[nd - 1] = "model"
            return tuple(spec)
        if last == "conv" and nd >= 3:
            if div(shape[nd - 3], dp):
                spec[nd - 3] = batch_axes
            if div(shape[nd - 1], m):
                spec[nd - 1] = "model"
            return tuple(spec)
        # fallback: shard the first dim that divides the data axes
        for i, d in enumerate(shape):
            if i > 0 and div(d, dp):   # dim 0 is usually the stacked layers
                spec[i] = batch_axes
                break
        return tuple(spec)

    return {path: _one_name(assign(path, tuple(t.shape)))
            for path, t in cache_leaves(caches)}


def _one_name(spec: Placement) -> Placement:
    """A one-axis tuple as its name (as ``PartitionSpec`` holds it)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def batch_spec(sizes: Mapping[str, int], shape) -> Placement:
    """Dim 0 over the data axes when divisible, else replicated (the
    reference's ``dryrun._batch_sharding``)."""
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    for a in axes:
        n *= sizes[a]
    first = axes if (len(shape) and shape[0] % n == 0) else None
    return _one_name((first, *([None] * (len(shape) - 1))))


def shard_bytes(nbytes: int, spec: Placement,
                sizes: Mapping[str, int]) -> int:
    """Bytes one device holds of a leaf of `nbytes` placed by `spec`."""
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n *= sizes[a]
    return nbytes // n


def mesh_sizes(multi_pod: bool) -> Dict[str, int]:
    """The reference's production mesh: 16 x 16 (``pod1``) or 2 x 16 x 16
    (``pod2``)."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def mesh_tag(multi_pod: bool) -> str:
    return "pod2" if multi_pod else "pod1"



# ---------------------------------------------------------------------------
# a model placed on a live mesh
# ---------------------------------------------------------------------------

def _tree_key(name: str) -> str:
    """The '.'-joined path of a parameter in the reference's tree, where a
    block group's leaves are stacked: ``blocks.3.attn.wq`` ->
    ``blocks.attn.wq``."""
    parts = name.split(".")
    return ".".join([parts[0]] + parts[2:]) if parts[0] in STACKS \
        else name


def _leaves(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                 torch.dtype]]:
    """{tree key: (shape, dtype)} of every leaf of the reference's params
    tree, block leaves stacked ``[L, ...]``, in the dtypes the port holds
    them."""
    from repro_torch.models import lm
    out = {}
    for name, p in lm.LM(cfg, device="meta").named_parameters():
        parts = name.split(".")
        if parts[0] in STACKS and parts[1] != "0":
            continue
        out[_tree_key(name)] = (_reference_leaf(name, p.shape, cfg)[1],
                                p.dtype)
    return out


def _placement(key: str, shape, sizes: Mapping[str, int]) -> Placement:
    logical = _match(key.replace(".", "/"), len(shape))
    return () if logical is None else _sanitize(logical, shape, sizes)


def _tp_spec(key: str, shape, sizes: Mapping[str, int]) -> Placement:
    """How the model code cuts a (per-layer) leaf of `shape` over 'model':
    the rule's placement at the leaf's own rank with only its 'model'
    entry kept (Megatron's column / row / vocab / expert cut)."""
    return tuple(e if e == "model" else None
                 for e in _placement(key, shape, sizes))


def param_shardings(cfg: ModelConfig, mesh: ShardMesh) -> dict:
    """`NamedSharding`s on `mesh` in the reference's params tree (nested
    dicts, block leaves stacked ``[L, ...]``, ``head`` empty when tied):
    the reference's `param_shardings`, in the layout of
    `repro_torch.convert.lm_params_to_numpy` and of checkpoints."""
    sizes = _sizes(mesh)
    return nest({key: sharding.NamedSharding(mesh,
                                             _placement(key, shape, sizes))
                 for key, (shape, _) in _leaves(cfg).items()})


def _namespace(flat: Dict[str, torch.Tensor]) -> types.SimpleNamespace:
    """{"attn.wq": t, ...} as attributes (``ns.attn.wq``), the shape of
    the modules the layer functions read."""
    root: dict = {}
    for key, t in flat.items():
        node = root
        *outer, leaf = key.split(".")
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = t

    def conv(d):
        return types.SimpleNamespace(**{
            k: conv(v) if isinstance(v, dict) else v for k, v in d.items()})
    return conv(root)


class ShardedLM:
    """A model placed on a mesh by the reference's placements.

    ``shards[i]`` maps each leaf of the reference's params tree (a
    '.'-joined key: ``embed.table``, ``blocks.attn.wq`` stacked ``[L, d,
    h, dh]``, ...) to shard i's local piece of it, on ``mesh.devices[i]``,
    cut from the whole leaf of ``shapes[key]`` by ``specs[key]`` (the
    reference's `param_shardings`: TP over 'model' on heads / ffn hidden /
    vocab / experts, FSDP over 'data' on the other large dim, replicated
    where a dim does not divide; where a stacked dense MLP's layer count
    divides over 'model', the reference's rank-3 rule cuts its layer axis
    over 'model' instead, and so does the port).  Every shard holds its
    own copy of its pieces.

    `gathered` hands the model code one layer's leaves per shard as the
    layer runs them: the FSDP cuts gathered over 'data' (ZeRO-3's
    all-gather before use), a layer-axis cut fetched from the shard that
    holds the layer, and each leaf cut over 'model' as `_tp_spec` says.

    For training (`requires_grad_`, `named_pieces`) the pieces are the
    leaves of autograd, a stacked piece read as one view a layer
    (`layer_views`); the moments are models of the same placements
    (`like`)."""

    def __init__(self, cfg: ModelConfig, mesh: ShardMesh,
                 specs: Mapping[str, Placement],
                 shapes: Mapping[str, Tuple[int, ...]],
                 shards: Sequence[Dict[str, torch.Tensor]]):
        self.cfg, self.mesh = cfg, mesh
        self.specs = {k: tuple(v) for k, v in specs.items()}
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.shards = tuple(shards)
        sizes = _sizes(mesh)
        self.tp = {k: _tp_spec(k, self._layer_shape(k), sizes)
                   for k in self.specs}
        self._views: Optional[List[Dict[str, List[torch.Tensor]]]] = None

    def __call__(self, cfg: ModelConfig, batch):
        """`lm.forward_train` on this model (as calling an `lm.LM` does)."""
        from repro_torch.models import lm
        return lm.forward_train(self, cfg, batch)

    # -- the pieces a step differentiates and updates ---------------------

    def layer_views(self) -> List[Dict[str, List[torch.Tensor]]]:
        """Per shard, each stacked leaf's piece as one tensor per layer
        (``piece[l]`` detached: a leaf of autograd's that shares the
        piece's storage, so an in-place update of it shows in the piece).
        The model code reads these, so a layer's gradient is its own
        tensor, not a slice of a zero tensor of the piece's size."""
        if self._views is None:
            self._views = [{k: [t[l].detach() for l in range(t.shape[0])]
                            for k, t in s.items() if self._stacked(k)}
                           for s in self.shards]
        return self._views

    def requires_grad_(self, on: bool = True) -> "ShardedLM":
        """Turn ``requires_grad`` on for every piece that `named_pieces`
        lists (the trainer's master weights) and this process holds (a
        stand-in of another process's shard takes no gradient here); returns
        the model."""
        for name, t in self.named_pieces().items():
            if sharding.is_local(self.mesh, split_name(name)[1]):
                t.requires_grad_(on)
        return self

    def named_pieces(self) -> Dict[str, torch.Tensor]:
        """``{piece_name(key, i, layer): tensor}`` over every leaf and
        shard: an unstacked leaf's piece, a stacked leaf's `layer_views`."""
        views = self.layer_views()
        out = {}
        for key in self.specs:
            for i, s in enumerate(self.shards):
                if self._stacked(key):
                    for l, t in enumerate(views[i][key]):
                        out[piece_name(key, i, l)] = t
                else:
                    out[piece_name(key, i)] = s[key]
        return out

    def distinct_names(self) -> List[str]:
        """The `named_pieces` of the first shard that holds each slice of
        each leaf (`sharding.distinct`): what a global norm counts once."""
        out = []
        for key in self.specs:
            for i in sharding.distinct(self.shapes[key], self.specs[key],
                                       self.mesh):
                if self._stacked(key):
                    out += [piece_name(key, i, l)
                            for l in range(self.shards[i][key].shape[0])]
                else:
                    out.append(piece_name(key, i))
        return out

    def like(self, fn) -> "ShardedLM":
        """A model of the same leaves and placements whose pieces are
        ``fn(piece)`` (the moments' zeros, a bf16 copy)."""
        return ShardedLM(self.cfg, self.mesh, self.specs, self.shapes,
                         [{k: fn(t) for k, t in s.items()}
                          for s in self.shards])

    def tree(self) -> dict:
        """The placed leaves (`placed`) in the reference's params tree
        (`param_shardings`' layout): a checkpoint saves each whole."""
        return nest({key: self.placed(key) for key in self.specs})

    def _stacked(self, key: str) -> bool:
        return key.split(".", 1)[0] in STACKS

    def _layer_shape(self, key: str) -> Tuple[int, ...]:
        return self.shapes[key][1:] if self._stacked(key) \
            else self.shapes[key]

    def placed(self, key: str) -> sharding.Placed:
        return sharding.Placed(tuple(s[key] for s in self.shards),
                               self.specs[key], self.mesh, self.shapes[key])

    def nbytes(self, i: int) -> int:
        """The parameter bytes shard i holds."""
        return sum(t.numel() * t.element_size()
                   for t in self.shards[i].values())

    def tp_split(self, key: str, dim: int) -> bool:
        """Whether the model code cuts dim `dim` of (a layer of) leaf `key`
        over 'model'."""
        spec = self.tp.get(key, ())
        return dim < len(spec) and spec[dim] == "model"

    def _layer_spec(self, key: str) -> Placement:
        """The placement of leaf `key`'s pieces (a stacked leaf's, of one
        layer: without its layer axis)."""
        spec = self.specs[key] + (None,) * (len(self.shapes[key])
                                            - len(self.specs[key]))
        return spec[1:] if self._stacked(key) else spec

    def _layer_parts(self, key: str, layer: Optional[int],
                     cuts=()) -> List[torch.Tensor]:
        """Leaf `key` (layer `layer` of a stacked one) per shard, each piece
        cut to shard i's block over axis w of dim d for each (d, w) of
        `cuts`."""
        mesh = self.mesh
        takes = [[(d, *_block(mesh, i, w, n)) for d, w, n in cuts]
                 for i in range(mesh.size)]
        spec = self.specs[key] + (None,) * (len(self.shapes[key])
                                            - len(self.specs[key]))
        if not self._stacked(key):
            parts = [s[key] for s in self.shards]
        elif spec[0] is None:
            parts = [v[key][layer] for v in self.layer_views()]
        else:
            # the layer axis cut over one axis: layer `layer` lives on the
            # shards at coordinate layer // (L / n) of it, which hand it to
            # their group (`sharding.fetch`), each reader its first cut
            views = self.layer_views()
            axis = spec[0]
            per = self.shapes[key][0] // sharding.axis_sizes(mesh)[axis]
            srcs = [0] * mesh.size
            owned: List[Optional[torch.Tensor]] = [None] * mesh.size
            for g in sharding.groups(mesh, (axis,)):
                o = g[layer // per]
                owned[o] = views[o][key][layer % per]
                for i in g:
                    srcs[i] = o
            with sharding.scope(_leaf_name(key)):
                parts = sharding.fetch(owned, mesh, srcs, [
                    t[0] if t else None for t in takes])
            takes = [t[1:] for t in takes]
        return [functools.reduce(lambda p, t: p.narrow(*t), tk, p)
                for p, tk in zip(parts, takes)]

    def leaf(self, key: str, layer: Optional[int] = None,
             whole: bool = False) -> List[torch.Tensor]:
        """Leaf `key` (layer `layer` of a stacked one) per shard as the
        model code runs it: cut over 'model' as `tp` says (whole with
        `whole`), every other cut gathered.  A dim the gathers do not touch
        is cut first, so each shard fetches and gathers only its own slice
        of it."""
        have = self._layer_spec(key)
        want = (None,) * len(have) if whole else self.tp[key] + (None,) * (
            len(have) - len(self.tp[key]))
        shape = self._layer_shape(key)
        gathered = [any(a != w for a in sharding.entry_axes(h))
                    for h, w in zip(have, want)]
        cuts = [(d, w, shape[d] // math.prod(
            sharding.axis_sizes(self.mesh)[a]
            for a in sharding.entry_axes(h)))
            for d, (h, w) in enumerate(zip(have, want))
            if w is not None and w not in sharding.entry_axes(h)]
        parts = self._layer_parts(key, layer,
                                  [c for c in cuts if not gathered[c[0]]])
        for dim, (h, w) in enumerate(zip(have, want)):
            for a in reversed(sharding.entry_axes(h)):
                if a != w:
                    with sharding.scope(_leaf_name(key)):
                        parts = sharding.all_gather(parts, self.mesh, a, dim)
        for d, w, _ in cuts:
            if gathered[d]:
                parts = [p.narrow(d, *_block(self.mesh, i, w, p.shape[d]))
                         for i, p in enumerate(parts)]
        return parts

    def gathered(self, prefix: str, layer: Optional[int] = None,
                 whole: Optional[str] = None) -> List[types.SimpleNamespace]:
        """Per shard, the leaves under `prefix` (``"blocks."`` with
        `layer`, ``"embed."``) as attributes (``ns.attn.wq``), by `leaf`;
        those under ``prefix + whole`` whole."""
        flat: List[Dict[str, torch.Tensor]] = [{} for _ in self.shards]
        for key in self.specs:
            if not key.startswith(prefix):
                continue
            sub = key[len(prefix):]
            parts = self.leaf(key, layer, whole=bool(whole) and
                              sub.startswith(whole))
            for d, t in zip(flat, parts):
                d[sub] = t
        return [_namespace(d) for d in flat]


def _leaf_name(key: str) -> str:
    """A leaf's collectives' scope inside its block's or module's:
    ``blocks.attn.wq`` -> ``attn.wq``, ``embed.table`` -> ``table``."""
    return key.split(".", 1)[-1]


def piece_name(key: str, i: int, layer: Optional[int] = None) -> str:
    """A piece's name among `ShardedLM.named_pieces`: ``blocks.attn.wq@3/5``
    (shard 3's piece, layer 5 of it), ``final_norm@3``."""
    return f"{key}@{i}" if layer is None else f"{key}@{i}/{layer}"


def split_name(name: str) -> Tuple[str, int, Optional[int]]:
    """(tree key, shard, layer of the piece or None) of a `piece_name`."""
    key, _, rest = name.rpartition("@")
    i, _, layer = rest.partition("/")
    return key, int(i), (int(layer) if layer else None)


def nest(flat: Mapping[str, object]) -> dict:
    """{'.'-joined tree key: leaf} as the reference's nested params tree
    (``head`` empty where the embeddings are tied)."""
    tree: dict = {"head": {}}
    for key, value in flat.items():
        node = tree
        *outer, leaf = key.split(".")
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


class Stacked:
    """A block group's per-layer tensors as one stacked leaf of the
    reference's tree, made only when read: ``full(device)`` stacks them
    there (a checkpoint saves it whole, on the host)."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)

    @torch.no_grad()
    def full(self, device=None) -> torch.Tensor:
        dev = torch.device(device) if device is not None else \
            self.parts[0].device
        return torch.stack([p.to(dev) for p in self.parts])


def stacked_tree(named: Mapping[str, torch.Tensor]) -> dict:
    """A model's ``{parameter name: tensor}`` (or anything keyed alike: its
    moments) in the reference's params tree, each block group's leaf a
    `Stacked` over its layers."""
    flat: Dict[str, object] = {}
    layers: Dict[str, List[torch.Tensor]] = {}
    for name, t in named.items():
        key = _tree_key(name)
        if key == name:
            flat[key] = t
        else:
            layers.setdefault(key, []).append(t)
            flat.setdefault(key, None)
    for key, ts in layers.items():
        flat[key] = Stacked(ts)
    return nest(flat)


def flat_tree(tree: dict) -> Dict[str, object]:
    """The leaves of a nested params tree by '.'-joined tree key."""
    out: Dict[str, object] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [key])
            else:
                out[".".join(path + [key])] = value

    walk(tree, [])
    return out


@torch.no_grad()
def copy_tree_into(named: Mapping[str, torch.Tensor], tree: dict) -> None:
    """Whole leaves of the reference's tree (tensors or host arrays)
    copied into a model's ``{parameter name: tensor}`` (block leaves
    unstacked along their layer axis), in place."""
    flat = flat_tree(tree)
    for name, t in named.items():
        key = _tree_key(name)
        whole = torch.as_tensor(flat[key])
        t.copy_(whole if key == name else whole[int(name.split(".")[1])])


def _block(mesh: ShardMesh, i: int, axis: str, dim: int) -> Tuple[int, int]:
    """(start, length) of shard i's block of a dim of `dim` over `axis`."""
    n = sharding.axis_sizes(mesh)[axis]
    return sharding.coords(mesh, i)[axis] * (dim // n), dim // n


def place_tree(cfg: ModelConfig, leaves: Mapping[str, torch.Tensor],
               mesh: ShardMesh) -> ShardedLM:
    """Whole leaves {tree key: tensor} (`_tree_key`'s keys, block leaves
    stacked) cut onto `mesh` by the reference's placements, each piece
    copied to its shard's device in the dtype the port holds the leaf."""
    want = _leaves(cfg)
    if set(leaves) != set(want):
        raise KeyError(f"leaves missing {sorted(set(want) - set(leaves))}, "
                       f"unknown {sorted(set(leaves) - set(want))}")
    sizes = _sizes(mesh)
    specs, shards = {}, [{} for _ in mesh.devices]
    for key, t in leaves.items():
        shape, dtype = want[key]
        t = torch.as_tensor(t).detach()
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {shape}")
        specs[key] = _placement(key, shape, sizes)
        placed = sharding.place(t.to(dtype), specs[key], mesh, copy=True)
        for d, part in zip(shards, placed.parts):
            d[key] = part
    return ShardedLM(cfg, mesh, specs, {k: v[0] for k, v in want.items()},
                     shards)


def place_params(params, cfg: ModelConfig, mesh: ShardMesh) -> ShardedLM:
    """A model (`lm.LM`) cut onto `mesh` by the reference's placements
    (`ShardedLM`); each block group's leaves are stacked on the way, one
    leaf at a time."""
    named = dict(params.named_parameters())
    groups: Dict[str, List[str]] = {}
    for name in named:
        groups.setdefault(_tree_key(name), []).append(name)
    leaves = {}
    for key, names in groups.items():
        if len(names) == 1 and names[0] == key:
            leaves[key] = named[key]
        else:
            leaves[key] = torch.stack([named[n] for n in names])
    return place_tree(cfg, leaves, mesh)


@torch.no_grad()
def gather_params(sp: ShardedLM, device=None):
    """The whole model (`lm.LM`) of a placed one, on `device` (default:
    shard 0's)."""
    from repro_torch.models import layers, lm
    model = lm.LM(sp.cfg, device="meta")
    full = {key: sp.placed(key).full(device) for key in sp.specs}
    for name, _ in list(model.named_parameters()):
        key = _tree_key(name)
        t = full[key][int(name.split(".")[1])] if key != name else full[key]
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, leaf,
                layers.param(t))
    return model


def from_placed_tree(cfg: ModelConfig, mesh: ShardMesh,
                     tree: dict) -> ShardedLM:
    """The placed model of a tree of `sharding.Placed` leaves in the
    reference's layout (a restore with `param_shardings`)."""
    flat = flat_tree(tree)
    want = _leaves(cfg)
    if set(flat) != set(want):
        raise KeyError(f"leaves missing {sorted(set(want) - set(flat))}, "
                       f"unknown {sorted(set(flat) - set(want))}")
    shards = [{} for _ in mesh.devices]
    for key, value in flat.items():
        if value.mesh != mesh or value.shape != want[key][0]:
            raise ValueError(f"{key} is not a leaf placed on this mesh")
        for d, part in zip(shards, value.parts):
            d[key] = part
    return ShardedLM(cfg, mesh, {k: v.spec for k, v in flat.items()},
                     {k: v.shape for k, v in flat.items()}, shards)
