"""Parameter and cache placements on the reference's meshes: path-based
rules + divisibility sanitization.

Port of ``src/repro/models/specs.py``.  The port runs on one card and
shards nothing; the dry run reads these placements only to report the
per-device argument bytes the reference's ``pod1`` (16 x 16) and ``pod2``
(2 x 16 x 16) meshes would hold.  A mesh is a mapping of axis sizes
(``{"data": 16, "model": 16}``, or ``{"pod": 2, "data": 16, "model":
16}``) in place of a ``jax.sharding.Mesh``, and a placement is a tuple with
one entry per dimension: None, an axis name, or a tuple of axis names (a
``PartitionSpec``'s entries).

Logical plan: TP over 'model' on heads / ffn-hidden / vocab / experts;
FSDP (ZeRO-3) over 'data' on the other big dim.  Any mapping whose dim
doesn't divide the axis product is dropped to replicated.  The reference
stacks a block group's leaves over a layer axis and places the stacked
leaf; the port's per-layer leaf takes that placement without its layer
axis.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

from repro_torch.configs.base import ModelConfig

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


def param_specs(cfg: ModelConfig, sizes: Mapping[str, int],
                params=None) -> Dict[str, Placement]:
    """{parameter name: placement} for every parameter of the port's model
    of `cfg` (built on the meta device unless `params`, an `lm.LM` or a
    {name: tensor} mapping, is given)."""
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
        out[name] = _sanitize(logical, shape, sizes)[len(shape) - p.dim():]
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


def cache_specs(cfg: ModelConfig, sizes: Mapping[str, int],
                caches) -> Dict[str, Placement]:
    """{cache leaf path: placement} with divisibility-guarded placement.

    Policy: batch over the data axes (DP); kv-heads / SSM heads / hidden
    over 'model' (TP).  When the batch is too small to shard (long_500k:
    B=1), the cache SEQUENCE axis takes the data axes instead.  Any mapping
    that does not divide is dropped.
    """
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

