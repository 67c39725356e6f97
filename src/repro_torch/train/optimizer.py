"""AdamW with a warmup-then-cosine schedule and global-norm clipping.

Port of ``src/repro/train/optimizer.py``.  The reference maps the update
over the params pytree and returns new trees; here the parameters and both
f32 moments are updated in place on their device, with ``torch._foreach_*``
over groups of leaves (each group's temporaries bounded by `GROUP_ELEMS`).

Weight decay is decoupled and applies where the reference's leaf has
``ndim >= 2``.  The reference stacks each block leaf over its layers, so
a block's vectors (its norm scales, rwkv6's mixes, mamba2's ``A_log``...)
are 2-D there and decayed; `decayed` keeps that rule for the port's
unstacked leaves.  The schedule and the bias corrections are computed in
float32 on the host, as the reference computes them in f32.  The element
arithmetic is the reference's in f32; where a product and a sum fuse into
one rounding differs (XLA's CPU backend contracts ``b1 * m + ...`` into a
fused multiply-add), results differ in the last place.

Over a mesh the params are a trainable `specs.ShardedLM`: the leaves are
its pieces (`ShardedLM.named_pieces`), the moments are models of the same
placements (`ShardedLM.like`), so a shard holds exactly its pieces' bytes
of each, the global norm counts each slice once (`distinct_names`), and
the same elementwise update on replicas that hold the same bits keeps
them bit-equal.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.models import sharding, specs

Tree = Dict[str, torch.Tensor]

# leaves whose reference counterpart is stacked over a layer axis
STACKED = ("blocks.", "enc_blocks.", "dec_blocks.")
GROUP_ELEMS = 1 << 27        # elements a foreach group updates at once


class OptState(NamedTuple):
    step: torch.Tensor       # int32 0-d, on the host
    mu: Tree                 # first moment, f32, one per parameter (a
    #                          `specs.ShardedLM` of the params' placements
    #                          over a mesh)
    nu: Tree                 # second moment


def named(params) -> Tree:
    """``{name: parameter}`` of a model, a placed model's pieces
    (`specs.ShardedLM.named_pieces`), or the dict itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, specs.ShardedLM):
        return params.named_pieces()
    return dict(params)


def init(params) -> OptState:
    """Zero f32 moments, one per parameter; over a mesh in the params'
    placements."""
    if isinstance(params, specs.ShardedLM):
        def zeros(t):
            return torch.zeros_like(t, dtype=torch.float32)
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu=params.like(zeros), nu=params.like(zeros))
    z = {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in named(params).items()}
    return OptState(step=torch.zeros((), dtype=torch.int32), mu=z,
                    nu={k: v.clone() for k, v in z.items()})


def lr_at(tc: TrainConfig, step) -> float:
    """Linear warmup to the peak, then a cosine down to 0.1x at
    ``total_steps`` (float32 arithmetic)."""
    f = np.float32
    step = f(int(step))
    warm = min(step / f(max(tc.warmup_steps, 1)), f(1.0))
    prog = np.clip((step - f(tc.warmup_steps))
                   / f(max(tc.total_steps - tc.warmup_steps, 1)),
                   f(0), f(1))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return float(f(tc.learning_rate) * warm * (f(0.1) + f(0.9) * cos))


def _by_device(ts: List[torch.Tensor]) -> Dict[torch.device,
                                                List[torch.Tensor]]:
    out: Dict[torch.device, List[torch.Tensor]] = {}
    for t in ts:
        out.setdefault(t.device, []).append(t)
    return out


def global_norm(tree: Tree, distinct: Optional[List[str]] = None,
                mesh: Optional[ShardMesh] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (those named in
    `distinct`: a placed model's `distinct_names`, each slice once), f32,
    on the first leaf's device.  Over `mesh` (the leaves a placed model's
    pieces) each shard takes its pieces' norms, which become whole values
    on `sharding.home` (`sharding.to_home`: every process gets each, the
    same bits) before their norm, in `distinct`'s order."""
    names = list(tree if distinct is None else distinct)
    if mesh is None:
        leaves = [tree[k] for k in names]
        dev = leaves[0].device
        norms = [n.to(dev) for ts in _by_device(leaves).values()
                 for n in torch._foreach_norm([x.float() for x in ts])]
        return torch.linalg.vector_norm(torch.stack(norms))
    norms = {}
    for ks in _by_name_device(names, tree, mesh):
        norms.update(zip(ks, torch._foreach_norm([tree[k].float()
                                                  for k in ks])))
    with sharding.scope("optimizer"):
        whole = sharding.to_home([norms[k] for k in names], mesh,
                                 [specs.split_name(k)[1] for k in names])
    return torch.linalg.vector_norm(torch.stack(whole))


def clip_by_global_norm(grads: Tree, max_norm: float,
                        distinct: Optional[List[str]] = None,
                        mesh: Optional[ShardMesh] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scales `grads` in place so their global norm (`global_norm`) is at
    most `max_norm`; returns (grads, the norm before clipping)."""
    norm = global_norm(grads, distinct, mesh)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for ks in _by_name_device(list(grads), grads, mesh):
        torch._foreach_mul_([grads[k] for k in ks],
                            scale.to(grads[ks[0]].device))
    return grads, norm


def decayed(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays this leaf: the reference's leaf is at least
    2-D (a block leaf carries the layer axis there)."""
    return p.dim() + name.startswith(STACKED) >= 2


def _groups(names: List[str], params: Tree,
            mesh: Optional[ShardMesh] = None) -> List[List[str]]:
    """`names` in groups of at most GROUP_ELEMS elements, each on one
    device (over a mesh, of one shard)."""
    out = []
    for dev_names in _by_name_device(names, params, mesh):
        cur, size = [], 0
        for k in dev_names:
            if cur and size + params[k].numel() > GROUP_ELEMS:
                out.append(cur)
                cur, size = [], 0
            cur.append(k)
            size += params[k].numel()
        if cur:
            out.append(cur)
    return out


def _by_name_device(names: List[str], params: Tree,
                    mesh: Optional[ShardMesh] = None) -> List[List[str]]:
    """`names` by device, over a mesh by shard (a placed model's pieces:
    each group one shard's work)."""
    out: Dict[object, List[str]] = {}
    for k in names:
        key = specs.split_name(k)[1] if mesh is not None \
            else params[k].device
        out.setdefault(key, []).append(k)
    return list(out.values())


@torch.no_grad()
def apply_updates(params, grads: Tree, state: OptState, tc: TrainConfig
                  ) -> Tuple[Tree, OptState, dict]:
    """One AdamW step in place on f32 params (the master weights): clip the
    grads to ``tc.grad_clip``, update the moments (bias-corrected, eps
    1e-8), decay the `decayed` leaves by ``tc.weight_decay``, step by the
    scheduled lr.  Returns (params, the state with its step advanced,
    {"grad_norm", "lr"})."""
    mesh = distinct = None
    if isinstance(params, specs.ShardedLM):
        mesh, distinct = params.mesh, params.distinct_names()
    params = named(params)
    mu, nu = named(state.mu), named(state.nu)
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, distinct, mesh)
    step = state.step + 1
    t = int(step)
    lr = lr_at(tc, t)
    b1, b2 = tc.b1, tc.b2
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    for decay in (True, False):
        names = [k for k, p in params.items() if decayed(k, p) == decay]
        for grp in _groups(names, params, mesh):
            ps = [params[k] for k in grp]
            gs = [grads[k].float() for k in grp]
            ms = [mu[k] for k in grp]
            vs = [nu[k] for k in grp]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, gs, alpha=1 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
            den = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, 1e-8)
            delta = torch._foreach_div(ms, bc1)
            torch._foreach_div_(delta, den)
            del den
            if decay:
                torch._foreach_add_(delta, ps, alpha=tc.weight_decay)
            torch._foreach_add_(ps, delta, alpha=-lr)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr}
