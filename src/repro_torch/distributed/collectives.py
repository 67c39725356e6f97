"""Gradient compression: bf16 casts and stochastic-rounded block-scaled int8.

Port of ``src/repro/distributed/collectives.py``.  The reference expresses
compression as a cast on the gradient pytree at the data-parallel psum
boundary; one card has no reduction to shrink, so here it is the codec
itself, applied to a ``{name: tensor}`` dict of gradients (the train step
compresses and decompresses before the optimizer, as the reference does).

The int8 codec's rounding noise is uniform in [-0.5, 0.5), drawn from an
explicit ``torch.Generator`` leaf by leaf in the dict's order (the
reference splits a jax key per leaf); `quantize_int8` takes the noise as a
tensor, so a parity test can carry the reference's noise across.

Over a mesh the gradients are a placed model's pieces (keyed as
`specs.ShardedLM.named_pieces`): each logical leaf is coded as the
unsharded codec codes the whole leaf, its scale the max over all its
pieces and its noise drawn in the whole leaf's shape, then cut as the
leaf is cut (`quantize_placed`), so the codes equal the unsharded codec's
on the gathered gradient and replicas get the same codes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import sharding, specs

Grads = Dict[str, torch.Tensor]


def quantize_int8(g: torch.Tensor, noise: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: scale = max|g| / 127 (at least 1e-12 / 127), codes =
    clip(round(g / scale + noise), -127, 127) as int8.  Returns (codes,
    the f32 scale as a 0-d tensor)."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def quantize_placed(grads: Grads, sp, key: str, noise: torch.Tensor
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Leaf `key` of a placed model `sp` (a `specs.ShardedLM`) from its
    pieces' gradients (`grads`, keyed by `specs.piece_name`): scale =
    max|g| over every piece / 127 (at least 1e-12 / 127), each piece
    coded with its slice of `noise` (the whole leaf's shape).  Returns
    {piece name: (codes, the scale on the piece's device)}."""
    mesh, spec, shape = sp.mesh, sp.specs[key], sp.shapes[key]
    stacked = key.split(".", 1)[0] in specs.STACKS
    names = {i: ([specs.piece_name(key, i, l)
                  for l in range(sp.shards[i][key].shape[0])] if stacked
                 else [specs.piece_name(key, i)])
             for i in range(mesh.size)}
    dev = noise.device
    amax = torch.stack([grads[n].float().abs().max().to(dev)
                        for i in sharding.distinct(shape, spec, mesh)
                        for n in names[i]]).max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    out = {}
    for i, ns in names.items():
        piece = noise[sharding.local_slices(shape, spec, mesh, i)]
        for l, n in enumerate(ns):
            g = grads[n]
            z = (piece[l] if stacked else piece).to(g.device)
            q = torch.clamp(torch.round(g.float() / scale.to(g.device) + z),
                            -127, 127)
            out[n] = (q.to(torch.int8), scale.to(g.device))
    return out


def compress_grads(grads: Grads, scheme: str,
                   gen: Optional[torch.Generator] = None, sp=None) -> dict:
    """scheme: none | bf16 | int8 (int8: `quantize_int8` per leaf, its
    noise drawn from `gen` on the leaf's device; with `sp`, the placed
    model the grads are the pieces of, `quantize_placed` per logical leaf
    in `sp`'s leaf order, its noise drawn whole on shard 0's device)."""
    if scheme == "none":
        return grads
    if scheme == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}
    if scheme == "int8":
        if gen is None:
            raise ValueError("int8 compression draws its rounding noise from "
                             "a torch.Generator; pass gen=")
        if sp is not None:
            out = {}
            for key, shape in sp.shapes.items():
                out.update(quantize_placed(grads, sp, key, torch.rand(
                    shape, generator=gen, device=sp.mesh.devices[0]) - 0.5))
            return {k: out[k] for k in grads}
        return {k: quantize_int8(g, torch.rand(g.shape, generator=gen,
                                               device=g.device) - 0.5)
                for k, g in grads.items()}
    raise ValueError(scheme)


def decompress_grads(grads: dict, scheme: str) -> Grads:
    """The f32 gradients back: a cast, or codes x scale for int8."""
    if scheme in ("none", "bf16"):
        return {k: g.float() for k, g in grads.items()}
    if scheme == "int8":
        return {k: q.float() * scale for k, (q, scale) in grads.items()}
    raise ValueError(scheme)
