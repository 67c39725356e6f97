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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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


def compress_grads(grads: Grads, scheme: str,
                   gen: Optional[torch.Generator] = None) -> dict:
    """scheme: none | bf16 | int8 (int8: `quantize_int8` per leaf, its
    noise drawn from `gen` on the leaf's device)."""
    if scheme == "none":
        return grads
    if scheme == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}
    if scheme == "int8":
        if gen is None:
            raise ValueError("int8 compression draws its rounding noise from "
                             "a torch.Generator; pass gen=")
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
