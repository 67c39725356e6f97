"""Serving steps: prefill / decode with the caches updated in place.

Port of ``src/repro/serving/serve_step.py``.  The reference jits the steps
and donates the caches to decode; here decode writes the new token's K/V
rows (and, for rwkv6 and zamba2, the new recurrent states and shift or
conv windows) into the stacked cache tensors in place, with no copy per
step.  Over a mesh the steps take a placed model (`specs.ShardedLM`), the
logits come placed with the vocab over 'model', and `greedy` takes the
argmax across the vocab shards (`sharding.argmax`) without gathering
them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm, sharding


def greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """argmax over the real vocabulary (padded ids masked), ties to the
    first index as in ``jnp.argmax``; int32.  Placed logits give the whole
    batch's tokens on shard 0's device."""
    if isinstance(logits, sharding.Placed):
        return sharding.argmax(logits, vocab_size).to(torch.int32)
    mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    return torch.where(mask, logits, float("-inf")).argmax(-1).to(torch.int32)


def make_prefill(cfg: ModelConfig, s_max: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, caches, pos = lm.prefill(params, cfg, batch, s_max)
        return greedy(logits, cfg.vocab_size)[:, None], caches, pos
    return prefill_step


def make_decode(cfg: ModelConfig):
    """(params, token [B,1], caches, pos [B]) -> (next_token, caches); the
    caches are written in place and returned."""
    @torch.no_grad()
    def decode(params, token, caches, pos):
        logits, caches = lm.decode_step(params, cfg, token, caches, pos)
        return greedy(logits, cfg.vocab_size)[:, None], caches
    return decode


def generate(params, cfg: ModelConfig, batch, steps: int, s_max: int):
    """Simple generation loop for examples/tests (prefill + N decode steps)."""
    prefill = make_prefill(cfg, s_max)
    decode = make_decode(cfg)
    tok, caches, pos = prefill(params, batch)
    out = [tok]
    for _ in range(steps - 1):
        pos = pos + 1
        tok, caches = decode(params, tok, caches, pos)
        out.append(tok)
    return torch.cat(out, dim=1)
