"""Model-facing helpers: batch synthesis and the pipeline-batch adapters.

Port of ``src/repro/models/api.py``.  `synth_batch` draws from an explicit
``torch.Generator`` (on its device); `adapt_token_batch`/`adapt_batches`
are numpy-only copies.  The ``*_specs`` functions of the reference build
``jax.ShapeDtypeStruct``s for the dry run and wait for the launch slice.
The [audio]/[vlm] modality frontends are stubs, as in the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype


def _vis_len(cfg: ModelConfig, seq: int) -> int:
    return min(1024, max(seq // 4, 4))


def adapt_token_batch(batch: Dict[str, "np.ndarray"], cfg: ModelConfig,
                      rng: "np.random.Generator"):
    """Adapt a {tokens, targets} pipeline batch to a family's train inputs.

    VLM gains stub patch embeddings + M-RoPE positions; enc-dec splits the
    window into stub source frames (first half, embedded) and target text
    (second half).  Dense/MoE/SSM/hybrid pass through.
    """
    if cfg.family == "vlm":
        b, s = batch["tokens"].shape
        v = _vis_len(cfg, s)
        batch = dict(batch)
        batch["vis_embeds"] = rng.standard_normal(
            (b, v, cfg.d_model), dtype=np.float32)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, :, None],
                              (b, s, 3))
        batch["mrope_pos"] = np.ascontiguousarray(pos)
        return batch
    if cfg.family == "encdec":
        b, s = batch["tokens"].shape
        half = s // 2
        return {
            "src_emb": rng.standard_normal(
                (b, half, cfg.d_model), dtype=np.float32),
            "tokens": batch["tokens"][:, half: 2 * half],
            "targets": batch["targets"][:, half: 2 * half],
        }
    return batch


def adapt_batches(it, cfg: ModelConfig, seed: int = 0):
    """Iterator wrapper applying `adapt_token_batch` to a pipeline stream."""
    rng = np.random.default_rng(seed)
    for batch in it:
        yield adapt_token_batch(batch, cfg, rng)


def synth_batch(gen: torch.Generator, cfg: ModelConfig, kind: str,
                batch: int, seq: int):
    """Small random batch (on `gen`'s device) for smoke tests and entry points."""
    dev, dt = gen.device, torch_dtype(cfg.dtype)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=dev, dtype=torch.int32)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    if cfg.family == "encdec":
        se = st = seq // 2
        out = {"src_emb": normal(batch, se, cfg.d_model),
               "tokens": tokens(batch, st)}
        if kind == "train":
            out["targets"] = tokens(batch, st)
        return out
    out = {"tokens": tokens(batch, seq)}
    if kind == "train":
        out["targets"] = tokens(batch, seq)
    if cfg.family == "vlm":
        v = _vis_len(cfg, seq)
        out["vis_embeds"] = normal(batch, v, cfg.d_model)
        pos = torch.arange(seq, dtype=torch.int32, device=dev)
        out["mrope_pos"] = pos[None, :, None].expand(batch, seq, 3).contiguous()
    return out
