"""The train step: CE loss, grad accumulation, compression, metrics.

Port of ``src/repro/train/train_step.py``.  Remat is inside the model
(`lm._remat`, per layer, with ``cfg.remat``).  The reference scans over
microbatches inside one jitted step and donates params and optimizer state;
here the microbatches are a loop whose f32 grads are summed in place, and
the optimizer updates the model's master weights and moments in place.

The model's parameters must require grad (`trainable`).  With
``grad_compression="bf16"`` the step differentiates with respect to bf16
copies of the f32 leaves (``torch.func.functional_call``), as the
reference differentiates a bf16-cast tree, and casts the grads back; with
``"int8"`` the grads go through the int8 codec (its noise from the step's
``torch.Generator``) before the optimizer.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed import collectives
from repro_torch.models import lm
from repro_torch.train import optimizer

AUX_WEIGHT = 0.01


def loss_fn(params: lm.LM, cfg: ModelConfig, batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over the real vocabulary (padded ids masked to
    -1e30) plus ``AUX_WEIGHT`` x the MoE aux loss.  `params` is the model,
    or any callable ``(cfg, batch) -> (logits, aux)``.  Returns (loss,
    {"ce", "aux"})."""
    logits, aux = params(cfg, batch)
    logits = logits.float()
    mask_v = torch.arange(cfg.vocab_padded, device=logits.device) \
        < cfg.vocab_size
    logits = torch.where(mask_v, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        batch["targets"][..., None].long())[..., 0]
    ce = (logz - gold).mean()
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def trainable(model: lm.LM) -> lm.LM:
    """Turn ``requires_grad`` on for every parameter (the trainer's master
    weights); returns the model."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _grads(loss, leaves: Dict[str, torch.Tensor], like) -> dict:
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: (torch.zeros_like(like[k], dtype=torch.float32) if g is None
                else g.to(like[k].dtype))
            for (k, _), g in zip(leaves.items(), gs)}


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns (params, opt_state, batch, gen) -> (params, opt_state,
    metrics): params (an `lm.LM` whose parameters require grad) and the
    optimizer state updated in place; metrics ``loss``, ``ce``, ``aux``,
    ``grad_norm`` (0-d tensors) and ``lr``.  `gen` draws the int8 codec's
    noise."""

    def single(params, batch):
        named = optimizer.named(params)
        if any(not p.requires_grad for p in named.values()):
            raise ValueError("the model's parameters do not require grad; "
                             "call train_step.trainable(model) first")
        if tc.grad_compression == "bf16":
            low = {k: (p.detach().to(torch.bfloat16).requires_grad_()
                       if p.dtype == torch.float32 else p)
                   for k, p in named.items()}
            loss, parts = loss_fn(
                lambda c, b: torch.func.functional_call(params, low, (c, b)),
                cfg, batch)
            return loss.detach(), parts, _grads(loss, low, named)
        loss, parts = loss_fn(params, cfg, batch)
        return loss.detach(), parts, _grads(loss, named, named)

    def accumulate(params, batch, n: int):
        """Microbatches along the batch axis; the mean of their grads."""
        acc, loss_sum = None, 0.0
        for i in range(n):
            mb = {k: v.chunk(n, dim=0)[i] for k, v in batch.items()}
            loss, parts, grads = single(params, mb)
            if acc is None:
                acc = grads
            else:
                torch._foreach_add_(list(acc.values()), list(grads.values()))
            del grads
            loss_sum = loss_sum + loss
        torch._foreach_div_(list(acc.values()), float(n))
        return loss_sum / n, parts, acc

    def step(params, opt_state, batch,
             gen: Optional[torch.Generator] = None):
        if tc.grad_accum > 1:
            loss, parts, grads = accumulate(params, batch, tc.grad_accum)
        else:
            loss, parts, grads = single(params, batch)
        if tc.grad_compression == "int8":
            grads = collectives.decompress_grads(
                collectives.compress_grads(grads, "int8", gen), "int8")
        _, opt_state, om = optimizer.apply_updates(params, grads, opt_state,
                                                   tc)
        parts = {k: v.detach() for k, v in parts.items()}
        return params, opt_state, {"loss": loss, **parts, **om}

    return step

