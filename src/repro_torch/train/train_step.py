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

Over a mesh the model is a `specs.ShardedLM`: the step differentiates its
pieces (`ShardedLM.named_pieces`) through the placed forward, sums each
piece's gradient with its replicas' (`sharding.replica_sum`: the
reference's data-parallel gradient sum), and reads the placed logits with
a vocab-parallel CE (`loss_fn`).  bf16 compression differentiates bf16
copies of the pieces, so the sums run on bf16 gradients.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed import collectives
from repro_torch.models import lm, sharding, specs
from repro_torch.train import optimizer

AUX_WEIGHT = 0.01


def loss_fn(params: lm.LM, cfg: ModelConfig, batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over the real vocabulary (padded ids masked to
    -1e30) plus ``AUX_WEIGHT`` x the MoE aux loss.  `params` is the model
    (an `lm.LM`, or a `specs.ShardedLM` whose logits come back placed:
    `vocab_parallel_ce`), or any callable ``(cfg, batch) -> (logits,
    aux)``.  Returns (loss, {"ce", "aux"})."""
    logits, aux = params(cfg, batch)
    if isinstance(logits, sharding.Placed):
        ce = vocab_parallel_ce(logits, batch["targets"], cfg)
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}
    logits = logits.float()
    mask_v = torch.arange(cfg.vocab_padded, device=logits.device) \
        < cfg.vocab_size
    logits = torch.where(mask_v, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        batch["targets"][..., None].long())[..., 0]
    ce = (logz - gold).mean()
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def vocab_parallel_ce(logits: sharding.Placed, targets,
                      cfg: ModelConfig) -> torch.Tensor:
    """`loss_fn`'s CE on placed logits [B, S, Vp] without gathering them:
    each shard masks its own columns at and past the real vocabulary,
    takes its rows' max (the max over 'model' of the shards' maxima, held
    constant: it only steadies the exponent), sums its exps (summed over
    'model'), and picks the target's logit where the shard holds that
    column (summed over 'model', the others adding 0); then logz - gold
    averaged over each data block and over the blocks.  All in f32, so it
    equals the CE of the gathered logits but for the order of the sums.
    `targets` [B, S] whole or placed as the logits' batch is.  Returns
    the 0-d loss on `sharding.home` (every process's, on a mesh that spans
    processes)."""
    mesh = logits.mesh
    spec = tuple(logits.spec) + (None,) * (3 - len(logits.spec))
    vocab = sharding.entry_axes(spec[-1])
    call_entry = spec[0]
    if isinstance(targets, sharding.Placed) and \
            tuple(targets.spec)[:1] == (call_entry,):
        tparts = targets.parts
    else:
        whole = targets.full() if isinstance(targets, sharding.Placed) \
            else targets
        tparts = sharding.place(whole, (call_entry, None), mesh).parts
    masked, v0s = [], []
    for i, part in enumerate(logits.parts):
        v0 = sharding.local_slices(logits.shape, spec, mesh, i)[-1].start
        col = v0 + torch.arange(part.shape[-1], device=part.device)
        masked.append(torch.where(col < cfg.vocab_size, part.float(),
                                  -1e30))
        v0s.append(v0)
    mx = [x.detach().amax(-1) for x in masked]
    if vocab:
        with sharding.scope("loss"):
            mx = sharding.all_max(mx, mesh, vocab)
    sums, golds = [], []
    for x, m, t, v0 in zip(masked, mx, tparts, v0s):
        sums.append(torch.exp(x - m[..., None]).sum(-1))
        local = t.long() - v0            # the targets are on x's shard
        inside = (local >= 0) & (local < x.shape[-1])
        g = torch.gather(x, -1, local.clamp(0, x.shape[-1] - 1)[..., None])
        golds.append(torch.where(inside, g[..., 0], 0.0))
    with sharding.scope("loss"):
        if vocab:
            sums = sharding.all_sum(sums, mesh, vocab)
            golds = sharding.all_sum(golds, mesh, vocab)
        blocks = [g[0] for g in sharding.groups(mesh, vocab)]
        ces = sharding.to_home(
            [(mx[i] + torch.log(sums[i]) - golds[i]).mean() for i in blocks],
            mesh, blocks)
    return torch.stack(ces).mean()


def trainable(model):
    """Turn ``requires_grad`` on for every parameter (the trainer's master
    weights; a placed model's pieces); returns the model."""
    if isinstance(model, specs.ShardedLM):
        return model.requires_grad_(True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _grads(loss, leaves: Dict[str, torch.Tensor], like) -> dict:
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: (torch.zeros_like(like[k], dtype=torch.float32) if g is None
                else g.to(like[k].dtype))
            for (k, _), g in zip(leaves.items(), gs)}


def _placed_grads(loss, sp: specs.ShardedLM, like) -> dict:
    """The gradient of every piece of `sp` (zeros where a piece took no
    part, and stand-ins for another process's shards), summed over its
    replicas (`sharding.replica_sum`, in the pieces' dtype), then in
    `like`'s pieces' dtypes."""
    named = sp.named_pieces()
    held = {k: t for k, t in named.items() if t.requires_grad}
    gs = dict(zip(held, torch.autograd.grad(loss, list(held.values()),
                                            allow_unused=True)))
    raw = {k: torch.zeros_like(t) if gs.get(k) is None else gs[k]
           for k, t in named.items()}
    del gs
    out = {}
    for key, spec in sp.specs.items():
        layers_ = (range(sp.shards[0][key].shape[0]) if sp._stacked(key)
                   else (None,))
        for l in layers_:
            names = [specs.piece_name(key, i, l)
                     for i in range(sp.mesh.size)]
            with sharding.scope(f"grads.{key}"):
                summed = sharding.replica_sum([raw.pop(n) for n in names],
                                              spec, sp.mesh)
            for n, g in zip(names, summed):
                out[n] = g.to(like[n].dtype)
    return out


def grads_of(params, cfg: ModelConfig, tc: TrainConfig, batch):
    """(loss, {"ce", "aux"}, grads) of one (micro)batch: the step's
    differentiation (the bf16 wire with ``grad_compression="bf16"``), its
    grads keyed as `optimizer.named` keys the params, summed over their
    replicas on a mesh."""
    named = optimizer.named(params)
    held = named
    if isinstance(params, specs.ShardedLM):       # this process's shards
        held = {k: t for k, t in named.items()
                if sharding.is_local(params.mesh, specs.split_name(k)[1])}
    if any(not p.requires_grad for p in held.values()):
        raise ValueError("the model's parameters do not require grad; "
                         "call train_step.trainable(model) first")
    bf16 = tc.grad_compression == "bf16"
    if isinstance(params, specs.ShardedLM):
        sp = params.like(lambda t: t.detach().to(torch.bfloat16)
                         if t.dtype == torch.float32 else t.detach()
                         ).requires_grad_(True) if bf16 else params
        with sharding.chain(sp.mesh):
            loss, parts = loss_fn(sp, cfg, batch)
            return loss.detach(), parts, _placed_grads(loss, sp, named)
    if bf16:
        low = {k: (p.detach().to(torch.bfloat16).requires_grad_()
                   if p.dtype == torch.float32 else p)
               for k, p in named.items()}
        loss, parts = loss_fn(
            lambda c, b: torch.func.functional_call(params, low, (c, b)),
            cfg, batch)
        return loss.detach(), parts, _grads(loss, low, named)
    loss, parts = loss_fn(params, cfg, batch)
    return loss.detach(), parts, _grads(loss, named, named)


def microbatch(batch: dict, n: int, i: int) -> dict:
    """Microbatch i of n along the batch axis: a whole array's i-th chunk;
    a placed one's i-th chunk within every data block, so it stays placed
    over the data axes."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, sharding.Placed):
            out[k] = sharding.Placed(
                tuple(p.chunk(n, dim=0)[i] for p in v.parts), v.spec, v.mesh,
                (v.shape[0] // n,) + tuple(v.shape[1:]))
        else:
            out[k] = v.chunk(n, dim=0)[i]
    return out


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns (params, opt_state, batch, gen) -> (params, opt_state,
    metrics): params (an `lm.LM` whose parameters require grad, or a
    trainable `specs.ShardedLM`) and the optimizer state updated in place;
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` (0-d tensors) and
    ``lr``.  `gen` draws the int8 codec's noise."""

    def accumulate(params, batch, n: int):
        """Microbatches along the batch axis; the mean of their grads."""
        acc, loss_sum = None, 0.0
        for i in range(n):
            loss, parts, grads = grads_of(params, cfg, tc,
                                          microbatch(batch, n, i))
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
            loss, parts, grads = grads_of(params, cfg, tc, batch)
        if tc.grad_compression == "int8":
            grads = collectives.decompress_grads(
                collectives.compress_grads(
                    grads, "int8", gen,
                    params if isinstance(params, specs.ShardedLM) else None),
                "int8")
        _, opt_state, om = optimizer.apply_updates(params, grads, opt_state,
                                                   tc)
        parts = {k: v.detach() for k, v in parts.items()}
        return params, opt_state, {"loss": loss, **parts, **om}

    return step
