"""Training over the port's (data, model) mesh for every arch, held against
the port's unsharded step (which `test_torch_train_grads.py` holds to the
reference): each reduced arch in float32 through `Trainer(mesh=)` on port
meshes of "cpu" shards ((2, 2), (1, 4), (2, 4); granite, olmoe and
deepseek on two or three shapes) against `Trainer(device="cpu")` from the
same seed and batch: step 1's loss, grad norm and gradient leaf by leaf,
then 3 steps' losses, the replicas ``torch.equal`` after every step.
qwen2-vl trains with vision embeddings and M-RoPE positions, seamless
with source frames;
zamba2 (one group of 6) and rwkv6 cover the recurrent mesh stacks, gemma2
its windows, softcaps and post-norms, stablelm its parallel block,
deepseek its shared experts cut over 'model'.  With remat on (one case
of each family) each layer is recomputed across every shard in the
backward, its gathers again.  rwkv6 also
runs in float64 compute (on its f32 master weights): in float32 its
`ln_x` GroupNorm turns rounding into gradient differences close to the
bound (9.6e-6 of a leaf's scale here; ROADMAP.md section 3), which the
float64 run shows to be rounding.

Tolerances: `test_torch_mesh_train.py`'s (loss and grad norm rtol 1e-5,
each gradient leaf to 1e-5 of its largest magnitude).  The grad norm is
held at step 1 only: AdamW's first updates move each element by about lr
in the direction of its gradient's sign, so an element whose gradient is
at the level of f32 rounding moves either way, and the later grad norms of
two runs that differ only in rounding drift apart (rwkv6 on (2, 4): 1.2e-5
at step 3 and 5e-4 at step 5, in float64 compute as in float32; the
reference runs of `test_torch_mesh_train.py` hold all 3 steps' grad norms
for granite and olmoe).
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.models import api, sharding, specs
from repro_torch.train import optimizer
from repro_torch.train.train_step import grads_of
from repro_torch.train.trainer import Trainer
from test_torch_mesh_serving import one_thread  # noqa: F401
from test_torch_mesh_train import (GRAD_REL, LOSS_RTOL, placed_leaves,
                                   replicas_equal)

F32 = "float32"
CASES = [("granite-3-2b", (2, 2), False, F32),
         ("granite-3-2b", (1, 4), False, F32),
         ("granite-3-2b", (2, 4), True, F32),
         ("olmoe-1b-7b", (2, 2), False, F32),
         ("olmoe-1b-7b", (1, 4), True, F32),
         ("deepseek-moe-16b", (1, 4), False, F32),
         ("deepseek-moe-16b", (2, 4), True, F32),
         ("gemma2-9b", (2, 2), False, F32), ("gemma2-27b", (2, 4), False, F32),
         ("stablelm-12b", (1, 4), False, F32),
         ("qwen2-vl-7b", (2, 4), True, F32),
         ("rwkv6-1.6b", (2, 4), True, F32),
         ("rwkv6-1.6b", (2, 4), False, "float64"),
         ("zamba2-2.7b", (2, 2), True, F32),
         ("seamless-m4t-large-v2", (1, 4), True, F32)]
STEPS = 3


def host_batch(cfg, b=4):
    """A train batch made from a seed, as the host arrays `Trainer.train`
    takes (rwkv6: 32 tokens, two of its 16-token blocks)."""
    s = 32 if cfg.family == "ssm" else 16
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, "train",
                            b, s)
    return {k: (v.float() if v.is_floating_point() else v).numpy()
            for k, v in batch.items()}


def _step_one(tr, host):
    """(loss, grad norm, {tree key: whole gradient leaf}) of a Trainer's
    first step, before its update."""
    with sharding.use_mesh(tr.mesh):
        loss, _, g = grads_of(tr.params, tr.cfg, tr.tc, tr._batch(host))
    if tr.mesh is not None:
        norm = optimizer.global_norm(g, tr.params.distinct_names())
        return loss, norm, placed_leaves(tr.params, g)
    return loss, optimizer.global_norm(g), {
        k: v.full() if isinstance(v, specs.Stacked) else v
        for k, v in specs.flat_tree(specs.stacked_tree(g)).items()}


@pytest.mark.parametrize(
    "arch,shape,remat,dtype", CASES,
    ids=[f"{a}-{s[0]}x{s[1]}{'-remat' if r else ''}"
         f"{'' if d == F32 else '-' + d}" for a, s, r, d in CASES])
def test_mesh_train_matches_the_unsharded_step(arch, shape, remat, dtype):
    cfg = registry.reduced_arch(arch).replace(dtype=dtype, remat=remat)
    if cfg.family == "hybrid":
        cfg = cfg.replace(num_layers=cfg.shared_block_period)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                     seed=0)
    host = host_batch(cfg)
    one = Trainer(cfg, tc, device="cpu")
    mesh = lmesh.model_mesh(shape, ("data", "model"), "cpu")
    tr = Trainer(cfg, tc, mesh=mesh)
    (l1, n1, want), (l2, n2, got) = _step_one(one, host), _step_one(tr, host)
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(n2), float(n1), rtol=LOSS_RTOL)
    assert set(got) == set(want)
    for key, w in want.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(got[key], w, rtol=0,
                                   atol=GRAD_REL * max(scale, 1e-12),
                                   msg=key)
    a = one.train(itertools.repeat(host), STEPS, log_every=1)
    b = []
    for _ in range(STEPS):
        b += tr.train(itertools.repeat(host), 1, log_every=1)
        replicas_equal(tr.params)
        replicas_equal(tr.opt_state.mu, "mu ")
    np.testing.assert_allclose(b[0]["grad_norm"], a[0]["grad_norm"],
                               rtol=LOSS_RTOL)
    for x, y in zip(a, b):
        for k in ("loss", "aux"):
            np.testing.assert_allclose(y[k], x[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
    assert int(tr.opt_state.step) == STEPS
    assert len(optimizer.named(tr.opt_state.nu)) == len(
        optimizer.named(tr.params))
