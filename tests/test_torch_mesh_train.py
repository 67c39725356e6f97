"""Training over the port's (data, model) mesh on the CPU, held against the
JAX package's own mesh step: reduced granite-3-2b (here) and olmoe-1b-7b
(`test_torch_mesh_train_moe.py`, the same checks) through
`repro_torch.train.trainer.Trainer(mesh=)` on port meshes (1, 2) and (2, 1)
of "cpu", against the reference ``Trainer(mesh=jax.sharding.Mesh(...))``
on the same shape of the two CPU devices `tests/conftest.py` forces
(Auto axes), both from the reference's initial params (carried across by
`repro_torch.convert`) and the same batches: the loss and the grad norm
of 3 steps; every leaf of step 1's gradient against the reference's
``jax.value_and_grad`` of its loss on its placed params; the 'model'
replicas of every piece ``torch.equal`` after each step; params and both
moments exactly `specs.shard_bytes` a shard.  (bf16 on f32 master
weights, against the reference's run of the same 'model' width, is in
`test_torch_mesh_train_parts.py`.)

Tolerances: the loss and grad norm to rtol 1e-5; each gradient leaf to
1e-5 of that leaf's largest magnitude (`GRAD_REL`, as
`test_torch_train_grads.py` holds the unsharded step).  The reference's
compiles are shared across cases by module fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jregistry
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import sharding as jsharding
from repro.train import train_step as jtrain_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.models import sharding, specs
from repro_torch.train import optimizer
from repro_torch.train.train_step import trainable
from repro_torch.train.trainer import Trainer
from test_torch_mesh_serving import one_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCH = "granite-3-2b"
REF_MESHES = [(1, 2), (2, 1)]
STEPS, BATCH, SEQ = 3, 4, 16
GRAD_REL, LOSS_RTOL, BF16_REL = 1e-5, 1e-5, 1e-2
LR = 1e-3


def _tc(**kw):
    return dict(learning_rate=LR, warmup_steps=1, total_steps=10, seed=0,
                **kw)


def batches(cfg, n=STEPS, seed=5):
    """`n` host batches (int32 tokens and targets) made with numpy."""
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
             .astype(np.int32) for k in ("tokens", "targets")}
            for _ in range(n)]


def _jmesh(shape):
    return Mesh(np.array(jax.devices()[:2]).reshape(shape),
                ("data", "model"))


def reference_run(arch, shape, dtype="float32", grads=True):
    """The reference's Trainer on its mesh of `shape`: (its initial params
    on the host, per step (loss, grad norm), step 1's gradient tree on the
    host or None)."""
    jcfg = jregistry.reduced_arch(arch).replace(dtype=dtype)
    mesh = _jmesh(shape)
    tr = JTrainer(jcfg, JTrainConfig(**_tc()), mesh=mesh)
    p0 = jax.device_get(tr.params)
    data = batches(jcfg)
    g1 = None
    if grads:
        with jsharding.use_mesh(mesh):
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: jtrain_step.loss_fn(p, jcfg, b), has_aux=True))
            _, g1 = fn(tr.params, {k: jnp.asarray(v)
                                   for k, v in data[0].items()})
            g1 = jax.device_get(g1)
    hist = tr.train(iter(data), STEPS, log_every=1)
    return p0, [(h["loss"], h["grad_norm"]) for h in hist], g1


def port_trainer(arch, shape, p0, dtype="float32", **tc):
    """The port's Trainer on a mesh of `shape` of "cpu", its params the
    reference's `p0` (f32 master weights) and fresh moments."""
    cfg = registry.reduced_arch(arch).replace(dtype=dtype)
    mesh = lmesh.model_mesh(shape, ("data", "model"), "cpu")
    tr = Trainer(cfg, TrainConfig(**_tc(**tc)), mesh=mesh)
    tr.params = trainable(convert.lm_params_to_mesh(
        cfg.replace(dtype="float32"), p0, mesh))
    tr.opt_state = optimizer.init(tr.params)
    return tr


def placed_leaves(sp: specs.ShardedLM, named, keys=None) -> dict:
    """{tree key: whole leaf} (of `keys`, default every leaf) of per-piece
    tensors keyed as `sp`'s `named_pieces` (a gradient, a moment)."""
    out = {}
    for key in sp.specs if keys is None else keys:
        parts = []
        for i in range(sp.mesh.size):
            if sp._stacked(key):
                parts.append(torch.stack([
                    named[specs.piece_name(key, i, l)]
                    for l in range(sp.shards[i][key].shape[0])]))
            else:
                parts.append(named[specs.piece_name(key, i)])
        out[key] = sharding.Placed(tuple(parts), sp.specs[key], sp.mesh,
                                   sp.shapes[key]).full()
    return out


def replicas_equal(sp: specs.ShardedLM, what: str = "") -> None:
    """Every piece `torch.equal` to every piece that holds its slice."""
    for key, spec in sp.specs.items():
        first = {}
        for i, s in enumerate(sp.shards):
            sl = tuple((x.start, x.stop) for x in sharding.local_slices(
                sp.shapes[key], spec, sp.mesh, i))
            if sl in first:
                assert torch.equal(s[key], sp.shards[first[sl]][key]), \
                    f"{what}{key}: shard {i}"
            else:
                first[sl] = i


def shard_bytes_exact(tr) -> None:
    sizes = sharding.axis_sizes(tr.mesh)
    for sp in (tr.params, tr.opt_state.mu, tr.opt_state.nu):
        for i in range(tr.mesh.size):
            want = sum(specs.shard_bytes(4 * int(np.prod(shape)),
                                         sp.specs[k], sizes)
                       for k, shape in sp.shapes.items())
            assert sp.nbytes(i) == want


def step_grads(tr, data):
    """Step 1's gradient of the port's Trainer (before any update), whole
    leaves by tree key."""
    from repro_torch.train.train_step import grads_of
    with sharding.use_mesh(tr.mesh):
        _, _, g = grads_of(tr.params, tr.cfg, tr.tc, tr._batch(data))
    return placed_leaves(tr.params, g)


def check_grads(got: dict, want_tree) -> None:
    want = dict(convert._flatten(want_tree))
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=GRAD_REL * max(scale, 1e-12),
                                   err_msg=key)


def run_against_reference(ref, arch, shape):
    p0, want, g1 = ref
    tr = port_trainer(arch, shape, p0)
    shard_bytes_exact(tr)
    data = batches(tr.cfg)
    check_grads(step_grads(tr, data[0]), g1)
    got = []
    for b in data:
        got += tr.train(iter([b]), 1, log_every=1)
        replicas_equal(tr.params)
        replicas_equal(tr.opt_state.mu, "mu ")
        replicas_equal(tr.opt_state.nu, "nu ")
    for (l, n), h in zip(want, got):
        np.testing.assert_allclose(h["loss"], l, rtol=LOSS_RTOL)
        np.testing.assert_allclose(h["grad_norm"], n, rtol=LOSS_RTOL)
    shard_bytes_exact(tr)


@pytest.fixture(scope="module")
def ref_granite():
    return {shape: reference_run(ARCH, shape) for shape in REF_MESHES}


@pytest.mark.parametrize("shape", REF_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_granite_mesh_train_matches_reference_mesh_step(ref_granite, shape):
    """granite-3-2b on (1, 2) and (2, 1) against the reference's Trainer
    on the same mesh shape: 3 steps' loss and grad norm, step 1's
    gradient leaf by leaf, the replicas and each shard's bytes."""
    run_against_reference(ref_granite[shape], ARCH, shape)
