"""Port parity for the training loss and its gradients:
`repro_torch.train.train_step.loss_fn` differentiated by autograd against
``jax.value_and_grad(repro.train.train_step.loss_fn)`` at reduced sizes on
the CPU in float32, with the reference's parameters carried across by
`repro_torch.convert`; and the port's per-layer remat against no remat.

Tolerances: the loss equals the reference's to rtol 1e-5 and every
gradient leaf to 1e-5 of that leaf's largest magnitude (measured:
≤ 2.2e-6; the two packages sum the same products in another order);
remat bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.train import train_step as jtrain_step
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import api, lm
from repro_torch.train.train_step import loss_fn, trainable
from test_torch_train import _leaves, _tree_of

jax.config.update("jax_platform_name", "cpu")

GRAD_REL = 1e-5


def _batch(cfg, rng, b=2, s=16):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s))
           .astype(np.int32)}
    if cfg.family == "encdec":
        out["src_emb"] = rng.standard_normal(
            (b, 12, cfg.d_model)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the loss and its gradients against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-2b", "seamless-m4t-large-v2",
                                  "olmoe-1b-7b"])
def test_loss_and_grads_match_reference(arch):
    """`loss_fn` and its gradient with respect to every leaf against
    ``jax.value_and_grad(repro.train.train_step.loss_fn)`` in float32 on
    carried params (olmoe: the aux term through the router)."""
    jcfg = jregistry.reduced_arch(arch).replace(dtype="float32")
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    model = trainable(convert.lm_params_from_numpy(cfg, jp, "cpu"))
    batch = _batch(cfg, np.random.default_rng(3))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain_step.loss_fn(p, jcfg, b), has_aux=True))
    (jloss, jparts), jgrads = grad_fn(jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    loss, parts = loss_fn(model, cfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]),
                                   rtol=1e-5, atol=1e-7)
    assert (parts["aux"].item() > 0) == (cfg.family == "moe")
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = _leaves(_tree_of(model, dict(zip(names, grads))))
    want = _leaves(jgrads)
    assert set(got) == set(want)
    for key, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=GRAD_REL * max(scale, 1e-12),
                                   err_msg=key)


def test_zamba2_grads_are_finite_where_the_reference_overflows():
    """zamba2 (6 layers, one group) in float32: at 16 tokens the loss and
    every gradient equal the reference's; at 128 tokens (one full SSD
    chunk) the reference's masked ``exp`` overflows above the diagonal and
    its backward turns 0 x inf into NaN, while the port masks before the
    exponent: the same loss, every gradient finite (ROADMAP.md section 3)."""
    arch = "zamba2-2.7b"
    jcfg = jregistry.reduced_arch(arch).replace(dtype="float32", num_layers=6)
    cfg = registry.reduced_arch(arch).replace(dtype="float32", num_layers=6)
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    model = trainable(convert.lm_params_from_numpy(cfg, jp, "cpu"))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain_step.loss_fn(p, jcfg, b), has_aux=True))
    for s in (16, 128):
        batch = _batch(cfg, np.random.default_rng(8), b=1, s=s)
        (jloss, _), jgrads = grad_fn(jp, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        loss, _ = loss_fn(model, cfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        want = _leaves(jgrads)
        finite = all(np.isfinite(w).all() for w in want.values())
        assert finite == (s == 16)
        if finite:
            got = _leaves(_tree_of(model, dict(zip(
                [n for n, _ in model.named_parameters()], grads))))
            for key, w in want.items():
                scale = float(np.abs(w).max())
                np.testing.assert_allclose(got[key], w, rtol=0,
                                           atol=GRAD_REL * max(scale, 1e-12),
                                           err_msg=key)


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b",
                                  "qwen2-vl-7b", "rwkv6-1.6b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_remat_gives_the_same_loss_and_grads(arch):
    """With ``cfg.remat`` each layer is recomputed in the backward: the
    loss and every gradient equal the saved-activation run's bit for bit
    (the recompute repeats the same ops on the same inputs)."""
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    model = trainable(lm.init_params(torch.Generator().manual_seed(0), cfg))
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, "train",
                            2, 32 if cfg.family == "ssm" else 16)
    out = []
    for remat in (False, True):
        loss, _ = loss_fn(model, cfg.replace(remat=remat), batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for (name, _), a, b in zip(model.named_parameters(), g0, g1):
        assert torch.equal(a, b), name
