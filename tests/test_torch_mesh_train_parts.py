"""The pieces of training over the port's (data, model) mesh, on the CPU:
the vocab-parallel CE against `loss_fn` on the gathered logits; the
global norm counting each slice once; the int8 codec on placed gradients
bit-equal to the unsharded codec's on the gathered gradient with the same
noise tensor; bf16 compute (f32 master weights) against the reference's
run of the same 'model' width; grad accumulation 2 against 1 on a mesh;
the bf16 and int8 gradient codecs training on a mesh; the reference's
restart test (`tests/test_substrate.py`'s trainer end to end with a
restore) on a mesh, its checkpoint restored across shapes ((2, 4) onto
(1, 4) and onto one device, one device onto a mesh) with every leaf
equal; `python -m repro_torch.launch.train --production-mesh [--multi-pod]`.

Tolerances: the CE to rtol 1e-6 of the gathered one's (f32 sums in
another order), its gradient to 1e-5 of its largest magnitude (where the
target's softmax term cancels the -1); the global norm to rtol 1e-6; int8
codes bit for bit; bf16 losses within 1e-2 of the reference's (1, 2) run
(both round each
shard's partial product to bf16 before the sum over 'model');
accumulation as the reference's own test (loss rtol 1e-4; the first leaf
rtol 1e-3, atol 1e-5); restored leaves ``torch.equal``.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import TokenDataset
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as lmesh
from repro_torch.models import api, lm, sharding, specs
from repro_torch.train import optimizer
from repro_torch.train.train_step import (grads_of, loss_fn,
                                          vocab_parallel_ce)
from repro_torch.train.trainer import Trainer
from test_torch_mesh_serving import one_thread  # noqa: F401
from test_torch_mesh_train import (BF16_REL, batches, placed_leaves,
                                   port_trainer, reference_run,
                                   replicas_equal)

jax.config.update("jax_platform_name", "cpu")

ARCH = "granite-3-2b"


def _mesh(shape):
    return lmesh.model_mesh(shape, ("data", "model"), "cpu")


def _placed_model(arch, shape, seed=0):
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    model = lm.init_params(torch.Generator().manual_seed(seed), cfg,
                           master=True)
    return cfg, model, specs.place_params(model, cfg, _mesh(shape))


@pytest.mark.parametrize("arch,shape", [("granite-3-2b", (2, 2)),
                                        ("gemma2-9b", (1, 4)),
                                        ("olmoe-1b-7b", (4, 1))])
def test_vocab_parallel_ce_equals_the_gathered_one(arch, shape):
    """Placed logits [B, S, Vp] (the vocab cut over 'model', the padded
    columns masked on the shard that holds them): the CE equals
    `loss_fn`'s on the gathered logits, and so does its gradient with
    respect to the logits."""
    cfg, _, sp = _placed_model(arch, shape)
    assert cfg.vocab_padded > cfg.vocab_size
    batch = api.synth_batch(torch.Generator().manual_seed(3), cfg, "train",
                            4, 16)
    with torch.no_grad(), sharding.use_mesh(sp.mesh):
        logits, _ = lm.forward_train(sp, cfg, batch)
    if shape[1] > 1:
        assert logits.spec[-1] == "model"
    parts = [p.clone().requires_grad_() for p in logits.parts]
    placed = sharding.Placed(tuple(parts), logits.spec, logits.mesh,
                             logits.shape)
    ce = vocab_parallel_ce(placed, batch["targets"], cfg)
    whole = logits.full().requires_grad_()
    want, _ = loss_fn(lambda c, b: (whole, torch.zeros(())), cfg, batch)
    np.testing.assert_allclose(ce.item(), want.item(), rtol=1e-6)
    got_g = torch.autograd.grad(ce, parts)
    want_g = torch.autograd.grad(want, whole)[0]
    full_g = sharding.Placed(tuple(got_g), logits.spec, logits.mesh,
                             logits.shape).full()
    torch.testing.assert_close(full_g, want_g, rtol=0, atol=1e-5 * float(
        want_g.abs().max()))


def test_global_norm_counts_each_slice_once():
    """On (2, 4) the norms replicate over 'model' and the router over
    'model' too: the global norm over `distinct_names` equals the norm of
    the gathered gradient, where the norm over every piece counts each
    replica again."""
    cfg, _, sp = _placed_model("olmoe-1b-7b", (2, 4))
    sp.requires_grad_(True)
    batch = api.synth_batch(torch.Generator().manual_seed(3), cfg, "train",
                            4, 16)
    with sharding.use_mesh(sp.mesh):
        _, _, g = grads_of(sp, cfg, TrainConfig(), batch)
    whole = placed_leaves(sp, g)
    want = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t) for t in whole.values()]))
    got = optimizer.global_norm(g, sp.distinct_names())
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    assert optimizer.global_norm(g).item() > 1.01 * want.item()
    assert len(sp.distinct_names()) < len(g)


def test_int8_codes_on_placed_grads_equal_the_unsharded_codec():
    """Each leaf's codes over its pieces, with one noise tensor of the
    whole leaf's shape, equal `quantize_int8`'s on the gathered gradient
    with that noise, bit for bit (the scale the max over every piece);
    replicas get the same codes; the codec of the train step
    (`compress_grads(..., sp)`) draws that noise whole from the generator
    and gives codes of the pieces' shapes."""
    cfg, _, sp = _placed_model(ARCH, (2, 2))
    sp.requires_grad_(True)
    batch = api.synth_batch(torch.Generator().manual_seed(3), cfg, "train",
                            4, 16)
    with sharding.use_mesh(sp.mesh):
        _, _, g = grads_of(sp, cfg, TrainConfig(), batch)
    whole = placed_leaves(sp, g)
    gen = torch.Generator().manual_seed(7)
    for key, shape in sp.shapes.items():
        noise = torch.rand(shape, generator=gen) - 0.5
        codes = collectives.quantize_placed(g, sp, key, noise)
        want_q, want_s = collectives.quantize_int8(whole[key], noise)
        got_q = placed_leaves(sp, {n: q for n, (q, _) in codes.items()},
                              [key])[key]
        assert torch.equal(got_q, want_q), key
        assert all(torch.equal(s, want_s) for _, s in codes.values()), key
    out = collectives.compress_grads(g, "int8",
                                     torch.Generator().manual_seed(0), sp)
    assert set(out) == set(g)
    assert all(q.shape == g[n].shape and q.dtype == torch.int8
               for n, (q, _) in out.items())


def test_bf16_mesh_train_is_the_reference_same_width():
    """bf16 compute on f32 master weights on (1, 2): 3 steps' losses
    within 1e-2 of the reference's (1, 2) run; the replicas bit-equal."""
    p0, want, _ = reference_run(ARCH, (1, 2), dtype="bfloat16", grads=False)
    tr = port_trainer(ARCH, (1, 2), p0, dtype="bfloat16")
    got = tr.train(iter(batches(tr.cfg)), len(want), log_every=1)
    for (l, _), h in zip(want, got):
        np.testing.assert_allclose(h["loss"], l, rtol=BF16_REL)
    replicas_equal(tr.params)
    assert {t.dtype for t in tr.params.named_pieces().values()} == \
        {torch.float32}


def test_grad_accum_matches_single_batch_on_a_mesh():
    """The reference's accumulation test on (2, 2): 2 microbatches, each
    cut within every data block, give the loss of one batch and the same
    update (and the unsharded one's)."""
    cfg = registry.reduced_arch(ARCH).replace(dtype="float32")
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, "train",
                            8, 16)
    host = {k: v.numpy() for k, v in batch.items()}
    out = {}
    for accum, shape in ((1, (2, 2)), (2, (2, 2)), (2, None)):
        tc = TrainConfig(grad_accum=accum, learning_rate=1e-3)
        tr = (Trainer(cfg, tc, mesh=_mesh(shape)) if shape
              else Trainer(cfg, tc, device="cpu"))
        h = tr.train(iter([host]), 1, log_every=1)
        params = (specs.gather_params(tr.params) if shape else tr.params)
        out[accum, shape] = (h[0]["loss"],
                             next(params.parameters()).detach())
        if shape:
            replicas_equal(tr.params)
    l1, p1 = out[1, (2, 2)]
    for key in ((2, (2, 2)), (2, None)):
        l2, p2 = out[key]
        np.testing.assert_allclose(l1, l2, rtol=1e-4)
        np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_grad_compression_trains_on_a_mesh(scheme):
    """The reference's compression test on (2, 2): the bf16 wire (bf16
    copies of the pieces differentiated, the replica sums on bf16
    gradients) and the int8 codec (a whole-leaf scale and noise) train:
    the loss falls over 15 steps, the replicas stay bit-equal."""
    cfg = registry.reduced_arch(ARCH)
    tc = TrainConfig(learning_rate=3e-3, grad_compression=scheme,
                     warmup_steps=2)
    tr = Trainer(cfg, tc, mesh=_mesh((2, 2)))
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, "train",
                            4, 16)
    host = {k: v.numpy() for k, v in batch.items()}
    hist = tr.train(itertools.repeat(host), 15, log_every=1)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in hist)
    replicas_equal(tr.params)
    replicas_equal(tr.opt_state.nu, "nu ")


def _same_state(a: Trainer, b: Trainer) -> None:
    """Every param and moment leaf of two trainers `torch.equal` once
    gathered (the reference's tree, whole leaves), and the same step."""
    def leaves(tr):
        out = []
        for tree in (tr._tree()["params"], tr._tree()["opt"][1],
                     tr._tree()["opt"][2]):
            out.append({k: v.full("cpu") if hasattr(v, "full") else v
                        for k, v in specs.flat_tree(tree).items()})
        return out
    assert int(a.opt_state.step) == int(b.opt_state.step)
    for x, y in zip(leaves(a), leaves(b)):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k].detach(), y[k].detach()), k


def test_trainer_restart_on_a_mesh_restores_across_shapes(tmp_path):
    """The reference's restart test on (2, 4): a checkpoint at step 5, a
    preemption that stops at the next step boundary, a fresh Trainer on
    (2, 4) restoring step 7; the same checkpoint restored onto (1, 4) and
    onto one device, and a one-device checkpoint onto (2, 2), every param
    and moment leaf equal to the saved state."""
    cfg = registry.reduced_arch(ARCH)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2)
    ds = TokenDataset(None, cfg.vocab_size, seq_len=16, batch_size=4)
    tr = Trainer(cfg, tc, mesh=_mesh((2, 4)), checkpoint_dir=str(tmp_path),
                 checkpoint_every=5)
    tr.train(iter(ds), steps=6, log_every=2)
    assert tr.step_num == 6 and tr.ckpt.latest_step() == 5
    tr.guard.request()
    tr.train(iter(ds), steps=10, log_every=2)
    assert tr.step_num == 7 and tr.ckpt.latest_step() == 7
    for where in ({"mesh": _mesh((2, 4))}, {"mesh": _mesh((1, 4))},
                  {"device": "cpu"}):
        tr2 = Trainer(cfg, tc, checkpoint_dir=str(tmp_path), **where)
        assert tr2.maybe_restore() and tr2.step_num == 7
        _same_state(tr, tr2)
    one = tmp_path / "one"
    tr3 = Trainer(cfg, tc, device="cpu", checkpoint_dir=str(one),
                  checkpoint_every=3)
    tr3.train(iter(ds), steps=3, log_every=1)
    tr4 = Trainer(cfg, tc, mesh=_mesh((2, 2)), checkpoint_dir=str(one))
    assert tr4.maybe_restore() and tr4.step_num == 3
    _same_state(tr3, tr4)
    replicas_equal(tr4.params)
    h = tr4.train(iter(ds), steps=1, log_every=1)
    assert np.isfinite(h[0]["loss"])


def test_launch_train_production_mesh(monkeypatch, capsys):
    """`launch.train --production-mesh` as `launch.serve`'s flag: with
    --device cpu all 256 shards of the 16 x 16 mesh on the CPU, the
    params placed over both axes and the loss finite; refused on a node
    of fewer than 256 cards (512 with --multi-pod)."""
    from repro_torch.launch import train
    tr = train.main(["--device", "cpu", "--production-mesh", "--arch",
                     ARCH, "--steps", "1", "--batch", "16", "--seq", "16",
                     "--log-every", "1"])
    text = capsys.readouterr().out
    assert "training on the mesh data=16xmodel=16" in text
    assert "done: step=1 loss=" in text and "nan" not in text
    assert tr.mesh.size == 256 and tr.step_num == 1
    assert tr.params.specs["embed.table"] == ("model", "data")
    replicas_equal(tr.params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(RuntimeError, match="256"):
        train.main(["--production-mesh", "--arch", ARCH])
    with pytest.raises(RuntimeError, match="512"):
        train.main(["--production-mesh", "--multi-pod", "--arch", ARCH])
