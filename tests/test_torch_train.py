"""Port parity for the training path: `repro_torch.train.optimizer`,
`repro_torch.distributed.collectives` and `repro_torch.data.pipeline`
against the JAX package's `repro.train.optimizer`,
`repro.distributed.collectives` and `repro.data.pipeline`, at reduced
sizes on the CPU, with the reference's parameters carried across by
`repro_torch.convert`; then the reference's training tests of
`tests/test_substrate.py` on the port, and the port's training entry
points.  The loss and its gradients are in `test_torch_train_grads.py`.

Tolerances: one AdamW step to rtol 1e-6 on params and moments (and to 1e-6 of each
leaf's largest magnitude, where a sum cancels); the schedule to rtol 1e-6;
int8 codes bit for bit and scales to rtol 1e-7 with the reference's noise
carried across.
"""
import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipeline
from repro.distributed import collectives as jcollectives
from repro.models import lm as jlm
from repro.train import optimizer as joptimizer
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import Prefetcher, TokenDataset
from repro_torch.distributed import collectives, elastic
from repro_torch.models import api, lm
from repro_torch.train import optimizer
from repro_torch.train.train_step import make_train_step, trainable
from repro_torch.train.trainer import Trainer

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small CPU products run fastest on one thread; under several
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_of(model, values) -> dict:
    """`values` ({parameter name: tensor}) in the reference's tree layout."""
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(values[name])
    return convert.lm_params_to_numpy(holder)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the optimizer, the schedule, the codec
# ---------------------------------------------------------------------------

def test_apply_updates_matches_reference():
    """One AdamW step (step 3, grads past the clip, random moments) on
    carried params, grads and moments: params and both moments to rtol
    1e-6, and to 1e-6 of the leaf's largest magnitude before or after the
    step for elements a sum cancels (XLA's CPU backend fuses ``b1 * m +
    (1 - b1) * g`` into one rounding, so such an element differs in the
    last place of its terms); decayed leaves are the reference's ``ndim >=
    2`` ones (a block's vectors are stacked there)."""
    arch = "olmoe-1b-7b"
    jcfg = jregistry.reduced_arch(arch).replace(dtype="float32")
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    like = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    jg = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                      .astype(np.float32) * 0.3, like)
    jm = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                      .astype(np.float32) * 0.01, like)
    jv = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape))
                      .astype(np.float32) * 1e-3, like)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jtc = JTrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jstate = joptimizer.OptState(step=jnp.asarray(2, jnp.int32), mu=jm, nu=jv)
    jnew, jst, jmet = jax.jit(lambda p, g, s: joptimizer.apply_updates(
        p, g, s, jtc))(jp, jg, jstate)

    def port(tree):
        return dict(convert.lm_params_from_numpy(cfg, tree, "cpu")
                    .named_parameters())

    model = convert.lm_params_from_numpy(cfg, jp, "cpu")
    params = dict(model.named_parameters())
    grads = {k: v.detach().clone() for k, v in port(jg).items()}
    state = optimizer.OptState(
        step=torch.tensor(2, dtype=torch.int32),
        mu={k: v.detach().clone() for k, v in port(jm).items()},
        nu={k: v.detach().clone() for k, v in port(jv).items()})
    _, st, met = optimizer.apply_updates(params, grads, state, tc)
    assert int(st.step) == int(jst.step) == 3
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    assert float(jmet["grad_norm"]) > tc.grad_clip
    np.testing.assert_allclose(met["lr"], float(jmet["lr"]), rtol=1e-6)
    for got, want, old in ((params, jnew, jp), (st.mu, jst.mu, jm),
                           (st.nu, jst.nu, jv)):
        g, w, o = _leaves(_tree_of(model, got)), _leaves(want), _leaves(old)
        for key in w:
            scale = max(np.abs(w[key]).max(), np.abs(o[key]).max())
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=key)


def test_lr_schedule_and_clip_match_reference():
    """`lr_at` over steps 0..130 (warmup 10, cosine to 100, then held) and
    `clip_by_global_norm` below and above the limit."""
    for warm, total in ((10, 100), (0, 50), (5, 5)):
        tc = TrainConfig(learning_rate=3e-4, warmup_steps=warm,
                         total_steps=total)
        jtc = JTrainConfig(learning_rate=3e-4, warmup_steps=warm,
                           total_steps=total)
        want = np.asarray(jax.vmap(lambda s: joptimizer.lr_at(jtc, s))(
            jnp.arange(131, dtype=jnp.int32)))
        got = np.array([optimizer.lr_at(tc, s) for s in range(131)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    for max_norm in (100.0, 1.0):
        jc, jn = joptimizer.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        c, n = optimizer.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()},
            max_norm)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-7)


def test_int8_codes_equal_reference_with_its_noise():
    """The reference's int8 codec on three leaves (one all zeros): the
    port's `quantize_int8` given the reference's noise (one key split per
    leaf in tree order) gives the same codes and scales; the round trip
    stays within a code step."""
    rng = np.random.default_rng(7)
    g = {"a": rng.standard_normal((32, 48)).astype(np.float32),
         "b": (rng.standard_normal(100) * 1e-3).astype(np.float32),
         "c": np.zeros((4, 4), np.float32)}
    key = jax.random.PRNGKey(11)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    want = jcollectives.compress_grads(jg, "int8", key)
    leaves, _ = jax.tree.flatten(jg)
    keys = jax.random.split(key, len(leaves))
    noise = {k: np.array(jax.random.uniform(kk, v.shape) - 0.5)
             for (k, v), kk in zip(sorted(g.items()), keys)}
    for k in g:
        q, scale = collectives.quantize_int8(torch.from_numpy(g[k]),
                                             torch.from_numpy(noise[k]))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(want[k][0]))
        np.testing.assert_allclose(float(scale), float(want[k][1]),
                                   rtol=1e-7)
    back = collectives.decompress_grads(collectives.compress_grads(
        {k: torch.from_numpy(v) for k, v in g.items()}, "int8",
        torch.Generator().manual_seed(0)), "int8")
    for k, v in g.items():
        step = max(np.abs(v).max(), 1e-12) / 127
        assert np.abs(back[k].numpy() - v).max() <= step * (1 + 1e-6)
    with pytest.raises(ValueError, match="Generator"):
        collectives.compress_grads({"a": torch.ones(2)}, "int8")


def test_token_dataset_yields_the_reference_batches():
    """The same seed (and host slice) gives the same batches in both
    packages, across an epoch boundary, and `restore` rewinds."""
    for seed, host in ((0, 0), (3, 1)):
        kw = dict(seq_len=8, batch_size=4, seed=seed, host_id=host,
                  host_count=2, synthetic_tokens=200)
        mine = TokenDataset(None, 1000, **kw)
        ref = jpipeline.TokenDataset(None, 1000, **kw)
        for _ in range(9):          # 24 windows: past the first epoch
            a, b = next(mine), next(ref)
            for k in ("tokens", "targets"):
                np.testing.assert_array_equal(a[k], b[k])
        assert mine.state() == ref.state()
    ds = TokenDataset(None, 1000, seq_len=8, batch_size=2, seed=4)
    st = ds.state()
    first = next(ds)
    ds.restore(st)
    np.testing.assert_array_equal(next(ds)["tokens"], first["tokens"])


def test_best_grid_and_restore_onto_a_device(tmp_path):
    """`best_grid` is the reference's; `reshard_restore` puts a checkpoint
    (the reference's layout) onto the named device."""
    from repro.distributed import elastic as jelastic
    from repro_torch.checkpoint.checkpointer import Checkpointer
    for n in (1, 2, 6, 8, 12, 16, 48, 7):
        assert elastic.best_grid(n) == jelastic.best_grid(n)
        assert elastic.best_grid(n, 8) == jelastic.best_grid(n, 8)
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(6.0).reshape(2, 3), "s": torch.tensor(4)}
    ck.save(2, tree)
    got = elastic.reshard_restore(ck, tree, "cpu")
    assert isinstance(got["w"], torch.Tensor)
    assert torch.equal(got["w"], tree["w"]) and int(got["s"]) == 4


# ---------------------------------------------------------------------------
# the reference's training tests (tests/test_substrate.py) on the port
# ---------------------------------------------------------------------------

def small_cfg():
    return registry.reduced_arch("granite-3-2b")


def _model(cfg, seed=0):
    return trainable(lm.init_params(torch.Generator().manual_seed(seed), cfg,
                                    master=True))


def test_train_step_reduces_loss():
    cfg = small_cfg()
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=50,
                     grad_clip=1.0)
    params = _model(cfg)
    opt = optimizer.init(params)
    step = make_train_step(cfg, tc)
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, "train",
                            4, 32)
    losses = []
    gen = torch.Generator().manual_seed(2)
    for _ in range(30):
        params, opt, m = step(params, opt, batch, gen)   # overfit one batch
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    assert np.isfinite(losses).all()
    assert {p.dtype for p in params.parameters()} == {torch.float32}


def test_grad_accum_matches_single_batch():
    cfg = small_cfg().replace(dtype="float32")
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, "train",
                            4, 16)
    params = _model(cfg)

    def run(accum):
        tc = TrainConfig(grad_accum=accum, learning_rate=1e-3)
        p = copy.deepcopy(params)
        opt = optimizer.init(p)
        p2, _, m = make_train_step(cfg, tc)(p, opt, batch)
        return m["loss"], p2

    l1, p1 = run(1)
    l2, p2 = run(2)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-4)
    a = next(p1.parameters()).detach().numpy()
    b = next(p2.parameters()).detach().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_grad_compression_still_trains(scheme):
    cfg = small_cfg()
    tc = TrainConfig(learning_rate=3e-3, grad_compression=scheme,
                     warmup_steps=2)
    params = _model(cfg)
    opt = optimizer.init(params)
    step = make_train_step(cfg, tc)
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, "train",
                            4, 16)
    first = None
    gen = torch.Generator().manual_seed(0)
    for _ in range(15):
        params, opt, m = step(params, opt, batch, gen)
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first


def test_trainer_end_to_end_with_restore(tmp_path):
    cfg = small_cfg()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2)
    ds = TokenDataset(None, cfg.vocab_size, seq_len=16, batch_size=2)
    tr = Trainer(cfg, tc, checkpoint_dir=str(tmp_path), checkpoint_every=5,
                 device="cpu")
    tr.train(iter(ds), steps=6, log_every=2)
    assert tr.step_num == 6
    assert tr.ckpt.latest_step() == 5
    # preemption: request checkpoint, loop must stop at the boundary
    tr.guard.request()
    tr.train(iter(ds), steps=10, log_every=2)
    assert tr.step_num == 7            # stopped after one step
    # fresh trainer restores
    tr2 = Trainer(cfg, tc, checkpoint_dir=str(tmp_path), device="cpu")
    assert tr2.maybe_restore()
    assert tr2.step_num == 7
    # ... every leaf and the optimizer's step equal to the saved ones
    assert int(tr2.opt_state.step) == int(tr.opt_state.step) == 7
    for (n, a), (_, b) in zip(tr.params.named_parameters(),
                              tr2.params.named_parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(tr.opt_state.mu[n], tr2.opt_state.mu[n]), n
        assert torch.equal(tr.opt_state.nu[n], tr2.opt_state.nu[n]), n


def test_trainer_async_checkpoint_is_the_state_it_was_taken_at(
        tmp_path, monkeypatch):
    """The step-5 checkpoint is written on a thread while step 6 updates
    the params and moments in place: held until step 6 has run, it still
    restores, bit for bit, the state as it was after step 5."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    cfg = small_cfg()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2)
    ds = TokenDataset(None, cfg.vocab_size, seq_len=16, batch_size=2)
    tr = Trainer(cfg, tc, checkpoint_dir=str(tmp_path), checkpoint_every=5,
                 device="cpu")
    gate, write = threading.Event(), Checkpointer._write

    def held_write(self, step, host, treedef):
        assert gate.wait(60), "step 6 never ran"
        return write(self, step, host, treedef)

    monkeypatch.setattr(Checkpointer, "_write", held_write)
    inner, saved = tr._step, {}

    def step(params, opt, batch, gen):
        if tr.step_num == 5:           # the step after the async save
            saved.update(step=int(opt.step), params={
                k: p.detach().clone() for k, p in params.named_parameters()},
                mu={k: v.clone() for k, v in opt.mu.items()},
                nu={k: v.clone() for k, v in opt.nu.items()})
            out = inner(params, opt, batch, gen)
            gate.set()
            return out
        return inner(params, opt, batch, gen)

    tr._step = step
    tr.train(iter(ds), steps=6, log_every=2)
    assert tr.step_num == 6 and tr.ckpt.latest_step() == 5
    assert saved["step"] == 5
    tr2 = Trainer(cfg, tc, checkpoint_dir=str(tmp_path), device="cpu")
    assert tr2.maybe_restore() and tr2.step_num == 5
    assert int(tr2.opt_state.step) == 5
    for n, b in tr2.params.named_parameters():
        assert not torch.equal(saved["params"][n], tr.params.get_parameter(
            n).detach()), f"{n}: step 6 changed nothing"
        assert torch.equal(saved["params"][n], b), n
        assert torch.equal(saved["mu"][n], tr2.opt_state.mu[n]), n
        assert torch.equal(saved["nu"][n], tr2.opt_state.nu[n]), n


def test_data_pipeline_determinism_and_prefetch():
    ds1 = TokenDataset(None, 1000, seq_len=8, batch_size=4, seed=1)
    ds2 = TokenDataset(None, 1000, seq_len=8, batch_size=4, seed=1)
    b1, b2 = next(ds1), next(ds2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    pf = Prefetcher(ds1, depth=2)
    batches = [next(pf) for _ in range(3)]
    assert all(b["tokens"].shape == (4, 8) for b in batches)
    pf.close()


def test_int8_compression_roundtrip_accuracy():
    g = {"w": torch.linspace(-1, 1, 1024).reshape(32, 32)}
    c = collectives.compress_grads(g, "int8",
                                   torch.Generator().manual_seed(0))
    d = collectives.decompress_grads(c, "int8")
    np.testing.assert_allclose(d["w"].numpy(), g["w"].numpy(), atol=2e-2)


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

def test_launch_train_main_on_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train --device cpu` on a reduced arch
    of each training family shape: the loss is finite, a checkpoint
    lands, and a second run restores from it."""
    from repro_torch.launch import train
    args = ["--device", "cpu", "--arch", "seamless-m4t-large-v2", "--steps",
            "3", "--batch", "2", "--seq", "16", "--checkpoint-dir",
            str(tmp_path), "--checkpoint-every", "2", "--log-every", "1"]
    tr = train.main(args)
    assert tr.step_num == 3 and tr.ckpt.latest_step() == 3
    text = capsys.readouterr().out
    assert "arch=seamless-m4t-large-v2" in text and "done: step=3" in text
    tr = train.main(args[:5] + ["1"] + args[6:])
    assert "restored from step 3" in capsys.readouterr().out
    assert tr.step_num == 4


def test_train_micro_on_cpu(tmp_path, capsys):
    """`python -m repro_torch.train_micro --device cpu` at a few steps:
    the ~100M granite trains and checkpoints."""
    from repro_torch import train_micro
    hist = train_micro.main(["--device", "cpu", "--steps", "2", "--batch",
                             "1", "--seq", "16", "--ckpt", str(tmp_path)])
    text = capsys.readouterr().out
    assert "params: " in text and "checkpoint at step 2" in text
    assert all(np.isfinite(h["loss"]) for h in hist)
