"""The port's dry run (`repro_torch.launch.dryrun`, `op_analysis`) against
the reference's, on the CPU.

The reference's side is built from `repro.models.api`'s spec helpers and
``jax.eval_shape``: importing `repro.launch.dryrun` would set ``XLA_FLAGS``
to 512 host devices for every later jax test of the worker.
"""
import json

import jax
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ShapeConfig as JShape
from repro.models import api as japi
from repro.models import lm as jlm
from repro.train import optimizer as joptimizer
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, op_analysis, roofline
from repro_torch.models import api, lm, loops
from repro_torch.train import optimizer, train_step

ARCHS = registry.list_archs()
TINY = {"train": ShapeConfig("tiny_train", "train", 64, 4),
        "prefill": ShapeConfig("tiny_prefill", "prefill", 64, 2),
        "decode": ShapeConfig("tiny_decode", "decode", 64, 4)}


def _jshape(shape: ShapeConfig) -> JShape:
    return JShape(shape.name, shape.kind, shape.seq_len, shape.global_batch)


def _leaves(tree, prefix=""):
    """{dotted path: (shape, dtype name)} of a reference pytree or a port
    nest of NamedTuples / dicts / tensors."""
    if tree is None:
        return {}
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        return {prefix[:-1]: (tuple(tree.shape),
                              str(tree.dtype).replace("torch.", ""))}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}{k}."))
    return out


# ---------------------------------------------------------------------------
# (a) input_specs: meta tensors of the reference's shapes and dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_meta_and_match_the_reference(arch):
    """Every leaf is a meta tensor (but the optimizer's host step counter)
    with the reference's shape and dtype.  Settled differences: the port's
    serving model holds its matrices in ``cfg.dtype``, and its train step
    takes a ``torch.Generator``, not a PRNG key."""
    cfg, jcfg = registry.reduced_arch(arch), jregistry.reduced_arch(arch)
    jparams = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    ref_params = dict(convert._flatten(jparams))
    for kind, shape in TINY.items():
        si = dryrun.input_specs(cfg, shape)
        js = _jshape(shape)
        step = None
        if kind == "train":
            step = si["opt_state"].step
            assert step.device.type == "cpu" and step.dtype == torch.int32
        for t in op_analysis._tensors(si):
            assert t is step or t.device.type == "meta", (kind, t.device)
        named = dict(si["params"].named_parameters())
        for name, p in named.items():
            group, _, rest = name.partition(".")
            if group in ("blocks", "enc_blocks", "dec_blocks"):
                i, _, leaf = rest.partition(".")
                ref = ref_params[f"{group}.{leaf}"]
                want = tuple(ref.shape[1:])
            else:
                ref = ref_params[name]
                want = tuple(ref.shape)
            assert tuple(p.shape) == want, (kind, name)
            # the reference holds every leaf in f32 and casts a matrix to
            # cfg.dtype at each use; the port's serving model holds its
            # matrices cast once (`convert`), its trainer f32 masters
            matrix = p.dim() >= 2 and not name.endswith(".u")
            want_dt = (cfg.dtype if matrix and kind != "train"
                       else str(ref.dtype))
            assert str(p.dtype).replace("torch.", "") == want_dt, (kind, name)
        if kind == "train":
            jopt = jax.eval_shape(joptimizer.init, jparams)
            assert {str(x.dtype) for x in jax.tree.leaves(jopt.mu)} == \
                {"float32"}
            assert {v.dtype for v in si["opt_state"].mu.values()} == \
                {torch.float32}
            assert len(si["opt_state"].nu) == len(named)
            want = _leaves(japi.train_batch_specs(jcfg, js))
            got = _leaves(si["batch"])
        elif kind == "prefill":
            want = _leaves(japi.prefill_batch_specs(jcfg, js))
            got = _leaves(si["batch"])
        else:
            tok, caches, pos = japi.decode_inputs_specs(jcfg, js)
            want = _leaves({"token": tok, "caches": caches, "pos": pos})
            got = _leaves({"token": si["token"], "caches": si["caches"],
                           "pos": si["pos"]})
        assert got == want, kind


def test_spec_helpers_return_meta_tensors():
    cfg = registry.reduced_arch("qwen2-vl-7b")
    b = api.train_batch_specs(cfg, TINY["train"])
    assert set(b) == {"tokens", "targets", "vis_embeds", "mrope_pos"}
    assert all(t.device.type == "meta" for t in b.values())
    assert "targets" not in api.prefill_batch_specs(cfg, TINY["prefill"])
    enc = registry.reduced_arch("seamless-m4t-large-v2")
    _, caches, _ = api.decode_inputs_specs(enc, TINY["decode"])
    assert caches["cross"].k.shape[2] == TINY["decode"].seq_len // 2


# ---------------------------------------------------------------------------
# (e) the op counter on a loop of products
# ---------------------------------------------------------------------------

def test_op_counter_counts_a_loop_of_products():
    """A 7-trip loop of 64x64 products gives 7 x 2 x 64^3 dot FLOPs, traced
    unrolled or at 2 and 3 trips and extended; lower <= est."""
    def step(a, b):
        def body(i, c):
            return c @ b, None
        c, _ = loops.scan("unit.products", body, a, 7)
        return c

    a = torch.ones((64, 64), device="meta")
    b = torch.ones((64, 64), device="meta")

    def trace(trips):
        counter = op_analysis.OpCounter()
        with loops.truncated(trips) as seen:
            counter.run(step, a, b)
        return counter.counts, dict(seen)

    want = 7 * 2 * 64 ** 3
    unrolled = op_analysis.OpCounter()
    unrolled.run(step, a, b)
    extended, n_traces = op_analysis.extend(trace, {})
    for c in (unrolled.counts, extended):
        assert c.dot_flops == want
        assert c.hbm_bytes_est == 7 * 3 * 64 * 64 * 4      # a, b in; c out
        assert 0 < c.hbm_bytes_lower <= c.hbm_bytes_est
        assert c.hbm_by_op == {"aten.mm": c.hbm_bytes_est}
        assert c.temp_bytes == 2 * 64 * 64 * 4             # two live at once
    assert n_traces == 2


def test_op_counter_byte_rules():
    """A view moves nothing; an indexed write moves 2 x its rows plus the
    indices; ``copy_`` reads only its source; an in-place op reads and
    writes its destination."""
    x = torch.zeros((1000, 16), device="meta")
    rows = torch.zeros((8,), dtype=torch.int64, device="meta")
    vals = torch.ones((8, 16), device="meta")

    def step(x, rows, vals):
        v = x.view(16, 1000)
        x[rows] = vals
        x[:8].copy_(vals)
        x.mul_(2.0)
        return v

    c = op_analysis.OpCounter()
    c.run(step, x, rows, vals)
    by = c.counts.hbm_by_op
    assert "aten.view" not in by
    assert by["aten.index_put_"] == 2 * 8 * 16 * 4 + 8 * 8
    assert by["aten.copy_"] == 2 * 8 * 16 * 4
    assert by["aten.mul_"] == 2 * 1000 * 16 * 4
    assert c.counts.output_bytes == c.counts.alias_bytes == 1000 * 16 * 4


# ---------------------------------------------------------------------------
# (c) the dry run equals the port's own step on real CPU tensors
# ---------------------------------------------------------------------------

def _real_inputs(cfg, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    if shape.kind == "train":
        params = train_step.trainable(lm.init_params(g, cfg, master=True))
        return (params, optimizer.init(params),
                api.synth_batch(g, cfg, "train", shape.global_batch,
                                shape.seq_len))
    params = lm.init_params(g, cfg)
    if shape.kind == "prefill":
        return (params, api.synth_batch(g, cfg, "prefill",
                                        shape.global_batch, shape.seq_len))
    b, s = shape.global_batch, shape.seq_len
    caches = lm.init_caches(cfg, b, s)
    if cfg.is_encdec:
        caches["cross"] = lm.init_caches(cfg, b, s // 2)["self"]
    return (params, torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                                  dtype=torch.int32),
            caches, torch.full((b,), s - 1, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b", "rwkv6-1.6b",
                                  "zamba2-2.7b", "seamless-m4t-large-v2",
                                  "qwen2-vl-7b"])
def test_dry_run_equals_the_real_step_on_cpu(arch):
    """The extended meta-device count of a train, prefill and decode step
    equals `OpCounter` on the same step run on real CPU tensors: dot FLOPs,
    HBM bytes, argument and output bytes.  In float32: on a 16-bit CPU
    tensor `layers.silu`/`sigmoid`/`gelu` expand into XLA's steps (the
    card, and the meta device, take the fused op)."""
    cfg = registry.reduced_arch(arch).replace(remat=True, dtype="float32")
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", kind, 64, 2)
        dry, _ = dryrun.trace_cell(cfg, shape)
        real = op_analysis.OpCounter()
        real.run(dryrun.step_fn(cfg, shape), *_real_inputs(cfg, shape))
        r = real.counts
        assert dry.dot_flops == r.dot_flops, kind
        assert dry.hbm_bytes_est == r.hbm_bytes_est, kind
        assert (dry.argument_bytes, dry.output_bytes, dry.alias_bytes) == \
            (r.argument_bytes, r.output_bytes, r.alias_bytes), kind


# ---------------------------------------------------------------------------
# the CLI on the CPU: a full-width record on the meta device, then roofline
# ---------------------------------------------------------------------------

def test_dryrun_and_roofline_cli_on_the_cpu(tmp_path, capsys):
    """``dryrun --arch granite-3-2b --shape decode_32k`` then ``roofline
    --mesh all``: the record holds the reference's keys, one device and H100
    terms; nothing lands on a device (meta tensors only)."""
    dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--both-meshes"])
    rec = json.loads((tmp_path / "granite-3-2b__decode_32k__h100x1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["mesh"] == "h100x1"
    for key in ("arch", "shape", "kind", "tokens_per_step", "params",
                "active_params", "model_flops_total", "memory_analysis",
                "hlo_rollup_per_device"):
        assert key in rec
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes", "peak_memory_in_bytes"}
    roll = rec["hlo_rollup_per_device"]
    assert roll["collective_bytes"] == {} and roll["dot_flops"] > 0
    assert roll["hbm_bytes_lower"] <= roll["hbm_bytes_est"]
    cfg = registry.get_arch("granite-3-2b")
    assert rec["params"] == cfg.param_count()
    # the caches (128 x 32,768 slots x 40 layers) are updated in place
    caches = 2 * 40 * 128 * 32_768 * cfg.num_kv_heads * cfg.head_dim * 2
    assert rec["memory_analysis"]["alias_size_in_bytes"] == caches
    per_dev = rec["argument_bytes_per_device"]
    assert per_dev["pod2"] < per_dev["pod1"] < \
        rec["memory_analysis"]["argument_size_in_bytes"]
    capsys.readouterr()
    roofline.main(["--dir", str(tmp_path), "--mesh", "all"])
    line = capsys.readouterr().out
    assert "granite-3-2b" in line and "dom=memory" in line
    t = roofline.terms(rec)
    assert t["compute_s"] == roll["dot_flops"] / 989e12
    assert t["memory_s"] == roll["hbm_bytes_est"] / 3.35e12
    assert t["fits_hbm"] is False


def test_skipped_and_failed_cells(tmp_path):
    rec = dryrun.run_cell("granite-3-2b", "long_500k", out_dir=str(tmp_path))
    assert rec["status"] == "skipped"
    assert rec["reason"] == jregistry.cell_enabled(
        jregistry.get_arch("granite-3-2b"),
        jregistry.get_shape("long_500k"))[1]
    with pytest.raises(KeyError):
        dryrun.run_cell("no-such-arch", "train_4k")


def test_a_failing_cell_is_recorded_and_fails_main(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no lowering")
    monkeypatch.setattr(dryrun, "trace_cell", broken)
    rec = dryrun.run_cell("granite-3-2b", "decode_32k", out_dir=str(tmp_path))
    assert rec["status"] == "FAILED" and "no lowering" in rec["error"]
    with pytest.raises(SystemExit, match="1 cells FAILED"):
        dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
