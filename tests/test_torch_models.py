"""Port parity for the LM substrate: `repro_torch.models` against the JAX
package's `repro.models` on the same numpy inputs, at reduced sizes
(d_model 128; 2 layers, zamba2 12, seamless 2 + 2), for the dense archs
and the MoE (olmoe, deepseek-moe), VLM (qwen2-vl), SSM (rwkv6), hybrid
(zamba2) and enc-dec (seamless) ones, with the reference's parameters
carried across by `repro_torch.convert.lm_params_from_numpy`.

Tolerances: in float32 the port holds the reference to rtol = atol = 1e-4
(the reference's own decode-vs-forward check is 2e-3); in bfloat16 logits
agree within 1e-2 of the logits' largest magnitude (two to three bf16
ulps: the two packages round different intermediate products), and the
greedy tokens are equal wherever the reference's top-2 margin exceeds that
tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jarchs
from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import archs, registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import accounting, api, attention, layers, lm

jax.config.update("jax_platform_name", "cpu")

DENSE = ["granite-3-2b", "stablelm-12b", "gemma2-9b", "gemma2-27b"]
NEW = ["olmoe-1b-7b", "deepseek-moe-16b", "qwen2-vl-7b", "rwkv6-1.6b",
       "zamba2-2.7b"]
ENCDEC = ["seamless-m4t-large-v2"]
ARCHS = DENSE + NEW + ENCDEC
STACKS = ("blocks", "enc_blocks", "dec_blocks")
F32_TOL = 1e-4
BF16_REL = 1e-2
# zamba2 (12 layers reduced) is held to 2e-2 of the scale, short of the
# 1e-2 the other archs meet: 12 of 81,920 forward logits differ by 0.055
# where 1e-2 of the scale is 0.045.  Bisected on the reference's own bf16
# inputs, each mamba block and SSD term rounds where the reference does;
# the first bf16 value that differs is a GEMM output (the gate projection
# of layer 2) whose exact value lies on a bf16 rounding midpoint, so f32
# accumulation order alone decides it (XLA's CPU dot against oneDNN's).
# The 12-layer recurrent stack grows such flips into the gap;
# `test_zamba2_bf16_is_no_farther_from_f32_than_the_reference` is the
# second witness (ROADMAP.md section 3)
BF16_REL_ARCH = {"zamba2-2.7b": 2e-2}


def _randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _j(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gemma_style", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(gemma_style, dtype):
    x, scale = _randn(0, 3, 5, 64, scale=3.0), _randn(1, 64, scale=0.1)
    want = jlayers.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                            1e-6, gemma_style=gemma_style)
    got = layers.rms_norm(_t(x, getattr(torch, dtype)), _t(scale), 1e-6,
                          gemma_style=gemma_style)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), _j(want), rtol=tol, atol=tol)


def test_rope_and_mrope_rotate_split_halves_as_reference():
    x = _randn(2, 2, 7, 4, 32)
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) + 3
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = layers.apply_rope(_t(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(_np(got), _j(want), rtol=F32_TOL, atol=F32_TOL)
    pos3 = np.stack([pos, pos + 1, 2 * pos], axis=-1)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (4, 6, 6),
                               1e6)
    got = layers.apply_mrope(_t(x), torch.from_numpy(pos3), (4, 6, 6), 1e6)
    np.testing.assert_allclose(_np(got), _j(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigmoid_and_silu_match_reference(dtype):
    """On CPU tensors: float32 to 1e-4; bfloat16 bit for bit (the logistic
    expanded and rounded step by step, as XLA's CPU backend does)."""
    x = _randn(7, 4, 1000, scale=4.0)
    for jf, tf in ((jax.nn.sigmoid, layers.sigmoid),
                   (jax.nn.silu, layers.silu)):
        want = _j(jax.jit(jf)(jnp.asarray(x).astype(dtype)))
        got = _np(tf(_t(x, getattr(torch, dtype))))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_reference(dtype):
    """On CPU tensors: float32 to 1e-4; bfloat16 bit for bit (jax's tanh
    form expanded with its constants in bf16, rounded step by step)."""
    x = _randn(8, 4, 1000, scale=3.0)
    want = _j(jax.jit(jax.nn.gelu)(jnp.asarray(x).astype(dtype)))
    got = _np(layers.gelu(_t(x, getattr(torch, dtype))))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    x = _randn(20, 3, 5, 64, scale=3.0) + 1.5
    scale, bias = _randn(21, 64, scale=0.5) + 1.0, _randn(22, 64, scale=0.1)
    want = jlayers.layer_norm(jnp.asarray(x).astype(dtype),
                              jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    got = layers.layer_norm(_t(x, getattr(torch, dtype)), _t(scale),
                            _t(bias), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got), _j(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    d, f = 64, 96
    x = _randn(3, 2, 5, d)
    p = {"wi": _randn(4, d, f, scale=d ** -0.5),
         "wu": _randn(5, d, f, scale=d ** -0.5),
         "wo": _randn(6, f, d, scale=f ** -0.5)}
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act)
    mlp = layers.MLP(d, f, torch.float32)
    for k, v in p.items():
        getattr(mlp, k).copy_(_t(v))
    np.testing.assert_allclose(_np(mlp(_t(x), act)), _j(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_unembed_match_reference(tied):
    """emb_scale, the tied or untied head and the final softcap."""
    cfg = registry.reduced_arch("gemma2-9b").replace(
        dtype="float32", tie_embeddings=tied)
    jcfg = jregistry.reduced_arch("gemma2-9b").replace(
        dtype="float32", tie_embeddings=tied)
    table = _randn(7, cfg.vocab_padded, cfg.d_model)
    w = _randn(8, cfg.d_model, cfg.vocab_padded, scale=0.1)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 6))
    emb, head = layers.Embed(cfg), layers.Head(cfg)
    emb.table.copy_(_t(table))
    jhead = {} if tied else {"w": jnp.asarray(w)}
    if not tied:
        head.w.copy_(_t(w))
    x = jlayers.embed_apply({"table": jnp.asarray(table)},
                            jnp.asarray(tokens, jnp.int32), jcfg)
    got = layers.embed_apply(emb, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(_np(got), _j(x), rtol=F32_TOL, atol=F32_TOL)
    want = jlayers.unembed_apply({"table": jnp.asarray(table)}, jhead, x, jcfg)
    got = layers.unembed_apply(emb, head, got, cfg)
    np.testing.assert_allclose(_np(got), _j(want), rtol=F32_TOL, atol=1e-3)
    assert np.abs(_np(got)).max() <= cfg.final_logit_softcap


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap,chunk", [
    (0, 0.0, 1024), (5, 50.0, 8), (0, 30.0, 7), (3, 0.0, 16)])
def test_flash_attention_matches_reference(window, softcap, chunk):
    """GQA (4 query heads over 2 kv heads), S = 24: a window smaller than
    S, softcap, chunks smaller than S (7 leaves a ragged last chunk)."""
    q, k, v = _randn(10, 2, 24, 4, 32), _randn(11, 2, 24, 2, 32), \
        _randn(12, 2, 24, 2, 32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=window,
                                 softcap=softcap, chunk=chunk)
    got = attention.flash_attention(_t(q), _t(k), _t(v), window=window,
                                    softcap=softcap, chunk=chunk)
    np.testing.assert_allclose(_np(got), _j(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (4, 50.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(window, softcap, dtype):
    """One token against a 16-slot cache, a different position per row."""
    q = _randn(13, 3, 1, 4, 32)
    ck, cv = _randn(14, 3, 16, 2, 32), _randn(15, 3, 16, 2, 32)
    pos = np.array([0, 7, 15], dtype=np.int32)
    jc = jattn.KVCache(k=jnp.asarray(ck).astype(dtype),
                       v=jnp.asarray(cv).astype(dtype))
    want = jattn.decode_attention(jnp.asarray(q).astype(dtype), jc,
                                  jnp.asarray(pos), window=window,
                                  softcap=softcap)
    dt = getattr(torch, dtype)
    got = attention.decode_attention(
        _t(q, dt), attention.KVCache(_t(ck, dt), _t(cv, dt)),
        torch.from_numpy(pos), window=window, softcap=softcap)
    tol = F32_TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _j(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_cross_kv_match_reference(dtype, masked):
    """GQA (4 query heads over 2 kv heads), 7 decoder positions over 9
    encoder positions; `enc_len` masks each row's keys past its length."""
    cfg = registry.reduced_arch("seamless-m4t-large-v2").replace(
        dtype=dtype, num_kv_heads=2)
    jcfg = jregistry.reduced_arch("seamless-m4t-large-v2").replace(
        dtype=dtype, num_kv_heads=2)
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, 2, cfg.head_dim
    w = {"wq": _randn(30, d, h, dh, scale=d ** -0.5),
         "wk": _randn(31, d, kvh, dh, scale=d ** -0.5),
         "wv": _randn(32, d, kvh, dh, scale=d ** -0.5),
         "wo": _randn(33, h, dh, d, scale=h ** -0.5)}
    x, enc = _randn(34, 2, 7, d), _randn(35, 2, 9, d)
    enc_len = np.array([9, 4], np.int32) if masked else None
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jkv = jattn.cross_kv(jw, jnp.asarray(enc).astype(dtype), jcfg)
    want = jattn.cross_attention(
        jw, jnp.asarray(x).astype(dtype), jkv, jcfg,
        None if enc_len is None else jnp.asarray(enc_len))
    p = attention.Attention(cfg)
    for k, v in w.items():
        getattr(p, k).copy_(_t(v))
    dt = getattr(torch, dtype)
    kv = attention.cross_kv(p, _t(enc, dt), cfg)
    got = attention.cross_attention(
        p, _t(x, dt), kv, cfg,
        None if enc_len is None else torch.from_numpy(enc_len))
    tol = F32_TOL if dtype == "float32" else 2e-2
    for a, b in ((kv.k, jkv.k), (kv.v, jkv.v), (got, want)):
        assert a.dtype == dt
        np.testing.assert_allclose(_np(a), _j(b), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the model: each reduced arch, forward / prefill / decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameters per arch (init does not depend on the
    dtype, which only casts at use; the two gemma2 archs reduce to the same
    shapes, so one init serves both)."""
    by_shape, out = {}, {}
    for a in ARCHS:
        jcfg = jregistry.reduced_arch(a)
        key = dataclasses.replace(jcfg, name="", source="")
        if key not in by_shape:
            by_shape[key] = jax.device_get(
                jlm.init_params(jax.random.PRNGKey(0), jcfg))
        out[a] = by_shape[key]
    return out


def _check(got, want, dtype, what, rel=BF16_REL) -> int:
    """Logits against the reference's; in bf16 also the greedy tokens of
    the rows whose reference top-2 margin exceeds the tolerance.  Returns
    how many rows' tokens were compared (0 in f32)."""
    got, want = _np(got), _j(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
        return 0
    tol = rel * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    two = np.sort(want, axis=-1)[..., -2:]
    sure = (two[..., 1] - two[..., 0]) > tol
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure],
                                  err_msg=what)
    return int(sure.sum())


def _batch(cfg, tokens):
    """The model's inputs as numpy: qwen2-vl also takes stub vision
    embeddings over its first 4 positions and M-RoPE coordinates that
    differ per axis; seamless takes 10 source frame embeddings."""
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["src_emb"] = _randn(6, tokens.shape[0], 10, cfg.d_model)
    if cfg.family == "vlm":
        b, s = tokens.shape
        batch["vis_embeds"] = _randn(5, b, 4, cfg.d_model)
        t = np.arange(s, dtype=np.int32)
        batch["mrope_pos"] = np.broadcast_to(
            np.stack([t, t // 2, t % 5], -1), (b, s, 3)).copy()
    return batch


def _cache_pairs(cfg, tc, jc):
    """(name, port tensor, reference array) for every cache leaf."""
    if cfg.family == "ssm":
        names = ("state", "x_att", "x_ffn")
        return [(n, getattr(tc, n), getattr(jc, n)) for n in names]
    if cfg.family == "hybrid":
        return ([(f"mamba.{n}", getattr(tc.mamba, n), getattr(jc.mamba, n))
                 for n in ("state", "conv")]
                + [(f"attn.{n}", getattr(tc.attn, n), getattr(jc.attn, n))
                   for n in ("k", "v")])
    if cfg.family == "encdec":
        return [(f"{c}.{n}", getattr(tc[c], n), getattr(jc[c], n))
                for c in ("self", "cross") for n in ("k", "v")]
    return [("k", tc.k, jc.k), ("v", tc.v, jc.v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(ref_params, arch, dtype):
    """forward_train, prefill of 12 tokens into a 32-slot cache, then three
    decode_steps on teacher tokens: logits, caches (KV, the SSM states and
    shifts, seamless's self and cross K/V) and positions.  rwkv6's forward
    runs 32 tokens (two 16-token blocks: 16 < S < 64 must be a multiple of
    16); qwen2-vl's prefill and forward take vision embeddings and M-RoPE
    positions; seamless's take 10 source frames."""
    jcfg = jregistry.reduced_arch(arch).replace(dtype=dtype)
    cfg = registry.reduced_arch(arch).replace(dtype=dtype)
    jp = ref_params[arch]
    model = convert.lm_params_from_numpy(cfg, jp, "cpu")
    s = 32 if cfg.family == "ssm" else 20
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    # jitted, as the reference's own tests and entry points run it
    forward = jax.jit(lambda p, b: jlm.forward_train(p, jcfg, b))
    prefill = jax.jit(lambda p, b: jlm.prefill(p, jcfg, b, 32))
    decode = jax.jit(lambda p, t, c, q: jlm.decode_step(p, jcfg, t, c, q))
    batch = _batch(cfg, toks)
    want, jaux = forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = lm.forward_train(model, cfg, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    assert got.shape == (2, s, cfg.vocab_padded)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2 if
                               dtype == "bfloat16" else F32_TOL)
    assert (float(aux) > 0) == (cfg.family == "moe")
    rel = BF16_REL_ARCH.get(arch, BF16_REL)
    compared = _check(got, want, dtype, "forward_train", rel=rel)
    assert compared or dtype == "float32"

    pb = _batch(cfg, toks[:, :12])
    jl, jc, jpos = prefill(jp, {k: jnp.asarray(v) for k, v in pb.items()})
    tl, tc, tpos = lm.prefill(model, cfg, {k: torch.from_numpy(v)
                                           for k, v in pb.items()}, 32)
    steps = [_check(tl, jl, dtype, "prefill", rel=rel)]
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for name, a, b in _cache_pairs(cfg, tc, jc):
        assert tuple(a.shape) == tuple(b.shape), name
        assert a.dtype == (torch.float32 if name.endswith("state")
                           else getattr(torch, dtype)), name
    for t in range(12, 15):
        tok = toks[:, t: t + 1]
        jl, jc = decode(jp, jnp.asarray(tok), jc,
                        jnp.full((2,), t, jnp.int32))
        tl, tc = lm.decode_step(model, cfg, torch.from_numpy(tok), tc,
                                torch.full((2,), t, dtype=torch.int32))
        steps.append(_check(tl, jl, dtype, f"decode_step at {t}", rel=rel))
    # greedy tokens compared on every 2-row step for the dense archs; the
    # new archs' near-flat reduced logits can leave a step with no row over
    # the margin (rwkv6's first decode step), so across the four steps
    if dtype == "bfloat16":
        assert all(steps) if arch in DENSE else sum(steps) > 0, steps
    ctol = F32_TOL if dtype == "float32" else 0.05
    for name, a, b in _cache_pairs(cfg, tc, jc):
        np.testing.assert_allclose(_np(a), _j(b), rtol=ctol, atol=ctol,
                                   err_msg=name)


def test_float64_model_computes_in_float64():
    """rwkv6 in float64 (the on-card decode-vs-forward check at full
    width): logits and every cache leaf in f64, the forward within 1e-4 of
    the float32 model's (the same weights), decode equal to the forward
    within 1e-9."""
    out = {}
    tokens = torch.randint(0, 1000, (2, 8), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))
    for dtype in ("float32", "float64"):
        cfg = registry.reduced_arch("rwkv6-1.6b").replace(dtype=dtype)
        params = lm.init_params(torch.Generator().manual_seed(0), cfg)
        out[dtype], _ = lm.forward_train(params, cfg, {"tokens": tokens})
    full = out["float64"]
    assert full.dtype == torch.float64
    torch.testing.assert_close(out["float32"].double(), full, rtol=F32_TOL,
                               atol=F32_TOL)
    last, caches, _ = lm.prefill(params, cfg, {"tokens": tokens[:, :4]}, 16)
    assert {t.dtype for t in caches} == {torch.float64}
    pairs = [(last, full[:, 3])]
    for t in range(4, 8):
        logits, caches = lm.decode_step(
            params, cfg, tokens[:, t: t + 1], caches,
            torch.full((2,), t, dtype=torch.int32))
        pairs.append((logits, full[:, t]))
    for got, want in pairs:
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b"])
def test_float64_refused_outside_the_ssm_family(arch):
    cfg = registry.reduced_arch(arch).replace(dtype="float64")
    with pytest.raises(ValueError, match="float64"):
        lm.init_caches(cfg, 1, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's `test_decode_matches_forward` on the port: decode
    logits == teacher-forced logits at the same position, in float32, at
    the reference's rtol = atol = 2e-3 (seamless over 6 source frames)."""
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                           generator=gen)
    src = ({"src_emb": torch.randn(2, 6, cfg.d_model, generator=gen)}
           if cfg.family == "encdec" else {})
    full, _ = lm.forward_train(params, cfg, {"tokens": tokens, **src})
    logits_last, caches, pos = lm.prefill(
        params, cfg, {"tokens": tokens[:, :4], **src}, 16)
    torch.testing.assert_close(logits_last, full[:, 3], rtol=2e-3, atol=2e-3)
    for t in range(4, 7):
        logits_t, caches = lm.decode_step(
            params, cfg, tokens[:, t: t + 1], caches,
            torch.full((2,), t, dtype=torch.int32))
        torch.testing.assert_close(logits_t, full[:, t], rtol=2e-3,
                                   atol=2e-3)


def test_gemma2_window_alternation_changes_output():
    """The reference's test on the port: a window smaller than the
    sequence on the local layers changes the output."""
    cfg = registry.reduced_arch("gemma2-9b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    cfg_nolocal = cfg.replace(alt_local_global=False, sliding_window=0)
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, "train",
                            1, 24)
    cfg_local = cfg.replace(sliding_window=4)
    a, _ = lm.forward_train(params, cfg_local, batch)
    b, _ = lm.forward_train(params, cfg_nolocal, batch)
    assert not torch.allclose(a.float(), b.float())
    assert lm._layer_windows(cfg_local, 4) == [4, 0, 4, 0]


# ---------------------------------------------------------------------------
# parameters, configs, conversion
# ---------------------------------------------------------------------------

def _port_shapes(cfg: ModelConfig) -> dict:
    """The port's parameter shapes in the reference's tree layout (block
    leaves stacked over their group's depth; zamba2's shared block
    unstacked), from a model on the meta device (nothing allocated)."""
    depth = {"blocks": cfg.num_layers, "enc_blocks": cfg.num_enc_layers,
             "dec_blocks": cfg.num_dec_layers}
    out = {}
    for name, p in lm.LM(cfg, device="meta").named_parameters():
        group = name.split(".", 1)[0]
        if group in STACKS:
            leaf = name.split(".", 2)[2]
            out[f"{group}.{leaf}"] = (depth[group], *p.shape)
        else:
            out[name] = tuple(p.shape)
    return out


def _ref_shapes(jcfg) -> dict:
    tree = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_param_shapes_match_reference(arch, size):
    get = {"full": (registry.get_arch, jregistry.get_arch),
           "reduced": (registry.reduced_arch, jregistry.reduced_arch)}[size]
    cfg, jcfg = get[0](arch), get[1](arch)
    assert _port_shapes(cfg) == _ref_shapes(jcfg)


def test_param_count_matches_reference_for_all_archs():
    """The analytic count of all ten archs, full and reduced, equals the
    reference's and the port model's own count without its norm scales;
    for the attention families (dense, MoE, VLM) that is the matrices'
    count."""
    assert sorted(archs.ALL_ARCHS) == sorted(jarchs.ALL_ARCHS)
    for name in registry.list_archs():
        for get, jget in ((registry.get_arch, jregistry.get_arch),
                          (registry.reduced_arch, jregistry.reduced_arch)):
            cfg, jcfg = get(name), jget(name)
            assert cfg.param_count() == jcfg.param_count(), name
            assert cfg.active_param_count() == jcfg.active_param_count()
            model = lm.LM(cfg, device="meta")
            assert accounting.counted_params(model) == cfg.param_count()
            if cfg.family in ("dense", "moe", "vlm"):
                mats = sum(p.numel() for p in model.parameters()
                           if p.dim() > 1)
                assert mats == cfg.param_count(), name
    assert registry.get_arch("granite-3-2b").param_count() == 2_537_553_920
    assert registry.get_arch("olmoe-1b-7b").param_count() == 6_922_698_752


def _in_model_dtype(key: str, ndim: int) -> bool:
    """Leaves the port holds in the model's dtype: the matrices, but not
    rwkv6's bonus u (used in f32 by the recurrence)."""
    return ndim >= 2 and not key.endswith("['u']")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma2-9b"] + NEW + ENCDEC)
def test_lm_params_round_trip(ref_params, arch, dtype):
    """reference tree -> port -> tree: vectors bit-equal, matrices equal to
    the reference's cast to the model dtype; and port -> tree -> port is
    bit-equal parameter for parameter."""
    cfg = registry.reduced_arch(arch).replace(dtype=dtype)
    jp = ref_params[arch]
    model = convert.lm_params_from_numpy(cfg, jp, "cpu")
    back = convert.lm_params_to_numpy(model)
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert {jax.tree_util.keystr(k) for k in flat} == \
        {jax.tree_util.keystr(k) for k in got}
    by_key = {jax.tree_util.keystr(k): v for k, v in got.items()}
    for path, want in flat.items():
        key = jax.tree_util.keystr(path)
        want = np.asarray(want)
        stacked = key.startswith(tuple(f"['{g}']" for g in STACKS))
        if _in_model_dtype(key, want.ndim - stacked):
            want = np.asarray(jnp.asarray(want).astype(dtype)
                              .astype(jnp.float32))
        np.testing.assert_array_equal(by_key[key], want, err_msg=key)
    again = convert.lm_params_from_numpy(cfg, back, "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
        held = _in_model_dtype(f"['{n.rsplit('.', 1)[-1]}']", a.dim())
        assert a.dtype == (getattr(torch, dtype) if held
                           else torch.float32), n


def test_init_params_distributions():
    """The reference's distributions: matrices normal/sqrt(shape[0]), the
    table x sqrt(d_model), dense norms zeros, q/k norms ones; a seed gives
    the same model twice."""
    cfg = registry.reduced_arch("stablelm-12b").replace(
        dtype="float32", d_model=256, d_ff=512, vocab_size=4096)
    a = lm.init_params(torch.Generator().manual_seed(3), cfg)
    b = lm.init_params(torch.Generator().manual_seed(3), cfg)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        leaf = n.rsplit(".", 1)[-1]
        if leaf in ("q_norm", "k_norm"):
            assert bool((p == 1).all()), n
        elif p.dim() == 1:
            assert bool((p == 0).all()), n
        else:
            std = float(p.std())
            want = (cfg.vocab_padded ** -0.5 * cfg.d_model ** 0.5
                    if n == "embed.table" else p.shape[0] ** -0.5)
            assert abs(std / want - 1) < 0.1, (n, std, want)


@pytest.mark.parametrize("arch", [a for a in jregistry.list_archs()
                                  if jregistry.get_arch(a).family
                                  == "encdec"])
def test_other_families_name_their_slice(arch):
    """The enc-dec family runs forward, prefill and decode now; where the
    reference refuses it (the decoder-only stack under the RAG prefill,
    the serve driver) the port refuses it too, naming the call that
    serves it."""
    from repro_torch.launch import serve
    cfg = registry.reduced_arch(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    assert set(lm.init_caches(cfg, 1, 8)) == {"self", "cross"}
    x = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="serve_step.generate"):
        lm._run_stack(params, x, cfg, mode="prefill")
    with pytest.raises(SystemExit, match="serve_step.generate"):
        serve.main(["--device", "cpu", "--arch", arch])


def test_zamba2_bf16_is_no_farther_from_f32_than_the_reference():
    """The second witness for zamba2's 2e-2: the float32 forward of the
    same bf16-rounded weights (the port's, equal to the reference's within
    2e-6 of the scale) is the answer both bf16 forwards approximate; over
    three token draws the port's bf16 logits are no farther from it than
    1.5 x the reference's (measured: 0.97-1.0 x, both about 3 % of the
    scale away)."""
    arch = "zamba2-2.7b"
    jcfg = jregistry.reduced_arch(arch).replace(dtype="bfloat16")
    cfg = registry.reduced_arch(arch).replace(dtype="bfloat16")
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    model = convert.lm_params_from_numpy(cfg, jp, "cpu")
    cfg32 = cfg.replace(dtype="float32")
    model32 = convert.lm_params_from_numpy(
        cfg32, convert.lm_params_to_numpy(model), "cpu")
    forward = jax.jit(lambda p, b: jlm.forward_train(p, jcfg, b))
    for seed in (1, 2, 4):
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (2, 20)).astype(np.int32)
        ref = _j(forward(jp, {"tokens": jnp.asarray(toks)})[0])
        got, _ = lm.forward_train(model, cfg, {"tokens": torch.from_numpy(toks)})
        f32, _ = lm.forward_train(model32, cfg32,
                                  {"tokens": torch.from_numpy(toks)})
        d_ref = np.abs(ref - _np(f32)).max()
        d_port = np.abs(_np(got) - _np(f32)).max()
        assert d_port <= 1.5 * d_ref, (seed, d_port, d_ref)
