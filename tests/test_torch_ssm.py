"""Port parity for the recurrent blocks: `repro_torch.models.rwkv6` and
`repro_torch.models.mamba2` against the JAX package's `repro.models.rwkv6`
/ `repro.models.mamba2` on the same numpy inputs, at the reduced rwkv6 and
zamba2 configs (d_model 128, heads of 16, SSM state 16), the reference's
weights carried across, in float32 to rtol = atol = 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import registry
from repro_torch.models import mamba2, rwkv6

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4


def _randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want)
                                          .astype(jnp.float32)),
                               rtol=TOL, atol=TOL, err_msg=what)


def _cfgs(arch):
    return (jregistry.reduced_arch(arch).replace(dtype="float32"),
            registry.reduced_arch(arch).replace(dtype="float32"))


def _load(module, tree):
    """The reference's leaves into the port's module, leaf for leaf."""
    for name, value in tree.items():
        getattr(module, name).copy_(_t(value))
    assert {n for n, _ in module.named_parameters()} == set(tree)
    return module


# ---------------------------------------------------------------------------
# rwkv6: the WKV recurrence
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, length, h=8, hd=16):
    """state, r, k, v, w (decays in [e^-RATE_CAP, 1)), u."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((2, length, h, hd)).astype(np.float32)
               * 0.5 for _ in range(3))
    w = np.exp(-rng.uniform(0, jrwkv.RATE_CAP, (2, length, h, hd))
               ).astype(np.float32)
    state = rng.standard_normal((2, h, hd, hd)).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32) * 0.3
    return state, r, k, v, w, u


@pytest.mark.parametrize("length", [8, 16, 64])
def test_wkv_forms_agree_with_each_other_and_the_reference(length):
    """The exact oracle, the SUB-token GEMM block (lengths up to SUB) and
    the chunk cascade compute one recurrence, and each equals the
    reference's counterpart."""
    ins = _wkv_inputs(length, length)
    tins = [_t(a) for a in ins]
    jins = [jnp.asarray(a) for a in ins]
    s0, y0 = rwkv6._wkv_chunk(*tins)
    js0, jy0 = jrwkv._wkv_chunk(*jins)
    _close(s0, js0, "oracle state")
    _close(y0, jy0, "oracle y")
    s2, y2 = rwkv6._wkv_chunk_gemm(*tins)
    js2, jy2 = jrwkv._wkv_chunk_gemm(*jins)
    _close(s2, js2, "cascade state")
    _close(y2, jy2, "cascade y")
    torch.testing.assert_close(s2, s0, rtol=TOL, atol=TOL)
    torch.testing.assert_close(y2, y0, rtol=TOL, atol=TOL)
    if length <= rwkv6.SUB:
        s1, y1 = rwkv6._wkv_sub_gemm(*tins)
        js1, jy1 = jrwkv._wkv_sub_gemm(*jins)
        _close(s1, js1, "sub-block state")
        _close(y1, jy1, "sub-block y")
        torch.testing.assert_close(y1, y0, rtol=TOL, atol=TOL)


def test_wkv_log_floor_and_clip():
    """Decays at RATE_CAP through a block and a last decay of 0 (its log
    floored at -45 nats past the 1e-30 clamp, where the EXP_CLIP clip of
    the growing key factor binds) give the reference's finite answer and
    the exact oracle's."""
    state, r, k, v, w, u = _wkv_inputs(9, 16)
    w[:] = np.float32(np.exp(-jrwkv.RATE_CAP))
    w[:, -1] = 0.0
    got = rwkv6._wkv_sub_gemm(*(_t(a) for a in (state, r, k, v, w, u)))
    want = jrwkv._wkv_sub_gemm(*(jnp.asarray(a)
                                 for a in (state, r, k, v, w, u)))
    exact = rwkv6._wkv_chunk(*(_t(a) for a in (state, r, k, v, w, u)))
    for g, j, e in zip(got, want, exact):
        assert bool(torch.isfinite(g).all())
        _close(g, j)
        torch.testing.assert_close(g, e, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# rwkv6: time mix, channel mix, the block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rwkv_setup():
    jcfg, cfg = _cfgs("rwkv6-1.6b")
    tree = jax.device_get(jrwkv.rwkv_init(jax.random.PRNGKey(0), jcfg))
    # the init's decays all sit near e^-e^-2: widen them, and give the
    # bonus and the mixes non-trivial values
    tree = dict(tree)
    tree["w_bias"] = _randn(1, cfg.d_model, scale=1.0) - 1.0
    tree["u"] = _randn(2, cfg.d_model // cfg.ssm_head_dim,
                       cfg.ssm_head_dim, scale=0.3)
    for i, name in enumerate(("mix_r", "mix_k", "mix_v", "mix_w", "mix_g",
                              "cmix_r", "cmix_k")):
        tree[name] = np.random.default_rng(10 + i).uniform(
            0, 1, cfg.d_model).astype(np.float32)
    return jcfg, cfg, tree, _load(rwkv6.RWKV(cfg), tree)


@pytest.mark.parametrize("s", [1, 12, 16, 32, 64, 80])
def test_time_and_channel_mix_match_reference(rwkv_setup, s):
    """S = 1 (decode: padded to 8 with w = 1), 12 and 16 (one block), 32
    (two), 64 (a chunk of four), 80 (a chunk and a padded one): outputs,
    the carried state and the shift tokens."""
    jcfg, cfg, tree, m = rwkv_setup
    h, hd = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    x = _randn(20 + s, 2, s, cfg.d_model)
    state, x_prev = _randn(3, 2, h, hd, hd), _randn(4, 2, cfg.d_model)
    jp = jax.tree.map(jnp.asarray, tree)
    want = jax.jit(lambda p, a, st, xp: jrwkv.time_mix(p, a, jcfg, st, xp))(
        jp, jnp.asarray(x), jnp.asarray(state), jnp.asarray(x_prev))
    got = rwkv6.time_mix(m, _t(x), cfg, _t(state), _t(x_prev))
    for g, j, what in zip(got, want, ("y", "state", "x_last")):
        _close(g, j, what)
    want = jax.jit(lambda p, a, xp: jrwkv.channel_mix(p, a, jcfg, xp))(
        jp, jnp.asarray(x), jnp.asarray(x_prev))
    got = rwkv6.channel_mix(m, _t(x), cfg, _t(x_prev))
    for g, j, what in zip(got, want, ("y", "x_last")):
        _close(g, j, what)


def test_rwkv_block_apply_matches_reference(rwkv_setup):
    jcfg, cfg, tree, m = rwkv_setup
    x = _randn(30, 2, 32, cfg.d_model)
    jp = jax.tree.map(jnp.asarray, tree)
    jy, jc = jrwkv.rwkv_block_apply(jp, jnp.asarray(x), jcfg, mode="train")
    ty, tc = rwkv6.rwkv_block_apply(m, _t(x), cfg, mode="train")
    _close(ty, jy)
    for name in ("state", "x_att", "x_ffn"):
        _close(getattr(tc, name), getattr(jc, name), name)


@pytest.mark.parametrize("s", [20, 40, 63])
def test_rwkv_refuses_what_the_reference_asserts(rwkv_setup, s):
    """16 < S < 64 with S % 16 != 0: the chunk is S tokens and not a whole
    number of 16-token blocks; the reference's assert fires, the port
    raises ValueError."""
    jcfg, cfg, tree, m = rwkv_setup
    h, hd = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    x, state = _randn(5, 1, s, cfg.d_model), np.zeros((1, h, hd, hd),
                                                       np.float32)
    x_prev = np.zeros((1, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jrwkv.time_mix(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg,
                       jnp.asarray(state), jnp.asarray(x_prev))
    with pytest.raises(ValueError, match="whole number"):
        rwkv6.time_mix(m, _t(x), cfg, _t(state), _t(x_prev))


# ---------------------------------------------------------------------------
# mamba2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_setup():
    jcfg, cfg = _cfgs("zamba2-2.7b")
    tree = dict(jax.device_get(jmamba.mamba_init(jax.random.PRNGKey(0),
                                                 jcfg)))
    h = cfg.ssm_heads
    tree["A_log"] = _randn(1, h, scale=0.5)
    tree["dt_bias"] = _randn(2, h, scale=0.5)
    tree["D"] = _randn(3, h)
    return jcfg, cfg, tree, _load(mamba2.Mamba(cfg), tree)


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv_matches_reference(with_carry):
    x, w = _randn(40, 2, 9, 24), _randn(41, 4, 24, scale=0.3)
    carry = _randn(42, 2, 3, 24) if with_carry else None
    want = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if carry is None else jnp.asarray(carry))
    got = mamba2._causal_conv(_t(x), _t(w),
                              None if carry is None else _t(carry))
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "carry")


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_matches_reference(chunk):
    """32 tokens in nc = 8, 4 and 1 chunks: y and the final state; the
    chunking does not change the answer."""
    b, s, h, p, n = 2, 32, 6, 8, 5
    xh = _randn(50, b, s, h, p)
    dt = np.log1p(np.exp(_randn(51, b, s, h)))
    a_log, bm, cm = _randn(52, h, scale=0.5), _randn(53, b, s, n), \
        _randn(54, b, s, n)
    want = jmamba._ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, a_log, bm,
                                                         cm)), chunk)
    got = mamba2._ssd_chunked(*(_t(a) for a in (xh, dt, a_log, bm, cm)),
                              chunk)
    _close(got[0], want[0], "y")
    _close(got[1], want[1], "state")
    one = mamba2._ssd_chunked(*(_t(a) for a in (xh, dt, a_log, bm, cm)), s)
    torch.testing.assert_close(got[0], one[0], rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="whole number"):
        mamba2._ssd_chunked(*(_t(a) for a in (xh, dt, a_log, bm, cm)), 5)


@pytest.mark.parametrize("mode,chunk", [("train", 8), ("prefill", 8),
                                        ("prefill", 128)])
def test_mamba_apply_matches_reference(mamba_setup, mode, chunk):
    """train and prefill over 24 tokens (nc = 3 at chunk 8; one chunk at
    128), then two decode steps from the prefill's cache."""
    jcfg, cfg, tree, m = mamba_setup
    jp = jax.tree.map(jnp.asarray, tree)
    x = _randn(60, 2, 24, cfg.d_model)
    jy, jc = jmamba.mamba_apply(jp, jnp.asarray(x), jcfg, mode=mode,
                                chunk=chunk)
    ty, tc = mamba2.mamba_apply(m, _t(x), cfg, mode=mode, chunk=chunk)
    _close(ty, jy, "y")
    if mode == "train":
        assert tc is None and jc is None
        return
    _close(tc.state, jc.state, "state")
    _close(tc.conv, jc.conv, "conv")
    for step in range(2):
        xt = _randn(61 + step, 2, 1, cfg.d_model)
        jy, jc = jmamba.mamba_apply(jp, jnp.asarray(xt), jcfg, mode="decode",
                                    cache=jc)
        ty, tc = mamba2.mamba_apply(m, _t(xt), cfg, mode="decode", cache=tc)
        _close(ty, jy, f"decode {step}")
        _close(tc.state, jc.state, f"decode {step} state")
        _close(tc.conv, jc.conv, f"decode {step} conv")


def test_mamba_decode_continues_the_prefill(mamba_setup):
    """Prefill of 12 tokens then 4 decode steps equals one train pass over
    the 16 tokens, position by position."""
    _, cfg, _, m = mamba_setup
    x = _t(_randn(70, 2, 16, cfg.d_model))
    full, _ = mamba2.mamba_apply(m, x, cfg, mode="train")
    y, cache = mamba2.mamba_apply(m, x[:, :12], cfg, mode="prefill")
    torch.testing.assert_close(y, full[:, :12], rtol=TOL, atol=TOL)
    for t in range(12, 16):
        y, cache = mamba2.mamba_apply(m, x[:, t: t + 1], cfg, mode="decode",
                                      cache=cache)
        torch.testing.assert_close(y[:, 0], full[:, t], rtol=TOL, atol=TOL)
