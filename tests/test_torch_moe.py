"""Port parity for the MoE layer: `repro_torch.models.moe` against the JAX
package's `repro.models.moe` on the same numpy inputs, at the reduced
olmoe and deepseek-moe configs (4 experts, top-2, expert width 64;
deepseek with 2 shared experts), the reference's weights carried across.

Tolerances: float32 outputs and aux losses to rtol = atol = 1e-4; bfloat16
outputs within 1e-2 of the output's largest magnitude (the two packages'
bf16 products round in different orders).  Ties are built exactly (equal router columns, equal tokens),
where both packages must select the same experts and keep the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import moe as jmoe
from repro_torch.configs import registry
from repro_torch.models import moe

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["olmoe-1b-7b", "deepseek-moe-16b"]
F32_TOL = 1e-4
BF16_REL = 1e-2


def _cfgs(arch, dtype="float32", **kw):
    return (jregistry.reduced_arch(arch).replace(dtype=dtype, **kw),
            registry.reduced_arch(arch).replace(dtype=dtype, **kw))


def _params(jcfg, seed=0):
    """The reference's `moe_init` leaves as host arrays."""
    return jax.device_get(jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))


def _port(cfg, tree) -> moe.MoE:
    m = moe.MoE(cfg)
    for name, value in tree.items():
        if isinstance(value, dict):
            for leaf, v in value.items():
                getattr(m.shared, leaf).copy_(torch.from_numpy(np.array(v)))
        else:
            getattr(m, name).copy_(torch.from_numpy(np.array(value)))
    return m


def _run(jcfg, cfg, tree, x, dtype="float32"):
    want, jaux = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg))(
        {k: jax.tree.map(jnp.asarray, v) for k, v in tree.items()},
        jnp.asarray(x).astype(dtype))
    got, aux = moe.moe_apply(_port(cfg, tree),
                             torch.from_numpy(x).to(getattr(torch, dtype)),
                             cfg)
    return (got.float().numpy(), float(aux),
            np.asarray(want.astype(jnp.float32)), float(jaux))


@pytest.mark.parametrize("s,k,e", [(1, 2, 4), (8, 2, 4), (16, 8, 64),
                                   (32, 2, 4), (100, 6, 64), (512, 8, 64),
                                   (512, 6, 64), (4096, 8, 64)])
def test_capacity_matches_reference(s, k, e):
    jcfg, cfg = _cfgs("olmoe-1b-7b", moe_top_k=k, num_experts=e)
    assert moe._capacity(cfg, s) == jmoe._capacity(jcfg, s)
    assert moe._capacity(cfg, s) <= s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dtype):
    """Output and aux loss on a random batch (2 x 24 tokens); deepseek adds
    its shared experts."""
    jcfg, cfg = _cfgs(arch, dtype)
    tree = _params(jcfg)
    assert ("shared" in tree) == (cfg.num_shared_experts > 0)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    got, aux, want, jaux = _run(jcfg, cfg, tree, x, dtype)
    assert got.shape == (2, 24, cfg.d_model)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(aux, jaux, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_REL * np.abs(want).max())
        np.testing.assert_allclose(aux, jaux, rtol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_keep_every_tie_and_lower_token_indices(arch):
    """Experts 0-2 get equal router columns, so each token's top-2 mask by
    threshold selects 3 or 4 experts; all 32 tokens are equal, so every
    (row, expert) top-C over S ties and keeps the 24 lowest indices: the
    last 8 tokens get nothing from the routed experts."""
    jcfg, cfg = _cfgs(arch)
    tree = _params(jcfg)
    router = np.array(tree["router"])
    router[:, 1] = router[:, 2] = router[:, 0]
    tree["router"] = router
    x = np.broadcast_to(np.random.default_rng(2).standard_normal(
        cfg.d_model).astype(np.float32), (2, 32, cfg.d_model)).copy()
    cap = moe._capacity(cfg, 32)
    assert cap == 24
    got, aux, want, jaux = _run(jcfg, cfg, tree, x)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux, jaux, rtol=F32_TOL, atol=F32_TOL)
    xt = torch.from_numpy(x)
    probs = torch.softmax(xt @ torch.from_numpy(router), -1)
    thresh = torch.topk(probs, cfg.moe_top_k, dim=-1).values[..., -1:]
    assert int((probs >= thresh).sum(-1).min()) > cfg.moe_top_k
    routed = got
    if cfg.num_shared_experts:
        shared = _port(cfg, tree).shared(xt, cfg.act).numpy()
        routed = got - shared
    assert np.abs(routed[:, :cap]).min() > 0
    np.testing.assert_array_equal(routed[:, cap:], 0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_overflowing_expert_drops_tokens_as_reference(arch):
    """A router column aligned with the tokens' common direction pulls most
    of 64 tokens to expert 0, above its capacity of 40: the tokens kept
    (those of highest probability, ties to the lower index) are the
    reference's, so the outputs agree."""
    jcfg, cfg = _cfgs(arch)
    tree = _params(jcfg)
    rng = np.random.default_rng(3)
    common = rng.standard_normal(cfg.d_model).astype(np.float32)
    x = (common + 0.5 * rng.standard_normal(
        (2, 64, cfg.d_model))).astype(np.float32)
    router = np.array(tree["router"])
    router[:, 0] = common / np.linalg.norm(common) * 0.5
    tree["router"] = router
    cap = moe._capacity(cfg, 64)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), -1)
    thresh = torch.topk(probs, cfg.moe_top_k, dim=-1).values[..., -1:]
    per_expert = (probs >= thresh).sum(1)                 # [B, E]
    assert int(per_expert[:, 0].min()) > cap              # it overflows
    got, aux, want, jaux = _run(jcfg, cfg, tree, x)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux, jaux, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_gives_the_same_bits_twice(dtype):
    """The combine has no atomic scatter: two runs on the same
    inputs are bit-equal; and it equals a per-expert `index_add_` (each
    (row, expert) holds distinct tokens) in float32."""
    jcfg, cfg = _cfgs("olmoe-1b-7b", dtype)
    m = _port(cfg, _params(jcfg))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    a, _ = moe.moe_apply(m, x, cfg)
    b, _ = moe.moe_apply(m, x, cfg)
    assert torch.equal(a, b)
    if dtype != "float32":
        return
    # the same slots combined by index_add_, expert by expert
    cidx = torch.argsort(torch.rand(3, 4, 40, generator=torch.Generator()
                                    .manual_seed(6)), -1)[..., :24]
    cgate = torch.rand(3, 4, 24, generator=torch.Generator().manual_seed(7))
    got = moe._ffn_body(x, cidx, cgate, m.wi, m.wu, m.wo, act=cfg.act)
    want = torch.zeros_like(x)
    for bi in range(3):
        for e in range(4):
            xe = x[bi, cidx[bi, e]]
            h = torch.nn.functional.silu(xe @ m.wi[e]) * (xe @ m.wu[e])
            want[bi].index_add_(0, cidx[bi, e], (h @ m.wo[e])
                                * cgate[bi, e, :, None])
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
