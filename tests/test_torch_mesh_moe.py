"""olmoe-1b-7b (reduced: 4 experts, top-2) over the port's (data, model)
mesh on the CPU, held against the JAX package by the checks of
`test_torch_mesh_serving.py` (prefill and 3 decode steps against the
reference unsharded and on its (1, 2) / (2, 1) mesh, the placements, the
bit-identical replicas, the RAG prefill's ids), and its MoE layer's
expert-parallel branch against the reference's ``shard_map`` branch.
Tolerances as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import sharding as jsharding
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import lm, moe, sharding
from test_torch_mesh_serving import (  # noqa: F401  (fixtures)
    BF16_REL, CASES, F32_TOL, MESHES, _j, _jmesh, _mesh, _port_run,
    check_placed_leaves, check_prefill_and_decode, check_rag_prefill,
    check_replicas, oracle, rag_oracle)

jax.config.update("jax_platform_name", "cpu")

ARCH = "olmoe-1b-7b"


@pytest.mark.parametrize("dtype,shape", CASES)
def test_mesh_prefill_and_decode_match_reference(oracle, dtype, shape):
    check_prefill_and_decode(oracle, ARCH, dtype, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_placed_leaves_match_reference_shardings(shape):
    check_placed_leaves(ARCH, shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_model_replicas_are_bit_identical(shape):
    check_replicas(ARCH, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_rag_prefill_on_mesh_matches_reference(rag_oracle, shape):
    check_rag_prefill(rag_oracle, ARCH, shape)


def test_bf16_tp_gap_is_the_reference_own(oracle):
    """Why bfloat16 runs across a 'model' axis are held to the reference
    run of that width: the reference's own (1, 2) olmoe run is farther
    than 1e-2 of the scale from its unsharded run, and the port's (1, 2)
    run is within it of the reference's (1, 2) run."""
    jp, toks, runs = oracle("olmoe-1b-7b", "bfloat16")
    want, tp = runs[None][0][0], runs[(1, 2)][0][0]
    assert np.abs(tp - want).max() > BF16_REL * np.abs(want).max()
    cfg = registry.reduced_arch("olmoe-1b-7b").replace(dtype="bfloat16")
    _, out, _, _ = _port_run(cfg, jp, toks, (1, 2))
    got = out[0].full().float().numpy()
    assert np.abs(got - tp).max() <= BF16_REL * np.abs(tp).max()


# ---------------------------------------------------------------------------
# the MoE layer's expert-parallel branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (2, 1)])
def test_expert_parallel_branch_matches_reference_shard_map(monkeypatch,
                                                            shape):
    """olmoe's MoE layer on a mesh: the reference on its (1, 2) mesh takes
    its shard_map branch (counted); the port takes expert parallelism
    where the reference's conditions hold ('model' > 1, the batch divides
    over 'data', E divides over 'model'), else runs every expert gathered;
    y within 1e-4 of the reference's, the aux loss too, and the same bits
    twice."""
    jcfg = jregistry.reduced_arch("olmoe-1b-7b").replace(dtype="float32")
    cfg = registry.reduced_arch("olmoe-1b-7b").replace(dtype="float32")
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    layer = jax.tree.map(lambda t: t[0], jp["blocks"]["mlp"])
    x = np.random.default_rng(6).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    calls = []
    real = jmoe.shard_map

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jmoe, "shard_map", counted)
    jm = _jmesh((1, 2))
    with jsharding.use_mesh(jm):
        want, jaux = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg))(
            layer, jnp.asarray(x))
    assert calls, "the reference did not take its shard_map branch"
    want_plain, _ = jmoe.moe_apply(layer, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_j(want), _j(want_plain), rtol=F32_TOL,
                               atol=F32_TOL)

    sp = convert.lm_params_to_mesh(cfg, jp, _mesh(shape))
    call = lm._mesh_call(sp, cfg, x.shape[0])
    assert call.ep == (shape[1] > 1)
    whole = None if call.ep else "mlp."
    ps = [b.mlp for b in sp.gathered("blocks.", layer=0, whole=whole)]
    xs = sharding.place(torch.from_numpy(x), (call.batch_entry, None, None),
                        sp.mesh).parts
    ys, aux = moe.moe_apply_sharded(ps, xs, cfg, sp.mesh, ep=call.ep,
                                    batch_split=call.batch_split)
    if call.ep:
        assert ps[0].wi.shape[0] == cfg.num_experts // shape[1]
    got = sharding.Placed(tuple(ys), (call.batch_entry, None, None),
                          sp.mesh, x.shape).full()
    np.testing.assert_allclose(got.numpy(), _j(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_TOL)
    ys2, _ = moe.moe_apply_sharded(ps, xs, cfg, sp.mesh, ep=call.ep,
                                   batch_split=call.batch_split)
    assert all(torch.equal(a, b) for a, b in zip(ys, ys2))


