"""zamba2-2.7b (reduced: 12 mamba2 layers of 16 heads, the shared
attention block after every 6) over the port's (data, model) mesh on the
CPU, held against the JAX package by the checks of
`test_torch_mesh_serving.py`: prefill and 3 decode steps against the
reference unsharded and on its (1, 2) / (2, 1) mesh (each shard's whole
heads, B/C whole on every shard, the gated RMSNorm over all of d_inner
after a sum over 'model', out_proj row-parallel; the shared block's
unstacked MLP column/row-parallel), the states, the conv windows (x
channels model-cut beside the replicated B/C channels) and the shared
block's K/V per group, the placed leaves, the bit-identical replicas, and
a placed model saved and restored onto other meshes leaf for leaf.
bfloat16 to 2e-2 of the logit scale, its unsharded bound; else as there.
"""
import jax
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import lm, mamba2, sharding, specs
from test_torch_mesh_serving import (  # noqa: F401  (fixtures)
    CASES, MESHES, _mesh, check_placed_leaves, check_prefill_and_decode,
    check_replicas, check_reshard_restore, oracle, one_thread)

jax.config.update("jax_platform_name", "cpu")

ARCH = "zamba2-2.7b"


@pytest.mark.parametrize("dtype,shape", CASES)
def test_mesh_prefill_and_decode_match_reference(oracle, dtype, shape):
    check_prefill_and_decode(oracle, ARCH, dtype, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_placed_leaves_match_reference_shardings(shape):
    check_placed_leaves(ARCH, shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_model_replicas_are_bit_identical(shape):
    check_replicas(ARCH, shape)


def test_placed_model_restores_onto_other_meshes(tmp_path):
    check_reshard_restore(ARCH, tmp_path)


def test_gated_norm_needs_the_sum_over_model():
    """The trap GSPMD hides: mamba2's gated RMSNorm spans all of d_inner,
    which the heads cut over 'model'.  Each shard's slice normed by its
    own mean square is not the whole norm's slice; with the sum of the
    slices' squares over 'model' first it is (f32, 1e-5)."""
    cfg = registry.reduced_arch(ARCH).replace(dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(8), cfg)
    sp = specs.place_params(params, cfg, _mesh((1, 4)))
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(9))
    blk = params.blocks[0]
    yg, _ = mamba2.mamba_gated(blk, x, cfg, mode="train")
    want = lm.layers.rms_norm(yg, blk.norm, cfg.norm_eps)
    bl = sp.gathered("blocks.", layer=0)
    parts = []
    for i, b in enumerate(bl):
        lm._mamba_heads(b, cfg, i, 4)
        parts.append(mamba2.mamba_gated(b, x, cfg, mode="train")[0])
    n = cfg.ssm_d_inner // 4
    for i, y in enumerate(parts):
        torch.testing.assert_close(y, yg[..., i * n:(i + 1) * n], rtol=1e-5,
                                   atol=1e-5)
    sq = sharding.all_sum([(y * y).sum(-1, keepdim=True) for y in parts],
                          sp.mesh, "model")
    for i, (y, b, q) in enumerate(zip(parts, bl, sq)):
        own = lm.layers.rms_norm(y, b.norm, cfg.norm_eps)
        summed = y * torch.rsqrt(q / cfg.ssm_d_inner + cfg.norm_eps) * b.norm
        piece = want[..., i * n:(i + 1) * n]
        torch.testing.assert_close(summed, piece, rtol=1e-5, atol=1e-5)
        assert (own - piece).abs().max() > 1e-2
