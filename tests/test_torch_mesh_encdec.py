"""seamless-m4t-large-v2 (reduced: 2 encoder and 2 decoder layers, 4 q
heads over 2 kv heads) over the port's (data, model) mesh on the CPU,
held against the JAX package by the checks of
`test_torch_mesh_serving.py`: the encoder over each data block's source
frames, the decoder's prefill and 3 decode steps against the reference
unsharded and on its (1, 2) / (2, 1) mesh (self and cross attention on
each shard's q heads, the kv heads cut or attended by `local_kv_heads`),
the self and cross K/V caches and their placements, the placed leaves
(the stacked encoder/decoder MLPs cut over 'model' by layer), the
bit-identical replicas, and `serve_step.generate` on a placed model.
Tolerances as there.
"""
import jax
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import api, lm, specs
from repro_torch.serving import serve_step
from test_torch_mesh_serving import (  # noqa: F401  (fixtures)
    CASES, MESHES, _mesh, check_placed_leaves, check_prefill_and_decode,
    check_replicas, oracle, one_thread)

jax.config.update("jax_platform_name", "cpu")

ARCH = "seamless-m4t-large-v2"


@pytest.mark.parametrize("dtype,shape", CASES)
def test_mesh_prefill_and_decode_match_reference(oracle, dtype, shape):
    check_prefill_and_decode(oracle, ARCH, dtype, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_placed_leaves_match_reference_shardings(shape):
    check_placed_leaves(ARCH, shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_model_replicas_are_bit_identical(shape):
    check_replicas(ARCH, shape)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_generate_serves_a_placed_model(shape):
    """`serve_step.generate` with ``src_emb`` on a placed model: the
    one-device model's greedy tokens (float32)."""
    cfg = registry.reduced_arch(ARCH).replace(dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(2), cfg)
    batch = api.synth_batch(torch.Generator().manual_seed(3), cfg,
                            "prefill", 4, 16)
    want = serve_step.generate(params, cfg, batch, 6, 16)
    sp = specs.place_params(params, cfg, _mesh(shape))
    got = serve_step.generate(sp, cfg, batch, 6, 16)
    assert torch.equal(got, want)
