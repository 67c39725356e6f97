"""qwen2-vl-7b (reduced: M-RoPE sections (4, 6, 6), 4 q heads over 2 kv
heads) over the port's (data, model) mesh on the CPU, held against the
JAX package by the checks of `test_torch_mesh_serving.py`: the prefill
with vision embeddings spliced into each data block and non-default
M-RoPE positions (`mrope_grid`), then 3 decode steps, against the
reference unsharded and on its (1, 2) / (2, 1) mesh; every cache leaf;
the placements; the bit-identical replicas; the RAG prefill with
non-default positions against ``repro.serving.rag`` (ids equal, f32
logits and caches within 1e-4).  Tolerances as there.
"""
import jax
import pytest

from test_torch_mesh_serving import (  # noqa: F401  (fixtures)
    CASES, MESHES, check_placed_leaves, check_prefill_and_decode,
    check_rag_prefill, check_replicas, oracle, rag_oracle, one_thread)

jax.config.update("jax_platform_name", "cpu")

ARCH = "qwen2-vl-7b"


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
def test_rag_prefill_with_mrope_on_mesh_matches_reference(rag_oracle, shape):
    check_rag_prefill(rag_oracle, ARCH, shape)
