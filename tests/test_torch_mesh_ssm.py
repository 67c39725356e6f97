"""rwkv6-1.6b (reduced: 8 heads of 16) over the port's (data, model) mesh
on the CPU, held against the JAX package by the checks of
`test_torch_mesh_serving.py`: prefill and 3 decode steps against the
reference unsharded and on its (1, 2) / (2, 1) mesh (the time mix on
each shard's whole heads, its WKV and GroupNorm head-local, one sum over
'model' for wo and one for cwv, the receptance's product gathered), the
state, shift caches and their placements, the placed leaves, the
bit-identical replicas, and a placed model saved and restored onto other
meshes leaf for leaf.  Tolerances as there.
"""
import jax
import pytest
import torch

from test_torch_mesh_serving import (  # noqa: F401  (fixtures)
    CASES, MESHES, check_placed_leaves, check_prefill_and_decode,
    check_replicas, check_reshard_restore, oracle, one_thread)

jax.config.update("jax_platform_name", "cpu")

ARCH = "rwkv6-1.6b"


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


@pytest.mark.parametrize("arch,shape", [("rwkv6-1.6b", (1, 16)),
                                        ("zamba2-2.7b", (1, 32))])
def test_heads_that_do_not_divide_run_whole(arch, shape):
    """Where the recurrent heads do not divide over 'model' but the hidden
    does (the reference's placements then cut a head: rwkv6's 8 heads on
    16 shards, zamba2's 16 mamba2 heads on 32), the model code runs those
    matrices whole on every shard and keeps the states whole: prefill and
    2 decode steps within 1e-4 of the unsharded port (float32)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, specs
    from test_torch_mesh_serving import _mesh
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(11), cfg)
    sp = specs.place_params(params, cfg, _mesh(shape))
    key = "blocks.wr" if cfg.family == "ssm" else "blocks.w_x"
    assert sp.tp_split(key, 1)
    toks = torch.randint(0, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(12),
                         dtype=torch.int32)
    want, wc, wpos = lm.prefill(params, cfg, {"tokens": toks[:, :8]}, 12)
    got, gc, pos = lm.prefill(sp, cfg, {"tokens": toks[:, :8]}, 12)
    state = gc.state if cfg.family == "ssm" else gc.mamba.state
    assert state.spec[2] is None and all(
        p.shape[2] == state.shape[2] for p in state.parts)
    for t in range(8, 10):
        torch.testing.assert_close(got.full(), want, rtol=1e-4, atol=1e-4)
        pos = pos + 1
        want, wc = lm.decode_step(params, cfg, toks[:, t: t + 1], wc, pos)
        got, gc = lm.decode_step(sp, cfg, toks[:, t: t + 1], gc, pos)
    torch.testing.assert_close(got.full(), want, rtol=1e-4, atol=1e-4)


def test_serve_production_mesh_flag_serves_rwkv6(capsys):
    """`launch.serve --production-mesh --arch rwkv6-1.6b`: all 256 shards
    on the CPU (its 8 heads do not divide over 16: the time mix runs
    whole on every shard)."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--production-mesh", "--arch",
                      "rwkv6-1.6b", "--requests", "2", "--decode-steps", "2",
                      "--corpus", "512", "--concurrent-inserts", "32"])
    assert "model placed on the mesh data=16xmodel=16" in \
        capsys.readouterr().out
    assert out["turns"][0]["tokens"].shape == (2, 2)
