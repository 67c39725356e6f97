"""Train-step dot-FLOP parity of the port's dry run with the reference's
HLO rollup (the reference's side built as in
`test_torch_dryrun_parity`): one step at B = 1 over S = 1,024 tokens
(seamless: 2 x 1,024), each side's remat set alike.
"""
import pytest

from repro.configs import registry as jregistry
from repro_torch.configs import registry
from test_torch_dryrun_parity import (_port_flops, _reference_flops, _seq,
                                      _wkv_bonus_flops)


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2"])
def test_train_dot_flops_equal_the_reference_with_remat(arch):
    """One train step with per-layer remat on both sides (B = 1): the
    forward, the recompute and the backward products are the reference's,
    exactly."""
    cfg = registry.reduced_arch(arch).replace(remat=True)
    jcfg = jregistry.reduced_arch(arch).replace(remat=True)
    s = _seq(arch)
    assert _port_flops(cfg, "train", s, 1) == \
        _reference_flops(jcfg, "train", s, 1)


def test_train_dot_flops_without_remat_differ_by_the_chunk_recompute():
    """With remat off on both sides the reference still checkpoints its
    flash attention per key chunk (``jax.checkpoint(step)``), so its
    backward recomputes each chunk's score product: one more Q.K^T per
    layer, 2 x B x S x S x H x Dh."""
    cfg = registry.reduced_arch("granite-3-2b").replace(remat=False)
    jcfg = jregistry.reduced_arch("granite-3-2b").replace(remat=False)
    s, b = 1024, 1
    qk = 2 * b * s * s * cfg.num_heads * cfg.head_dim * cfg.num_layers
    assert _reference_flops(jcfg, "train", s, b) - \
        _port_flops(cfg, "train", s, b) == qk


@pytest.mark.parametrize("arch, s, gap", [
    # the WKV bonus dot (`_wkv_bonus_flops`): six of them in the
    # reference's step (forward, recompute, and the products its backward
    # makes of the three-operand einsum); no attention, so a short
    # sequence will do
    ("rwkv6-1.6b", 256, 6 * _wkv_bonus_flops(
        registry.reduced_arch("rwkv6-1.6b"), 1, 256)),
    # the SSD intra-chunk term: the reference's three-operand einsum
    # differentiates into other products than the port's cb (.) L and
    # one batched product (its forward counts the same)
    ("zamba2-2.7b", 1024, 868_220_928),
])
def test_train_dot_flops_of_the_recurrent_archs_pinned(arch, s, gap):
    cfg = registry.reduced_arch(arch).replace(remat=True)
    jcfg = jregistry.reduced_arch(arch).replace(remat=True)
    assert _reference_flops(jcfg, "train", s, 1) - \
        _port_flops(cfg, "train", s, 1) == gap
