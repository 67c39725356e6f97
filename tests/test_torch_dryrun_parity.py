"""Dot-FLOP parity of the port's dry run with the reference's HLO rollup.

The reference's step is compiled with no mesh (``jax.jit(...).lower(
eval_shape specs).compile()``) and counted by
`repro.launch.hlo_analysis.rollup`; the port's is traced on the meta
device by `repro_torch.launch.dryrun.trace_cell`.  At S a multiple of
1,024 (seamless: each half), so that the reference's last key chunk needs
no padding (it pads to 1,024 keys; the port's stops at S_k).
"""
import jax
import jax.numpy as jnp
import pytest

from repro.configs import registry as jregistry
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import hlo_analysis
from repro.models import api as japi
from repro.models import lm as jlm
from repro.train import optimizer as joptimizer
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import rwkv6

ARCHS = registry.list_archs()


def _seq(arch: str) -> int:
    return 2048 if registry.get_arch(arch).is_encdec else 1024


def _reference_flops(jcfg, kind: str, s: int, b: int) -> int:
    params = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    shape = JShape("parity", kind, s, b)
    if kind == "train":
        step = jmake_train_step(jcfg, JTrainConfig())
        lowered = jax.jit(step).lower(
            params, jax.eval_shape(joptimizer.init, params),
            japi.train_batch_specs(jcfg, shape),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
    elif kind == "prefill":
        s_max = s // 2 if jcfg.is_encdec else s
        lowered = jax.jit(lambda p, bt: jlm.prefill(p, jcfg, bt, s_max)).lower(
            params, japi.prefill_batch_specs(jcfg, shape))
    else:
        def decode(p, tok, caches, pos):
            logits, caches = jlm.decode_step(p, jcfg, tok, caches, pos)
            real = jnp.arange(logits.shape[-1]) < jcfg.vocab_size
            nxt = jnp.argmax(jnp.where(real, logits, -jnp.inf), -1)
            return nxt.astype(jnp.int32)[:, None], caches
        lowered = jax.jit(decode).lower(
            params, *japi.decode_inputs_specs(jcfg, shape))
    return int(hlo_analysis.rollup(lowered.compile().as_text())["dot_flops"])


def _port_flops(cfg, kind: str, s: int, b: int) -> int:
    return dryrun.trace_cell(cfg, ShapeConfig("parity", kind, s, b))[0] \
        .dot_flops


def _wkv_bonus_flops(cfg, b: int, s: int) -> int:
    """The reference's bonus term ``einsum("bthk,hk,bthk->bth", r, u, k)``
    is a dot (2 x B x T x d_model FLOPs a layer over the padded chunks);
    the port's ``(r * u * k).sum(-1)`` is an elementwise product and a
    sum, which no FLOP counter counts."""
    clen = min(rwkv6.CHUNK, max(8, s))
    padded = -(-s // clen) * clen
    return 2 * cfg.num_layers * b * padded * cfg.d_model


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_dot_flops_equal_the_reference(arch):
    """Prefill at B = 1 over S tokens and a decode step at B = 2 over an
    S-slot cache: exact for every arch but rwkv6, whose WKV bonus term the
    reference computes as a dot (`_wkv_bonus_flops`)."""
    cfg, jcfg = registry.reduced_arch(arch), jregistry.reduced_arch(arch)
    s = _seq(arch)
    for kind, b, tokens in (("prefill", 1, s), ("decode", 2, 1)):
        want = _reference_flops(jcfg, kind, s, b)
        got = _port_flops(cfg, kind, s, b)
        if cfg.family == "ssm":
            want -= _wkv_bonus_flops(cfg, b, tokens)
        assert got == want, (kind, got, want)
