"""The port's (1, 4) mesh in bfloat16 against the reference's own run on a
(1, 4) mesh: the one 'model' width that the two CPU devices
`tests/conftest.py` forces give the reference no mesh of.  The reference
runs in a subprocess with four CPU devices, its mesh built with
``jax.sharding.Mesh`` (Auto axes), and writes its logits for the port to
compare.  Reduced granite-3-2b, olmoe-1b-7b, rwkv6-1.6b and zamba2-2.7b,
prefill of 12 tokens and 3 decode steps: within 1e-2 of the logits'
largest magnitude (zamba2 2e-2, its unsharded bound), the greedy
tokens equal where the reference's top-2 margin exceeds that (the same
'model' width on both sides, so both round the same partial products; see
`test_torch_mesh_serving.py`).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro_torch.configs import registry
from test_torch_mesh_serving import (  # noqa: F401  (fixtures)
    BATCH, BF16_REL, BF16_SCALE, PROMPT, STEPS, _check_bf16, _port_run,
    one_thread)

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["granite-3-2b", "olmoe-1b-7b", "rwkv6-1.6b", "zamba2-2.7b"]
RUNS = [("bfloat16", (1, 4))]

SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import registry
from repro.models import lm, specs
from repro.models.sharding import use_mesh

out_path, archs, runs = sys.argv[1], sys.argv[2].split(","), sys.argv[3]
assert jax.device_count() == 4, jax.devices()
PROMPT, S_MAX, STEPS, BATCH = 12, 32, 3, 2
out = {}
for arch in archs:
    for run in runs.split(","):
        dtype, shape = run.split(":")
        shape = tuple(int(n) for n in shape.split("x"))
        cfg = registry.reduced_arch(arch).replace(dtype=dtype)
        params = lm.init_params(jax.random.PRNGKey(0), cfg)
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        with use_mesh(mesh):
            p = jax.device_put(params, specs.param_shardings(cfg, mesh))
            prefill = jax.jit(lambda p, b: lm.prefill(p, cfg, b, S_MAX))
            decode = jax.jit(lambda p, t, c, q: lm.decode_step(p, cfg, t, c, q))
            l, c, _ = prefill(p, {"tokens": jnp.asarray(toks[:, :PROMPT])})
            steps = [np.asarray(l.astype(jnp.float32))]
            for t in range(PROMPT, PROMPT + STEPS):
                l, c = decode(p, jnp.asarray(toks[:, t: t + 1]), c,
                              jnp.full((BATCH,), t, jnp.int32))
                steps.append(np.asarray(l.astype(jnp.float32)))
        out[f"{arch}/{run}"] = np.stack(steps)
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """The reference's logits on its own (1, 4) mesh."""
    path = str(tmp_path_factory.mktemp("wide") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    runs = ",".join(f"{d}:{s[0]}x{s[1]}" for d, s in RUNS)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, path,
                           ",".join(ARCHS), runs], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as f:
        return dict(f)


@pytest.mark.parametrize("dtype,shape", RUNS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_matches_reference_on_a_mesh_of_its_shape(wide, arch, dtype,
                                                       shape):
    want = wide[f"{arch}/{dtype}:{shape[0]}x{shape[1]}"]
    jcfg = jregistry.reduced_arch(arch)
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)
    cfg = registry.reduced_arch(arch).replace(dtype=dtype)
    _, out, _, _ = _port_run(cfg, jp, toks, shape)
    assert len(out) == len(want) == STEPS + 1
    compared = sum(_check_bf16(logits.full().to(torch.float32).numpy(), w,
                               f"step {step}", BF16_SCALE.get(arch, BF16_REL))
                   for step, (logits, w) in enumerate(zip(out, want)))
    assert compared
