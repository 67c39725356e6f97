"""The reference's collectives of granite-3-2b's or olmoe-1b-7b's reduced
train and decode steps (f32, 4 x 256 tokens) on its (1, 2), (2, 1) and
(2, 4) meshes, for `tests/test_torch_collective_parity*.py` (not a test
module; it needs eight CPU devices, so it runs in a process of its own):

    python tests/torch_collective_reference.py ARCH OUT.json

Each cell's ``rollup`` wire bytes by kind, and each collective op of the
compiled step by kind and ``op_name`` (`repro.launch.profile.attribute`:
its out bytes times its trip count) with its group size.
"""
import json
import os
import re
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro.launch import dryrun, hlo_analysis, profile  # noqa: E402

MESHES = ((1, 2), (2, 1), (2, 4))
KINDS = ("train", "decode")
SEQ, BATCH = 256, 4


def cell(arch: str, shape, kind: str) -> dict:
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    hlo = dryrun.lower_cell(cfg, ShapeConfig("p", kind, SEQ, BATCH), mesh,
                            TrainConfig()).compile().as_text()
    groups = {}
    for ln in hlo.splitlines():
        m = re.search(r'op_name="([^"]+)"', ln)
        if m and any(f" {k}(" in ln or f" {k}-start(" in ln
                     for k in hlo_analysis.COLLECTIVES):
            tag = re.sub(r"jit\([\w.\-]+\)/", "", m.group(1))[:90]
            groups[tag] = hlo_analysis._group_size(ln, default=2)
    return {"wire": hlo_analysis.rollup(hlo)["collective_bytes"],
            "ops": [[kind_, tag, b, groups.get(tag, 2)] for b, kind_, tag in
                    profile.attribute(hlo, "collectives")]}


def main(arch: str, out: str) -> None:
    res = {f"{kind} {s[0]}x{s[1]}": cell(arch, s, kind)
           for s in MESHES for kind in KINDS}
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
