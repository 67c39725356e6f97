#!/usr/bin/env python3
"""Phases of ``chip_smoke.py`` from several checkouts in turn, on one NVIDIA
card.

    python3 tools/ab_phases.py TREE [TREE ...] [--seed N] [--phase main|mesh]

``main`` (the default): phases 4-5, the PAPER_1M f32 and int8 lifecycles
through MemoryService; per store policy, probed p50, full-scan QPS, insert
rows/s, build s and rebuild s.  ``mesh``: phase 16's f32 checks of the
model on a (data, model) mesh of the card against the unsharded port
(16a granite-3-2b on (2, 4), 16c olmoe-1b-7b at 4 layers on (1, 4), 16e-16h
the other families, each as `mesh_against_one` runs it); per tag, the
median ms of a decode step on the mesh and unsharded.

Each TREE is the root of a checkout (e.g. the parent commit unpacked with
``git archive`` into a gitignored directory, and ``.``); each runs in its
own process, in the order given, so ``parent . . parent`` compares two
versions in turns on one card.  Prints one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KEYS = ("probed_p50_ms", "full_scan_qps", "insert_rows_per_s", "build_s",
        "rebuild_s")

RUN = {"main": """
import dataclasses, json, sys
import torch
import chip_smoke as cs
from repro_torch.configs.ame_paper import PAPER_1M
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for cfg in (PAPER_1M, dataclasses.replace(PAPER_1M, store_dtype="int8")):
    r = cs.phase_main(int(sys.argv[1]), cfg)
    cs.release()
    out[cfg.store_dtype] = {k: r[k] for k in %r}
print(json.dumps(out))
""" % (KEYS,), "mesh": """
import json, sys
import torch
import chip_smoke as cs
from repro_torch.configs import registry
torch.backends.cuda.matmul.allow_tf32 = False
seed = int(sys.argv[1])
card = cs.nvidia_smi()
g = torch.Generator(device="cuda").manual_seed(seed + 16)
cases = [("16a", registry.get_arch(cs.SERVE_ARCH).replace(dtype="float32"),
          cs.MESH_TP_FSDP),
         ("16c", registry.get_arch(cs.FAMILY_ARCH).replace(
             dtype="float32", num_layers=cs.MOE_F32_LAYERS), cs.MESH_TP)]
for tag, arch, dtype, shape, depth in cs.MESH_FAMILIES:
    cfg = registry.get_arch(arch).replace(dtype=dtype)
    cases.append((tag, cfg.replace(num_layers=depth) if depth else cfg,
                  shape))
out = {"card": card}
for tag, cfg, shape in cases:
    r, sp = cs.mesh_against_one(tag, cfg, seed, g, shape, card)
    del sp
    cs.release()
    out[tag] = {"decode_ms_mesh": r["decode_ms_mesh"],
                "decode_ms_one_device": r["decode_ms_one_device"]}
print(json.dumps(out))
"""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", default="main", choices=tuple(RUN))
    args = ap.parse_args(argv)
    for tree in args.trees:
        root = os.path.realpath(tree)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root, os.path.join(root, "src")]))
        out = subprocess.run([sys.executable, "-c", RUN[args.phase],
                              str(args.seed)], cwd=root, env=env,
                             capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
        print(json.dumps({"tree": tree,
                          **json.loads(out.stdout.splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
