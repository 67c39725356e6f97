#!/usr/bin/env python3
"""Phases 4-5 of ``chip_smoke.py`` (the PAPER_1M f32 and int8 lifecycles
through MemoryService) from several checkouts in turn, on one NVIDIA card.

    python3 tools/ab_phases.py TREE [TREE ...] [--seed N]

Each TREE is the root of a checkout (e.g. the parent commit unpacked with
``git archive`` into a gitignored directory, and ``.``); each runs in its
own process, in the order given, so ``parent . . parent`` compares two
versions in turns on one card.  Prints one JSON line per run: the tree and,
per store policy, probed p50, full-scan QPS, insert rows/s, build s and
rebuild s.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KEYS = ("probed_p50_ms", "full_scan_qps", "insert_rows_per_s", "build_s",
        "rebuild_s")

RUN = """
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
""" % (KEYS,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for tree in args.trees:
        root = os.path.realpath(tree)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root, os.path.join(root, "src")]))
        out = subprocess.run([sys.executable, "-c", RUN, str(args.seed)],
                             cwd=root, env=env, capture_output=True,
                             text=True, check=True)
        print(json.dumps({"tree": tree,
                          **json.loads(out.stdout.splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
