"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in BENCHMARK.json at the checkout's root.
The last line on standard output is the result (JSON); the last lines on
standard error are the numbers that decided `correct`, each beside its
limit.  Exits with another code than 0, and prints no result, without a
CUDA card, or if JAX or the JAX package were loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (this file's package) and the port's sources; never
# this file's own directory, whose module names could shadow others
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))
# every build and kernel cache of the run at a fixed path in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench.lib import harness, manifest, verdict

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         t_process=T_PROCESS)
    bad = verdict.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    notes = result.pop("notes")
    print("notes " + json.dumps(verdict.finite(notes)), file=sys.stderr)
    verdict.print_lines(result["checks"])
    sys.stderr.flush()
    print(json.dumps(verdict.finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
