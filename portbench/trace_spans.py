"""A cell's traced run, read by the program's own spans and counters.

    python3 portbench/trace_spans.py --workload <name> --seed <n> \
        --seconds <s> [--out FILE]

Runs the cell once as `run.py --trace 1` runs it (the same harness, the
same profiler over the same window) and prints one JSON line from that
run's own reader context: the run's result, the window's spans table and
``span|op`` idle gaps (`lib/spans.py`), the window's differences of
`MemoryService.counters()`, and the readings of every per-layer metric of
BENCHMARK.json that the program's spans or counters give, each read by its
own reader under `metrics/`.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = ("program_span", "program_counter")


def readings(ctx) -> dict:
    """Each per-layer metric of BENCHMARK.json read from the program's
    spans or counters, by its reader, over the run's context `ctx`; None
    where its span or counter saw nothing."""
    from portbench.lib import manifest
    return {m["name"]: manifest.reader(m["name"])(ctx)
            for m in manifest.benchmark()["per_layer"]
            if m["source"] in PROGRAM}


def traced(cell, seed: int, seconds: float, *, device: str = "cuda") -> dict:
    """`harness.run(cell, seed, seconds, trace=True)`, with its spans
    table, its window's counters and the readings beside its result."""
    from portbench.lib import harness

    result, ctx = harness.run(cell, seed, seconds, True,
                              t_process=time.perf_counter(), device=device,
                              want_ctx=True)
    return {"result": result, "spans": ctx.spans,
            "counters": dict(ctx.counters), "readings": readings(ctx)}


def main(argv=None) -> int:
    # as run.py: the checkout's root and the port's sources on the path,
    # every build and kernel cache at a fixed path in the checkout
    sys.path[0] = ROOT
    sys.path.insert(1, os.path.join(ROOT, "src"))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from portbench.lib import manifest
    from portbench.lib.verdict import finite

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    out = traced(manifest.cell(args.workload), args.seed, args.seconds)
    out["workload"], out["seed"] = args.workload, args.seed
    line = json.dumps(finite(out))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
