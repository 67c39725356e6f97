"""A cell's traced run, read by the program's own spans and counters.

    python3 portbench/trace_spans.py --workload <name> --seed <n> \
        --seconds <s> [--out FILE]

Runs the cell once as `run.py --trace 1` runs it (the same harness, the
same profiler over the same window) and prints one JSON line: the run's
result, the window's spans table and ``span|op`` idle gaps
(`lib/spans.py`), the window's differences of `MemoryService.counters()`
and the readings they give (`readings`).  The window's edges are the
harness's own two reads of the scheduler's aggregates, at its start and
its end.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTION = "mem"


def _per(spans, name, key):
    s = spans["spans"].get(name)
    return 1e3 * s[key] / s["n"] if s and s["n"] else None


def _ratio(delta, num, den, scale=1e3):
    d = delta.get(den, 0)
    return scale * delta.get(num, 0) / d if d else None


def readings(spans: dict, delta: dict) -> dict:
    """Each reading of the window, or None where its span or counter saw
    nothing: the spans' device or host milliseconds per range, and the
    counters' window differences per event."""
    c = f"coll.{COLLECTION}."
    vectors = delta.get(c + "queries", 0)
    scans = sum(v for k, v in delta.items()
                if k.startswith("launches.scan_scores."))
    return {
        "flat_copy_ms.query": _per(spans, "ame.index.full_scan.flat_copy",
                                   "device_s"),
        "probed_host_ms": _per(spans, "ame.index.probed", "host_s"),
        "scan_launches_per_query": scans / vectors if vectors else None,
        "answer_copy_ms.query": _per(spans, "ame.coll.query.to_host",
                                     "host_s"),
        "admit_wait_ms.query": _ratio(delta, "sched.query.admit_wait_s",
                                      "sched.query.n"),
        "writer_lock_wait_ms.insert": _ratio(
            delta, c + "insert_lock_wait_s", c + "insert_calls"),
        "insert_clone_ms": _per(spans, "ame.index.insert.clone", "device_s"),
        "rebuild_lock_hold_ms": _ratio(delta, c + "rebuild_lock_hold_s",
                                       c + "rebuilds"),
    }


def traced(cell, seed: int, seconds: float, *, device: str = "cuda") -> dict:
    """`harness.run(cell, seed, seconds, trace=True)` with the spans table
    and the window's counters beside its result."""
    from portbench.lib import devtrace, harness, spans

    edges, tables = [], []
    real_stop, real_totals = devtrace.stop, harness.sched_totals

    def stop(handle):
        prof, t0 = handle
        window_s = time.perf_counter() - t0
        prof.stop()
        res = prof.profiler.kineto_results
        lo = res.trace_start_ns() if hasattr(res, "trace_start_ns") else None
        events = res.events()
        tables.append(spans.reduce(events, window_s, lo))
        return devtrace.reduce(events, window_s, lo)

    def sched_totals(svc):
        edges.append(svc.counters())
        return real_totals(svc)

    devtrace.stop, harness.sched_totals = stop, sched_totals
    try:
        result = harness.run(cell, seed, seconds, True,
                             t_process=time.perf_counter(), device=device)
    finally:
        devtrace.stop, harness.sched_totals = real_stop, real_totals
    first, last = edges[-2], edges[-1]
    delta = {k: v - first.get(k, 0) for k, v in last.items()}
    table = tables[-1]
    return {"result": result, "spans": table, "counters": delta,
            "readings": readings(table, delta)}


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
