"""Readings that the limits of a cell are set from, on the card.

    python3 portbench/control.py --workload <name> --seconds 10 \
        --seeds <n> [<n> ...] --control-seeds <n> [<n> ...] \
        [--nprobe P --nprobe-seeds <n> [<n> ...]] \
        [--lower-ranks-seeds <n> [<n> ...]] [--out FILE]

Runs the cell at its own size and load, once a seed, in one process: on
`--seeds` the program's answers are judged (the lower readings), on
`--control-seeds` the reference takes the program's place in the lower
precision that the cell's limits file names (`control`), and on
`--nprobe-seeds` the program serves with `nprobe` P in place of the
configuration's, a probed path that reads fewer lists (the control of
`probed_miss`), and on `--lower-ranks-seeds` the program's probed
answers keep their first row and take the rest from ranks k+1..2k-1 of its
own wider answer: live rows, each with its own score, in order, that are
not the k best (the fault that `probed_miss` alone must catch).  Each
control must come out not correct (the upper readings).  One JSON line a run goes to standard output and, with
`--out`, to FILE.  The benchmark's own runs never run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))


def lower_ranks(real):
    """The probed path, answering its first row and then ranks k+1..2k-1."""
    def probed(state, q, cfg, k, nprobe):
        ids, scores = real(state, q, cfg, 2 * k - 1, nprobe)
        keep = [0] + list(range(k, 2 * k - 1))
        return ids[..., keep], scores[..., keep]
    return probed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--nprobe", type=int)
    ap.add_argument("--nprobe-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--lower-ranks-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import copy

    import torch
    from portbench.lib import harness, manifest
    from portbench.lib.verdict import finite
    from repro_torch.core import index as ivf
    real_probed = ivf.query_probed

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    fewer = copy.deepcopy(cell)
    if args.nprobe:
        fewer.config["engine"]["nprobe"] = args.nprobe
    below = cell.limits["control"]
    # (seed, cell, control's name, precision of the reference in the
    # program's place)
    runs = [(s, cell, None, None) for s in args.seeds] + [
        (s, cell, below, below) for s in args.control_seeds] + [
        (s, fewer, f"nprobe={args.nprobe}", None)
        for s in args.nprobe_seeds] + [
        (s, cell, "lower-ranks", None) for s in args.lower_ranks_seeds]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed, c, control, ref in runs:
            t0 = time.perf_counter()
            if control == "lower-ranks":
                ivf.query_probed = lower_ranks(real_probed)
            try:
                r = harness.run(c, seed, args.seconds, False, t_process=t0,
                                control=ref)
            finally:
                ivf.query_probed = real_probed
            line = json.dumps(finite({
                "workload": args.workload, "seed": seed,
                "control": control, "correct": r["correct"],
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "notes": r["notes"], "metrics": r["metrics"]}))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
