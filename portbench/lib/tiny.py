"""A cell cut to a size that a CPU test run holds.

The same files and code paths as the cell on the card, with the memory at
128 lists of 64 slots over 2,048 rows of dimension 128, two recall
sessions, one writer of 64-row batches, and limits that separate the
program's readings from the control's at that size (bf16 products over
128 components round more than over 1024).

A cell held out of BENCHMARK.json (`portbench/held/<cell>.json`: its
`configs` and `workloads` entries, kept until a bound holds its end-to-end
metrics on the card) is found here too, so that its code paths stay tested.
"""
from __future__ import annotations

import copy
import glob
import os

from portbench.lib import manifest

LIMITS = {
    "float32": {"score_err": 4e-3, "rank_gap": 2e-3, "probed_miss": 0.02},
    "int8": {"score_err": 1e-5, "rank_gap": 1e-4, "probed_miss": 0.02},
}


def shrink(cell: manifest.Cell) -> manifest.Cell:
    c = copy.deepcopy(cell)
    c.config["engine"].update(dim=128, n_clusters=128, list_capacity=64,
                              nprobe=8)
    c.config["spill_capacity"] = 1024
    c.config["corpus"]["rows"] = 2048
    c.traffic.update(recall_sessions=2, warmup_seconds=0.3)
    if c.traffic["writer_sessions"]:
        c.traffic.update(writer_sessions=1, insert_rows=64, delete_rows=64)
    lim = LIMITS[c.config["engine"]["store_dtype"]]
    c.limits["sample"] = {"per_size": 8, "after_rebuild": 8}
    for name, value in lim.items():
        c.limits["numbers"][name] = {"max": value}
    # a rebuild needs about a second on the CPU: not every short window
    # holds one
    c.limits["numbers"].pop("rebuild_seen", None)
    return c


def held(root: str = manifest.ROOT) -> list:
    """The entries of every held cell under `portbench/held/`."""
    return [manifest.load_json(p) for p in sorted(glob.glob(
        os.path.join(root, manifest.PACKAGE, "held", "*.json")))]


def with_held(bench: dict, root: str = manifest.ROOT) -> dict:
    """`bench` with the held cells' configurations, cells and metrics
    added.  A held metric entry that `bench` names already adds its
    `workloads` to that entry's; one that `bench` lacks is added whole."""
    bench = copy.deepcopy(bench)
    for h in held(root):
        bench["configs"] += h["configs"]
        bench["workloads"] += h["workloads"]
        for kind in ("end_to_end", "per_layer"):
            have = {m["name"]: m for m in bench[kind]}
            for m in h.get(kind, []):
                if m["name"] not in have:
                    bench[kind].append(copy.deepcopy(m))
                elif "workloads" in have[m["name"]]:
                    have[m["name"]]["workloads"] += m["workloads"]
    return bench


def cell(name: str, root: str = manifest.ROOT, bench=None) -> manifest.Cell:
    bench = bench if bench is not None else manifest.benchmark(root)
    return shrink(manifest.cell(name, bench=with_held(bench, root),
                                root=root))
