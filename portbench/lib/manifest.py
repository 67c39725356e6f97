"""Find a cell's files by the names that BENCHMARK.json gives.

A cell (`workloads` entry) names a configuration and a traffic mix.  The
configuration's file is the one its `configs` entry names; the traffic mix
is `portbench/traffic/<traffic>.json`; the cell's limits are
`portbench/limits/<cell>.json`; each metric is read by
`portbench/metrics/<metric>.py`.  Adding a cell, a mix or a
metric is adding those files and entries: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "portbench"
# what every configuration states of its source: the row width and the
# memory's scale; only the scale may be cut to fit a card
PUBLISHED = ("engine.dim", "corpus.rows")
SCALE = ("corpus.rows",)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    root: str = ROOT


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: Optional[dict] = None,
         root: str = ROOT) -> Cell:
    """The cell `name` of `bench` (BENCHMARK.json at `root` by default)
    with its configuration, traffic mix, limits and metric entries."""
    bench = bench if bench is not None else benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=conf["name"],
        config=load_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(root, PACKAGE, "traffic",
                                       f"{w['traffic']}.json")),
        limits=load_json(os.path.join(root, PACKAGE, "limits",
                                      f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)


def check_cuts(conf: dict, entry: dict) -> None:
    """Raise ValueError unless the configuration `conf` keeps its source's
    widths and lists each cut of scale.

    `conf["published"]` gives the source's widths and scale by dotted key
    (`engine.dim`, `corpus.rows`).  A key that `reduced` does not name
    equals its published value; a key that it names is a scale key (a
    width is never cut) and lies below its published value.  The file's
    `reduced` is its `configs` entry's (`entry`) in BENCHMARK.json."""
    published = conf.get("published", {})
    missing = set(PUBLISHED) - set(published)
    if missing:
        raise ValueError(f"`published` lacks {sorted(missing)}")
    reduced = conf["reduced"]
    if reduced != entry["reduced"]:
        raise ValueError(f"the file's reduced {reduced} is not its entry's "
                         f"{entry['reduced']}")
    for key in reduced:
        if key not in SCALE:
            raise ValueError(f"{key} is not a scale key: only {SCALE} may "
                             "be cut")
    for key, value in published.items():
        got = _dotted(conf, key)
        if key in reduced and not got < value:
            raise ValueError(f"{key} = {got} is listed as cut but is not "
                             f"below its published {value}")
        if key not in reduced and got != value:
            raise ValueError(f"{key} = {got} differs from its published "
                             f"{value} and is not in reduced")


def _dotted(conf: dict, key: str):
    """The value of a dotted key (`engine.dim`) of a configuration."""
    for part in key.split("."):
        conf = conf[part]
    return conf


def reader(metric: str, root: str = ROOT) -> Callable:
    """`read(ctx)` of `portbench/metrics/<metric>.py` (the name may hold
    dots, so the file is loaded by its path, not imported by name)."""
    path = os.path.join(root, PACKAGE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


