"""BENCHMARK.json and the files it names: names, units, keys, the
readers of every metric, and that each metric's `moves` is reported in
each of its cells; and the imports of every file under portbench/."""
import ast
import json
import math
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import manifest, tiny  # noqa: E402

BENCH = manifest.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and ".." not in p.split("/")
        assert not p.startswith("/") and not p.rstrip("/").endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p.rstrip("/") + "/")
                       for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check with 24 cells fits in the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) == len(
        BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_setup_s_is_an_end_to_end_metric_of_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25


def _cells_of(m, cells=CELLS):
    return m.get("workloads", cells)


# the held cells' metrics too, as they would stand once moved back
WITH_HELD = tiny.with_held(BENCH, ROOT)


@pytest.mark.parametrize("metric",
                         [m["name"] for m in WITH_HELD["per_layer"]])
def test_moves_is_reported_by_each_of_its_cells(metric):
    m = next(x for x in WITH_HELD["per_layer"] if x["name"] == metric)
    e2e = {x["name"]: x for x in WITH_HELD["end_to_end"]}
    cells = [w["name"] for w in WITH_HELD["workloads"]]
    assert m["moves"] in e2e
    assert set(_cells_of(m, cells)) <= set(_cells_of(e2e[m["moves"]],
                                                     cells))


def _limits_and_widths(c, bench=BENCH):
    assert c.limits["control"] in ("fp8", "bf16")
    for name, bound in c.limits["numbers"].items():
        assert set(bound) in ({"max"}, {"min"})
        assert math.isfinite(list(bound.values())[0])
    # every width of the source as published; a cut of scale is listed in
    # `reduced`, in the file and in its entry alike
    entry = next(x for x in bench["configs"] if x["name"] == c.config_name)
    manifest.check_cuts(c.config, entry)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files_and_metrics(cell):
    c = manifest.cell(cell, root=ROOT)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"], ROOT))
    _limits_and_widths(c)


@pytest.mark.parametrize("cell", [w["name"] for h in tiny.held(ROOT)
                                  for w in h["workloads"]])
def test_a_held_cell_has_its_files_and_stays_out(cell):
    bench = tiny.with_held(BENCH, ROOT)
    c = manifest.cell(cell, bench=bench, root=ROOT)
    assert cell not in CELLS
    h = next(x for x in tiny.held(ROOT)
             if cell in {w["name"] for w in x["workloads"]})
    # what the held file holds stays out, and its metric entries are the
    # benchmark's own but for the cells they list
    assert not {x["name"] for x in h["configs"]} & {
        x["name"] for x in BENCH["configs"]}
    have = {m["name"]: m for m in METRICS}
    for m in h.get("end_to_end", []) + h.get("per_layer", []):
        assert m["workloads"] == [cell]
        if m["name"] in have:
            assert {k: v for k, v in m.items() if k != "workloads"} == {
                k: v for k, v in have[m["name"]].items() if k != "workloads"}
    assert not any(cell in m.get("workloads", []) for m in METRICS)
    if h.get("end_to_end"):
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"], ROOT))
    _limits_and_widths(c, bench)


@pytest.mark.parametrize("name", ["hotpotqa-1m-f32.json",
                                  "hotpotqa-1m-int8.json"])
def test_the_papers_configurations_are_published_and_uncut(name):
    # the check holds these two to the paper's 1M rows of BGE-large's 1024
    # components, nothing cut
    conf = manifest.load_json(os.path.join(ROOT, "portbench", "configs",
                                           name))
    assert conf["published"] == {"engine.dim": 1024, "corpus.rows": 1000000}
    assert conf["reduced"] == []


def test_a_configs_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(set(sources)) == len(sources)
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE = ("oracle.py", "corpus.py", "costs.py", "ledger.py", "verdict.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    seen = 0
    for path in _sources():
        top = set(_imports(path))
        assert not top & FORBIDDEN, (path, top & FORBIDDEN)
        seen += 1
    assert seen >= 10


def test_the_reference_imports_nothing_of_the_program():
    for f in REFERENCE:
        top = set(_imports(os.path.join(ROOT, "portbench", "lib", f)))
        assert "repro_torch" not in top and not top & FORBIDDEN, (f, top)


def test_the_top_level_name_is_compared_whole():
    # the port's name begins with the JAX package's; a prefix test would
    # refuse it, a whole-name test does not
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN
