"""A configuration, a traffic mix and a cell added as files and entries
alone are found by name and run; a configuration that cuts its source's
scale is taken where it lists the cut, and refused where it hides one or
cuts a width; the command refuses a machine without a card, and a checkout
without the port, with no result."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench.lib import harness, manifest, tiny, verdict  # noqa: E402


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark's data with one new configuration, one new
    traffic mix and one new cell, added as files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    # the held f32-recall's metric entries are the added cell's template
    bench = tiny.with_held(manifest.benchmark(ROOT), ROOT)
    conf = json.loads((root / "portbench/configs/hotpotqa-1m-f32.json")
                      .read_text())
    conf["engine"]["nprobe"] = 32
    conf["source"] = "a deployment added as a file"
    (root / "portbench/configs/added-f32.json").write_text(json.dumps(conf))
    mix = json.loads((root / "portbench/traffic/recall.json").read_text())
    mix["batch_sizes"] = [1, 16]
    (root / "portbench/traffic/added-mix.json").write_text(json.dumps(mix))
    (root / "portbench/limits/added-cell.json").write_text(
        (root / "portbench/limits/f32-recall.json").read_text())
    bench["configs"].append({"name": "added-f32",
                             "source": conf["source"],
                             "file": "portbench/configs/added-f32.json",
                             "reduced": [], "why": "added"})
    bench["workloads"].append({"name": "added-cell", "config": "added-f32",
                               "traffic": "added-mix", "chips": 1,
                               "why": "added"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "f32-recall" in m.get("workloads", []):
            m["workloads"].append("added-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def test_an_added_cell_is_found_by_name_and_runs(tree):
    cell = manifest.cell("added-cell", root=tree)
    assert cell.config["engine"]["nprobe"] == 32
    assert cell.traffic["batch_sizes"] == [1, 16]
    assert {m["name"] for m in cell.end_to_end} == {"queries_per_s",
                                                    "setup_s"}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = harness.run(tiny.shrink(cell), 5, 1.0, True,
                        t_process=time.perf_counter(), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["checks"]
    assert {"window_mfu_pct.recall", "query_p95_ms"} <= set(r["metrics"])
    assert "query_roofline" not in r["metrics"]      # no device, no trace
    assert r["device"]["busy_s"] == 0.0


def test_a_cell_that_is_not_there_is_refused(tree):
    with pytest.raises(KeyError):
        manifest.cell("no-such-cell", root=tree)


def _widths_check():
    """`_limits_and_widths` of the manifest's tests, the check that every
    cell of BENCHMARK.json is held to."""
    spec = importlib.util.spec_from_file_location(
        "portbench_test_manifest",
        os.path.join(ROOT, "portbench", "tests", "test_portbench_manifest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._limits_and_widths


def _cut_tree(tmp_path, published_dim=256, reduced=("corpus.rows",)):
    """A copy of the benchmark's data with a 256-d configuration whose
    `published` says 256 components and BEIR's full 5,233,329-passage
    HotpotQA corpus, cut to 1M rows (listed in `reduced`, in the file and in
    its entry alike), and a cell that runs it: files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = manifest.benchmark(ROOT)
    conf = json.loads((root / "portbench/configs/hotpotqa-1m-f32.json")
                      .read_text())
    conf["engine"]["dim"] = 256
    conf["source"] = "a 256-d memory cut from its published rows"
    conf["published"] = {"engine.dim": published_dim, "corpus.rows": 5233329}
    conf["reduced"] = list(reduced)
    (root / "portbench/configs/cut-256.json").write_text(json.dumps(conf))
    (root / "portbench/limits/cut-recall.json").write_text(
        (root / "portbench/limits/f32-recall.json").read_text())
    bench["configs"].append({"name": "cut-256", "source": conf["source"],
                             "file": "portbench/configs/cut-256.json",
                             "reduced": list(reduced), "why": "a cut"})
    bench["workloads"].append({"name": "cut-recall", "config": "cut-256",
                               "traffic": "recall", "chips": 1,
                               "why": "a cut"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root), bench


def test_a_configuration_with_a_listed_cut_of_rows_is_taken(tmp_path):
    root, bench = _cut_tree(tmp_path)
    c = manifest.cell("cut-recall", root=root)
    assert c.config["engine"]["dim"] == 256
    assert c.config["corpus"]["rows"] == 1_000_000
    assert tiny.cell("cut-recall", root).config_name == "cut-256"
    _widths_check()(c, bench)


@pytest.mark.parametrize("published_dim, reduced, why", [
    (1024, ["corpus.rows"], "engine.dim = 256 differs"),
    (256, [], "corpus.rows = 1000000 differs"),
    (256, ["corpus.rows", "engine.dim"], "engine.dim is not a scale"),
], ids=["dim-not-published", "unlisted-cut", "width-in-reduced"])
def test_a_configuration_that_hides_a_cut_is_refused(tmp_path, published_dim,
                                                     reduced, why):
    root, bench = _cut_tree(tmp_path, published_dim, reduced)
    c = manifest.cell("cut-recall", root=root)
    with pytest.raises(ValueError, match=why):
        _widths_check()(c, bench)


def test_a_cut_listed_in_the_file_alone_is_refused(tmp_path):
    root, bench = _cut_tree(tmp_path)
    c = manifest.cell("cut-recall", root=root)
    with pytest.raises(ValueError, match="is not its entry's"):
        manifest.check_cuts(c.config, {"reduced": []})


def _run(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "f32-hybrid",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_without_a_card_or_the_port_there_is_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    bare = tmp_path / "bare"
    shutil.copytree(os.path.join(ROOT, "portbench"), bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    for cwd in (ROOT, str(bare)):
        p = _run(cwd)
        assert p.returncode != 0 and p.stdout.strip() == "", p.stderr


def test_jax_and_the_jax_package_are_told_apart_from_the_port():
    assert verdict.forbidden_modules(
        ["repro_torch", "repro_torch.api", "numpy"]) == []
    assert verdict.forbidden_modules(
        ["repro.core.index", "jaxlib.xla_client", "flax"]) == [
            "flax", "jaxlib", "repro"]
