"""The port stands alone: no file of `repro_torch` (its `distributed/` and
`api/replication.py` included), nor `chip_smoke.py`,
`tools/profile_port.py` or `tools/ab_phases.py`, imports jax or anything
of the JAX package `repro`; importing the port leaves jax unloaded; its
EngineConfig, ModelConfig and HardwareConfig have exactly the reference's
fields, its arch configs equal the reference's, and its copies of
framework-free modules keep the reference's public names.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_port.py",
    ROOT / "tools" / "ab_phases.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"index.py", "collection.py", "service.py", "chip_smoke.py",
            "scan_scores.py", "scan_scores_q8.py", "checkpointer.py",
            "batch.py", "engine.py", "quickstart.py", "tuner.py",
            "hnsw.py", "replication.py", "fault.py", "archs.py",
            "registry.py", "accounting.py", "layers.py", "attention.py",
            "lm.py", "serve_step.py", "rag.py", "serve.py",
            "serve_agent.py", "optimizer.py", "train_step.py", "trainer.py",
            "pipeline.py", "collectives.py", "elastic.py", "train.py",
            "train_micro.py", "dryrun.py", "op_analysis.py", "roofline.py",
            "profile.py", "specs.py", "loops.py", "granite_3_2b.py",
            "seamless_m4t_large_v2.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/distributed/fault.py",
            "src/repro_torch/api/replication.py",
            "src/repro_torch/models/api.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/distributed/collectives.py",
            "src/repro_torch/distributed/elastic.py",
            "src/repro_torch/data/pipeline.py"} <= rel


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.convert, "
            "repro_torch.api.replication, repro_torch.distributed.fault, "
            "repro_torch.core.metrics, repro_torch.configs.ame_paper, "
            "repro_torch.kernels.scan_scores_q8, "
            "repro_torch.checkpoint.checkpointer, repro_torch.models.lm, "
            "repro_torch.models.api, repro_torch.serving.rag, "
            "repro_torch.serving.serve_step, repro_torch.launch.serve, "
            "repro_torch.serve_agent, repro_torch.configs.registry, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, "
            "repro_torch.train.trainer, repro_torch.data.pipeline, "
            "repro_torch.distributed.collectives, "
            "repro_torch.distributed.elastic, repro_torch.launch.train, "
            "repro_torch.train_micro, repro_torch.launch.dryrun, "
            "repro_torch.launch.op_analysis, repro_torch.launch.roofline, "
            "repro_torch.launch.profile, repro_torch.models.specs, "
            "repro_torch.configs.granite_3_2b, "
            "repro_torch.configs.zamba2_2_7b; "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro loaded'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_every_kernel_has_a_source_and_a_launch_counter():
    """Each kernel the build knows is a CUDA source in csrc/ with a wrapper
    module of the same name that counts its launches; importing a wrapper
    builds nothing."""
    import importlib
    from repro_torch.kernels import build
    assert set(build.KERNELS) == {"scan_scores", "scan_scores_q8",
                                  "kmeans_assign", "segsum_gemm"}
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file(), name
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        assert isinstance(mod.launches, build.LaunchCounter), name
    assert not build._libs


def test_engine_config_has_the_reference_fields():
    from repro.configs.base import EngineConfig as JConfig
    from repro_torch.configs import ame_paper
    from repro.configs import ame_paper as jame_paper
    from repro_torch.configs.base import EngineConfig

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(EngineConfig) == fields(JConfig)
    for name in ("PAPER_10K", "PAPER_100K", "PAPER_1M"):
        assert dataclasses.asdict(getattr(ame_paper, name)) == \
            dataclasses.asdict(getattr(jame_paper, name))
    assert ame_paper.ABLATION_LADDER == jame_paper.ABLATION_LADDER
    with pytest.raises(ValueError):
        EngineConfig(index_policy="bogus")


def test_model_config_has_the_reference_fields():
    """ModelConfig and ShapeConfig have the reference's fields and
    defaults, and the shapes are equal."""
    from repro.configs import base as jbase
    from repro_torch.configs import base

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(base.ModelConfig) == fields(jbase.ModelConfig)
    assert fields(base.ShapeConfig) == fields(jbase.ShapeConfig)
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


def test_train_config_has_the_reference_fields():
    """TrainConfig has the reference's fields and defaults, in order."""
    from repro.configs import base as jbase
    from repro_torch.configs import base

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(base.TrainConfig) == fields(jbase.TrainConfig)


def test_hardware_config_has_the_reference_fields():
    """HardwareConfig has the reference's fields in order; its defaults
    are one H100's (`H100`), none of the reference's TPU figures."""
    from repro.configs import base as jbase
    from repro_torch.configs import base

    names = [f.name for f in dataclasses.fields(base.HardwareConfig)]
    assert names == [f.name for f in dataclasses.fields(jbase.HardwareConfig)]
    assert base.H100 == base.HardwareConfig()
    mine, tpu = dataclasses.asdict(base.H100), dataclasses.asdict(jbase.V5E)
    assert all(mine[k] != tpu[k] for k in names), \
        [k for k in names if mine[k] == tpu[k]]


def test_data_pipeline_copy_keeps_the_reference_public_names():
    """`data/pipeline.py` is a copy: the same public classes, methods and
    signatures."""
    import inspect
    from repro.data import pipeline as ref
    from repro_torch.data import pipeline as mine
    for cls in ("TokenDataset", "Prefetcher"):
        a, b = getattr(mine, cls), getattr(ref, cls)
        assert {n: str(inspect.signature(getattr(a, n))) for n in dir(a)
                if not n.startswith("_")} == \
            {n: str(inspect.signature(getattr(b, n))) for n in dir(b)
             if not n.startswith("_")}
        assert str(inspect.signature(a.__init__)) == \
            str(inspect.signature(b.__init__))


def test_every_arch_builds_in_the_port():
    """All ten archs build (the enc-dec family too, which no longer
    raises) and give their caches, on the meta device."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    for name in registry.list_archs():
        cfg = registry.reduced_arch(name)
        lm.LM(cfg, device="meta")
        lm.init_caches(cfg, 1, 8, device="meta")


def test_all_archs_equal_the_reference():
    """ALL_ARCHS equals the reference's config by config, full and
    reduced, and the registry lists the same cells."""
    from repro.configs import archs as jarchs
    from repro.configs import registry as jregistry
    from repro_torch.configs import archs, registry
    assert {k: dataclasses.asdict(v) for k, v in archs.ALL_ARCHS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jarchs.ALL_ARCHS.items()}
    for name in registry.list_archs():
        assert dataclasses.asdict(registry.reduced_arch(name)) == \
            dataclasses.asdict(jregistry.reduced_arch(name)), name
    assert [c[2:] for c in registry.all_cells(include_skipped=True)] == \
        [c[2:] for c in jregistry.all_cells(include_skipped=True)]
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")


def test_lock_hierarchy_matches_reference():
    from repro.core import locking as jlocking
    from repro_torch.core import locking
    assert locking.LEVELS == jlocking.LEVELS


def test_templates_route_matches_reference():
    from repro.configs.ame_paper import PAPER_1M as J1M
    from repro.core import templates as jt
    from repro_torch.configs.ame_paper import PAPER_1M
    from repro_torch.core import templates as t
    assert t.TemplateThresholds.from_profile(PAPER_1M).full_scan_batch == \
        jt.TemplateThresholds.from_profile(J1M).full_scan_batch == 2
    for kind, batch in (("query", 1), ("query", 64), ("insert", 8),
                        ("delete", 3), ("build", 100), ("rebuild", 1)):
        assert dataclasses.asdict(t.route(kind, batch, PAPER_1M)) == \
            dataclasses.asdict(jt.route(kind, batch, J1M))


def test_routing_thresholds_match_reference():
    """The index-policy and recall-probe thresholds keep the reference's
    defaults, field for field."""
    from repro.core import templates as jt
    from repro_torch.core import templates as t

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(t.TemplateThresholds) == fields(jt.TemplateThresholds)
    for name in ("flat_max_rows", "hnsw_min_rows", "probe_interval_ops",
                 "probe_sample"):
        assert getattr(t.TemplateThresholds(), name) == \
            getattr(jt.TemplateThresholds(), name), name


@pytest.mark.parametrize("module,cls", [("tuner", "RecallTuner"),
                                        ("hnsw", "HNSW")])
def test_copied_classes_keep_the_reference_public_names(module, cls):
    """`core/tuner.py` and `core/hnsw.py` are copies: the same public
    classes with the same public methods and signatures."""
    import importlib
    import inspect
    mine = importlib.import_module(f"repro_torch.core.{module}")
    ref = importlib.import_module(f"repro.core.{module}")
    assert getattr(mine, "__all__", None) == getattr(ref, "__all__", None)
    a, b = getattr(mine, cls), getattr(ref, cls)

    def public(c):
        return {n: str(inspect.signature(getattr(c, n)))
                for n in dir(c) if not n.startswith("_")
                and callable(getattr(c, n))}

    assert public(a) == public(b)
    assert str(inspect.signature(a.__init__)) == \
        str(inspect.signature(b.__init__))


@pytest.mark.parametrize("cls", ["PreemptionGuard", "StragglerMonitor"])
def test_fault_copy_keeps_the_reference_public_names(cls):
    """`distributed/fault.py` is a copy: the same public classes with the
    same public methods, properties and signatures."""
    import inspect
    from repro.distributed import fault as ref
    from repro_torch.distributed import fault as mine
    a, b = getattr(mine, cls), getattr(ref, cls)

    def public(c):
        return {n: (str(inspect.signature(getattr(c, n)))
                    if callable(getattr(c, n)) else type(getattr(c, n)).__name__)
                for n in dir(c) if not n.startswith("_")}

    assert public(a) == public(b)
    assert str(inspect.signature(a.__init__)) == \
        str(inspect.signature(b.__init__))


def test_replication_is_no_longer_a_later_slice():
    """No port file raises `later_slice(...)` any more: replication and
    then the sharded tier, the last items behind it, are ported, and the
    helper itself is gone."""
    calls, defs = [], []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "later_slice":
                calls.append(path.name)
            if isinstance(node, ast.FunctionDef) and \
                    node.name == "later_slice":
                defs.append(path.name)
    assert not calls and not defs, (calls, defs)


def test_make_mesh_without_cuda_and_device_raises(monkeypatch):
    """`make_mesh` with no device named puts every shard on the card; on a
    machine without one it raises, as `resolve_device` does, and a named
    device still works."""
    import torch
    from repro_torch.core.distributed import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("shard",))
    assert make_mesh((2,), ("shard",), "cpu").devices == \
        (torch.device("cpu"),) * 2
