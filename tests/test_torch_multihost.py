"""Training over a mesh that spans two processes (`repro_torch.launch.
multihost`, `launch.mesh.process_mesh`) against the one-process mesh, on
the CPU over gloo.

Two processes of `tests/torch_multihost_worker.py` join by file init:
first through ``python -m repro_torch.launch.train --multihost`` (from
``COORDINATOR`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), then in a group of
their own, where each trains reduced granite-3-2b and olmoe-1b-7b (expert
parallel) 3 steps on (1, 2) ('model' across the processes) and (2, 1)
('data' across them), each process holding one shard; both end with
``destroy_process_group``.  Held `torch.equal` to the one-process mesh
of the same seed here: every step's loss and grad norm, step 1's gradient
pieces and the pieces after the steps, each process's shard.  A read of
the other process's shard raises, and so does a checkpoint of the mesh.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import mesh as lmesh
from repro_torch.launch import multihost
from repro_torch.launch import train as launch_train
from repro_torch.models import sharding, specs
from torch_multihost_worker import CASES, CLI, WORLD, run_case

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two processes' results, and the one-process mesh's."""
    root = tmp_path_factory.mktemp("multihost")
    init, out = root / "init", root / "out"
    init.mkdir()
    out.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR", "NUM_PROCESSES", "PROCESS_ID")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         str(r), str(init), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {}
        for arch, shape in CASES:
            one[arch, shape] = run_case(arch, shape, lmesh.model_mesh(
                shape, ("data", "model"), "cpu"))
        cli = launch_train.main(CLI)
    finally:
        torch.set_num_threads(threads)
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = []
    for r in range(WORLD):
        with open(out / f"result-{r}.json") as f:
            res.append(json.load(f))
    return {"one": one, "cli": cli, "res": res, "out": out}


def test_init_is_false_without_the_variables(monkeypatch):
    for k in ("COORDINATOR", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        multihost.init(coordinator="localhost:1")   # the count missing


def test_host_info_has_the_reference_keys(runs):
    keys = {"process_index", "process_count", "local_devices",
            "global_devices"}
    assert set(multihost.host_info()) == keys
    assert multihost.host_info()["process_count"] == 1
    for r, res in enumerate(runs["res"]):
        assert res["host_info"] == {"process_index": r, "process_count": 2,
                                    "local_devices": 1, "global_devices": 2}


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
def test_two_processes_equal_one(runs, arch, shape):
    want = runs["one"][arch, shape]
    seen = set()
    for r in range(WORLD):
        got = torch.load(runs["out"] / f"{arch}-{shape[0]}x{shape[1]}-{r}.pt")
        assert got["loss"] == want["loss"]
        assert got["grad_norm"] == want["grad_norm"]
        for what in ("grads", "params"):
            assert got[what]
            for k, t in got[what].items():
                assert torch.equal(t, want[what][k]), (what, k)
        seen |= set(got["params"])
    assert seen == set(want["params"])    # every shard, once


def test_the_launcher_trains_over_the_processes(runs):
    cli = runs["cli"]
    for r, res in enumerate(runs["res"]):
        assert res["cli_steps"] == cli.step_num == 2
        assert res["cli_group_closed"]
        got = torch.load(runs["out"] / f"cli-{r}.pt")
        assert got and all(specs.split_name(k)[1] == r for k in got)
        named = cli.params.named_pieces()
        for k, t in got.items():
            assert torch.equal(t, named[k]), k


def test_a_read_of_another_process_shard_raises(runs):
    for res in runs["res"]:
        assert res["read_other"]["copied out"].startswith(
            "NotImplementedError")
        assert res["read_other"]["used with a local piece"].startswith(
            "RuntimeError")


def test_a_checkpoint_over_processes_is_refused(runs):
    for res in runs["res"]:
        assert "no distributed checkpoint" in res["checkpoint"]


def test_a_process_mesh_needs_the_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="multihost.init"):
        lmesh.process_mesh((1, 2), ("data", "model"), "cpu")
    mesh = lmesh.model_mesh((1, 2), ("data", "model"), "cpu")
    assert mesh.owners is None and not sharding.spans_processes(mesh)
    assert sharding.home(mesh) == mesh.devices[0]


def test_no_cpu_unless_named(monkeypatch, tmp_path):
    """Without a card the multi-process paths raise unless the caller
    names the CPU: no silent switch of device or backend."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.default_backend("cpu") == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.default_backend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init(f"file://{tmp_path}/a", 1, 0)
    assert not torch.distributed.is_initialized()
    assert multihost.init(f"file://{tmp_path}/b", 1, 0, device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lmesh.process_mesh((1, 2), ("data", "model"))
        mesh = lmesh.process_mesh((1, 2), ("data", "model"), "cpu")
        assert mesh.devices == (torch.device("cpu"),) * 2
    finally:
        torch.distributed.destroy_process_group()


def test_multihost_needs_a_mesh():
    """``--multihost`` without ``--mesh`` / ``--production-mesh`` would
    train a full copy in every process: refused before joining."""
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "granite-3-2b", "--multihost",
                           "--device", "cpu"])
    assert not torch.distributed.is_initialized()
