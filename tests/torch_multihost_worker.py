"""One process of the two-process gloo runs that
`tests/test_torch_multihost.py` starts (not a test module):

    python tests/torch_multihost_worker.py RANK INIT_DIR OUT_DIR

It first runs the training launcher with ``--multihost`` from
``COORDINATOR`` / ``NUM_PROCESSES`` / ``PROCESS_ID``, then joins a process
group of its own (file init) and trains each (arch, mesh) of `CASES` over
a mesh that spans the two processes, and checks that a read of the other
process's shard and a checkpoint of the mesh raise.  It saves what its
shards computed under OUT_DIR for the test to compare with a one-process
mesh, and always ends with ``destroy_process_group``.
"""
import json
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import multihost
from repro_torch.launch import train as launch_train
from repro_torch.models import sharding, specs
from repro_torch.train.train_step import grads_of
from repro_torch.train.trainer import Trainer

WORLD = 2
CASES = (("granite-3-2b", (1, 2)), ("granite-3-2b", (2, 1)),
         ("olmoe-1b-7b", (1, 2)), ("olmoe-1b-7b", (2, 1)))
STEPS, BATCH, SEQ = 3, 4, 16
CLI = ["--arch", "granite-3-2b", "--mesh", "1x2", "--device", "cpu",
       "--steps", "2", "--batch", "4", "--seq", "16", "--log-every", "1"]


def tc() -> TrainConfig:
    return TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                       seed=0)


def batches(cfg, n=STEPS, seed=5):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
             .astype(np.int32) for k in ("tokens", "targets")}
            for _ in range(n)]


def run_case(arch: str, shape, mesh) -> dict:
    """Step 1's gradient, then STEPS steps: (losses, grad norms, step 1's
    gradient pieces, the pieces after the steps), this process's shards."""
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    tr = Trainer(cfg, tc(), mesh=mesh)
    data = batches(cfg)
    with sharding.use_mesh(mesh):
        _, _, g = grads_of(tr.params, cfg, tr.tc, tr._batch(data[0]))
    hist = tr.train(iter(data), STEPS, log_every=1)

    def mine(named):
        return {k: t.detach().clone() for k, t in named.items()
                if sharding.is_local(mesh, specs.split_name(k)[1])}
    return {"loss": [h["loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "grads": mine(g), "params": mine(tr.params.named_pieces()),
            "trainer": tr}


def main(rank: int, init_dir: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    res = {}
    os.environ.update(COORDINATOR=f"file://{init_dir}/cli",
                      NUM_PROCESSES=str(WORLD), PROCESS_ID=str(rank))
    tr = launch_train.main(CLI + ["--multihost", "--backend", "gloo"])
    res["cli_steps"] = tr.step_num
    res["cli_group_closed"] = not torch.distributed.is_initialized()
    # the group is closed: this process's shards by the mesh's owners
    torch.save({k: t.detach() for k, t in tr.params.named_pieces().items()
                if tr.mesh.owners[specs.split_name(k)[1]] == rank},
               os.path.join(out_dir, f"cli-{rank}.pt"))
    for k in ("COORDINATOR", "NUM_PROCESSES", "PROCESS_ID"):
        del os.environ[k]
    multihost.init(f"file://{init_dir}/cases", WORLD, rank, backend="gloo")
    try:
        res["host_info"] = multihost.host_info()
        for arch, shape in CASES:
            mesh = lmesh.process_mesh(shape, ("data", "model"), "cpu")
            got = run_case(arch, shape, mesh)
            tr = got.pop("trainer")
            torch.save(got, os.path.join(
                out_dir, f"{arch}-{shape[0]}x{shape[1]}-{rank}.pt"))
        other = next(i for i in range(mesh.size)
                     if not sharding.is_local(mesh, i))
        mine = next(i for i in range(mesh.size) if sharding.is_local(mesh, i))
        theirs = tr.params.shards[other]["embed.table"]
        res["read_other"] = {}
        for how, read in (
                ("copied out", lambda: theirs.cpu()),
                ("used with a local piece",
                 lambda: theirs + tr.params.shards[mine]["embed.table"])):
            try:
                read()
                res["read_other"][how] = "no error"
            except (NotImplementedError, RuntimeError) as e:
                res["read_other"][how] = f"{type(e).__name__}: {e}"
        try:
            Checkpointer(tempfile.mkdtemp(dir=out_dir)).save(0, tr._tree())
            res["checkpoint"] = "no error"
        except RuntimeError as e:
            res["checkpoint"] = str(e)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"result-{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
