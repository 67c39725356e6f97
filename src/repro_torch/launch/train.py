"""Training entry point of the port: ``python -m repro_torch.launch.train
--arch granite-3-2b [--full] [--production-mesh [--multi-pod]] [--device
cpu]``.

The counterpart of ``src/repro/launch/train.py``, with its flags and
defaults: a reduced config (``--reduced``, the default) or the full one
(``--full``), a synthetic corpus unless ``--data-dir`` names uint32 token
shards, and the fault-tolerant `Trainer` (checkpoint/restart, preemption,
straggler monitor) always on.  It trains on the CUDA card unless
``--device`` names another.  ``--production-mesh`` trains over the
reference's 16 x 16 (data, model) mesh (``--multi-pod``: 2 x 16 x 16),
one card a shard: it is refused on a node with fewer than 256 (512)
cards, and with ``--device`` every shard goes on that device; ``--mesh
DxM`` names a (data, model) mesh of another shape.

``--multihost`` joins the processes that ``COORDINATOR`` /
``NUM_PROCESSES`` / ``PROCESS_ID`` (or torchrun's variables) name
(`repro_torch.launch.multihost`), and the mesh spans them: each process
holds its run of the shards on its own device and the collectives move
data between the processes.  ``--backend`` names the process group's
backend: NCCL (the default: one card a process) or gloo (the default with
``--device cpu``, or several processes on one card).  ``--multihost``
needs a mesh (``--mesh`` or ``--production-mesh``), and the CPU is taken
only when ``--device cpu`` names it.  Every process draws the same
params and batches from ``--seed``.  A checkpoint of a mesh over processes
is refused, as in the reference.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import Prefetcher, TokenDataset
from repro_torch.launch import multihost
from repro_torch.launch.mesh import (describe, make_production_mesh,
                                     model_mesh, process_mesh)
from repro_torch.models import api
from repro_torch.train.trainer import Trainer


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "bf16", "int8"))
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the full config")
    ap.add_argument("--production-mesh", action="store_true",
                    help="train over the 16 x 16 (data, model) mesh: 256 "
                    "cards, or every shard on --device")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh, the 2 x 16 x 16 (pod, "
                    "data, model) mesh: 512 cards")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-dir", default=None,
                    help="directory of uint32 .bin token shards "
                         "(synthetic corpus when omitted)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default=None,
                    help="a (data, model) mesh DxM (e.g. 2x4), one card a "
                    "shard or every shard on --device")
    ap.add_argument("--multihost", action="store_true",
                    help="torch.distributed from COORDINATOR/NUM_PROCESSES/"
                    "PROCESS_ID (or torchrun's env://): the mesh spans the "
                    "processes")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="with --multihost: the process group's backend "
                    "(default gloo with --device cpu, else nccl)")
    args = ap.parse_args(argv)
    if args.multihost and not (args.mesh or args.production_mesh):
        ap.error("--multihost spans a mesh: name --mesh DxM or "
                 "--production-mesh")

    joined = args.multihost and multihost.init(backend=args.backend,
                                               device=args.device)
    if joined:
        print(f"multihost: {multihost.host_info()}", flush=True)
    try:
        return _train(args)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args) -> Trainer:

    cfg = (registry.reduced_arch(args.arch) if args.reduced
           else registry.get_arch(args.arch))
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     grad_accum=args.grad_accum,
                     grad_compression=args.grad_compression, seed=args.seed)

    shape = None
    if args.production_mesh:
        shape = (2, 16, 16) if args.multi_pod else (16, 16)
    elif args.mesh:
        shape = tuple(int(n) for n in args.mesh.split("x"))
    axes = ("pod", "data", "model") if len(shape or ()) == 3 else \
        ("data", "model")
    if shape is None:
        mesh = None
    elif torch.distributed.is_initialized():
        mesh = process_mesh(shape, axes, args.device)
    elif args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    devices=args.device)
    else:
        mesh = model_mesh(shape, axes, args.device)

    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"(active {cfg.active_param_count():,}) reduced={args.reduced}")
    trainer = Trainer(cfg, tc, mesh=mesh, checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      install_signals=True, device=args.device)
    if mesh is not None:
        print(f"training on the mesh {describe(mesh)}")
    if trainer.maybe_restore():
        print(f"restored from step {trainer.step_num}")

    ds = TokenDataset(args.data_dir, vocab_size=cfg.vocab_size,
                      seq_len=args.seq, batch_size=args.batch,
                      seed=args.seed,
                      synthetic_tokens=max(1 << 18,
                                           args.batch * args.seq * 8))
    batches = Prefetcher(api.adapt_batches(ds, cfg, seed=args.seed), depth=2)
    try:
        hist = trainer.train(batches, args.steps, log_every=args.log_every)
    finally:
        batches.close()
    final = hist[-1] if hist else {}
    print(f"done: step={trainer.step_num} loss={final.get('loss', 'n/a')}")
    if args.checkpoint_dir:
        trainer.save(async_=False)
        print(f"checkpointed to {args.checkpoint_dir}")
    return trainer


if __name__ == "__main__":
    main()
