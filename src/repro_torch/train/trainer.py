"""The training loop: the train step, async checkpoints, fault hooks.

Port of ``src/repro/train/trainer.py``.  The model's f32 master weights and
AdamW's moments stay on their devices and the step updates them in place
(the reference donates them to ``jit``).  With ``mesh=`` (a `ShardMesh`
of `repro_torch.launch.mesh`) the params are drawn exactly as without one,
from the same generator, then cut onto the mesh by the reference's
placements (`specs.place_params`: a `specs.ShardedLM`), and the moments
follow them; each step runs under `sharding.use_mesh`, its batch placed
over the data axes.

A checkpoint holds ``{"params": tree, "opt": OptState(step, mu tree, nu
tree)}`` in the reference's params tree (`specs.param_shardings`' layout:
block leaves stacked ``[L, ...]``), each leaf whole, so a checkpoint
restores across mesh shapes and to or from one device; `maybe_restore`
copies it back into the same tensors.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.distributed.fault import PreemptionGuard, StragglerMonitor
from repro_torch.models import lm, sharding, specs
from repro_torch.train import optimizer
from repro_torch.train.train_step import make_train_step, trainable


class _Whole:
    """The restore target of a leaf kept whole (the optimizer's step)."""

    @staticmethod
    def place(t: torch.Tensor) -> torch.Tensor:
        return t


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *,
                 mesh: Optional[ShardMesh] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 100, install_signals: bool = False,
                 device: DeviceLike = None):
        """`mesh`: train over it (every shard on its own device; `device`
        is then its first shard's); else on `device` (the card unless
        named)."""
        self.cfg, self.tc, self.mesh = cfg, tc, mesh
        self.device = (sharding.home(mesh) if mesh is not None
                       else resolve_device(device))
        self.ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        self.guard = PreemptionGuard(install=install_signals)
        self.monitor = StragglerMonitor()
        self.step_num = 0
        params = lm.init_params(
            torch.Generator(device=self.device).manual_seed(tc.seed), cfg,
            master=True)
        if mesh is not None:          # the master weights stay f32
            params = specs.place_params(params, cfg.replace(
                dtype="float32"), mesh)
        self.params = trainable(params)
        self.opt_state = optimizer.init(self.params)
        self._step = make_train_step(cfg, tc)
        self.gen = torch.Generator(device=self.device).manual_seed(
            tc.seed + 1)

    # ------------------------------------------------------------------
    def _tree(self) -> dict:
        """The state in the reference's tree layout: placed leaves (saved
        whole), or a model's per-layer tensors stacked when saved."""
        st = self.opt_state
        if self.mesh is not None:
            return {"params": self.params.tree(),
                    "opt": optimizer.OptState(st.step, st.mu.tree(),
                                              st.nu.tree())}
        return {"params": specs.stacked_tree(optimizer.named(self.params)),
                "opt": optimizer.OptState(st.step,
                                          specs.stacked_tree(st.mu),
                                          specs.stacked_tree(st.nu))}

    def maybe_restore(self) -> bool:
        if not (self.ckpt and self.ckpt.latest_step() is not None):
            return False
        like = self._tree()
        if self.mesh is not None:
            ps = specs.param_shardings(self.cfg, self.mesh)
            got = self.ckpt.restore(like, shardings={
                "params": ps, "opt": optimizer.OptState(_Whole(), ps, ps)})
            targets = (self.params, self.opt_state.mu, self.opt_state.nu)
            with torch.no_grad():
                for sp, tree in zip(targets, (got["params"], got["opt"][1],
                                              got["opt"][2])):
                    for key, placed in specs.flat_tree(tree).items():
                        for s, part in zip(sp.shards, placed.parts):
                            s[key].copy_(part)
        else:
            got = self.ckpt.restore(like)        # host arrays, leaf by leaf
            for named, tree in ((optimizer.named(self.params), got["params"]),
                                (self.opt_state.mu, got["opt"][1]),
                                (self.opt_state.nu, got["opt"][2])):
                specs.copy_tree_into(named, tree)
        self.opt_state = self.opt_state._replace(step=torch.as_tensor(
            np.asarray(got["opt"][0]), dtype=torch.int32))
        self.step_num = self.ckpt.latest_step()
        return True

    def save(self, async_: bool = True):
        if not self.ckpt:
            return
        if async_:
            self.ckpt.save_async(self.step_num, self._tree())
        else:
            self.ckpt.save(self.step_num, self._tree())

    def _batch(self, host: Dict[str, np.ndarray]) -> dict:
        """A pipeline batch as tensors on the device, or over a mesh placed
        over its data axes (`specs.batch_spec`, the reference's batch
        sharding)."""
        out = {k: as_tensor(np.asarray(v), _dtype(v), self.device)
               for k, v in host.items()}
        if self.mesh is None:
            return out
        sizes = sharding.axis_sizes(self.mesh)
        return {k: sharding.place(t, specs.batch_spec(sizes, t.shape),
                                  self.mesh) for k, t in out.items()}

    # ------------------------------------------------------------------
    def train(self, batches: Iterator[Dict[str, np.ndarray]],
              steps: int, log_every: int = 10) -> list:
        history = []
        with sharding.use_mesh(self.mesh):
            for it in range(steps):
                batch = self._batch(next(batches))
                self.monitor.start()
                self.params, self.opt_state, metrics = self._step(
                    self.params, self.opt_state, batch, self.gen)
                metrics = {k: float(v) for k, v in metrics.items()}
                timing = self.monitor.stop()
                metrics.update(timing)
                self.step_num += 1
                if (self.step_num % log_every == 0 or timing["straggler"]
                        or it == 0 or it == steps - 1):
                    history.append({"step": self.step_num, **metrics})
                if self.ckpt and (self.step_num % self.checkpoint_every == 0
                                  or self.guard.should_checkpoint):
                    self.save(async_=not self.guard.should_checkpoint)
                    if self.guard.should_checkpoint:
                        self.guard.reset()
                        break
        if self.ckpt:
            self.ckpt.wait()
        return history


def _dtype(v) -> torch.dtype:
    """A pipeline array's tensor dtype: integers as int32, floats as f32."""
    return (torch.int32 if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.float32)
