"""The training loop: the train step, async checkpoints, fault hooks.

Port of ``src/repro/train/trainer.py``.  The model's f32 master weights and
AdamW's moments live on one device and the step updates them in place (the
reference donates them to ``jit``).  A checkpoint holds ``{"params":
{name: tensor}, "opt": OptState}`` in the port's own leaf names (the
reference stacks the blocks' leaves); `maybe_restore` copies it back into
the same tensors.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.distributed.fault import PreemptionGuard, StragglerMonitor
from repro_torch.models import lm
from repro_torch.train import optimizer
from repro_torch.train.train_step import make_train_step, trainable


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 100, install_signals: bool = False,
                 device: DeviceLike = None):
        self.cfg, self.tc = cfg, tc
        self.device = resolve_device(device)
        self.ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        self.guard = PreemptionGuard(install=install_signals)
        self.monitor = StragglerMonitor()
        self.step_num = 0
        self.params = trainable(lm.init_params(
            torch.Generator(device=self.device).manual_seed(tc.seed), cfg,
            master=True))
        self.opt_state = optimizer.init(self.params)
        self._step = make_train_step(cfg, tc)
        self.gen = torch.Generator(device=self.device).manual_seed(
            tc.seed + 1)

    # ------------------------------------------------------------------
    def _tree(self) -> dict:
        return {"params": {k: p.detach() for k, p in
                           self.params.named_parameters()},
                "opt": self.opt_state}

    def maybe_restore(self) -> bool:
        if self.ckpt and self.ckpt.latest_step() is not None:
            got = self.ckpt.restore(self._tree(), device=self.device)
            got["opt"] = optimizer.OptState(*got["opt"])
            with torch.no_grad():
                for k, p in self.params.named_parameters():
                    p.copy_(got["params"][k])
                for mine, theirs in ((self.opt_state.mu, got["opt"].mu),
                                     (self.opt_state.nu, got["opt"].nu)):
                    for k, t in mine.items():
                        t.copy_(theirs[k])
            self.opt_state = self.opt_state._replace(
                step=got["opt"].step.to("cpu", torch.int32))
            self.step_num = self.ckpt.latest_step()
            return True
        return False

    def save(self, async_: bool = True):
        if not self.ckpt:
            return
        if async_:
            self.ckpt.save_async(self.step_num, self._tree())
        else:
            self.ckpt.save(self.step_num, self._tree())

    # ------------------------------------------------------------------
    def train(self, batches: Iterator[Dict[str, np.ndarray]],
              steps: int, log_every: int = 10) -> list:
        history = []
        for it in range(steps):
            batch = {k: as_tensor(np.asarray(v), _dtype(v), self.device)
                     for k, v in next(batches).items()}
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
