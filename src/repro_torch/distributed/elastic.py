"""Elastic restarts: the device grid for a device count, and a restore onto
the device a run restarts on.

Port of ``src/repro/distributed/elastic.py``.  Checkpoints hold full
arrays, so a run restarts on whatever is live.  `best_grid` is a copy.
The reference's `remesh` builds a ``jax.sharding.Mesh`` over the live
devices and has no counterpart on one card; its `reshard_restore` restores
into that mesh's shardings, and here restores onto one device.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.device import DeviceLike, resolve_device


def best_grid(n_devices: int, model_pref: int = 16) -> Tuple[int, int]:
    """(data, model) grid with data*model = n; model_pref wins when it
    divides, else the largest power-of-two model axis that does."""
    cands = [model_pref] + [m for m in (16, 8, 4, 2, 1) if m != model_pref]
    for m in cands:
        if m <= n_devices and n_devices % m == 0:
            return (n_devices // m, m)
    return (n_devices, 1)


def reshard_restore(ckpt, tree_like: Any, device: DeviceLike = None,
                    step: Optional[int] = None) -> Any:
    """Restore a checkpoint (any `Checkpointer` layout, the reference's
    too) as tensors on `device`, the card unless named."""
    return ckpt.restore(tree_like, step=step, device=resolve_device(device))
