"""Elastic scaling: rebuild the mesh from the live device set and reshard.

Port of ``src/repro/distributed/elastic.py``.  Checkpoints store full
(unsharded) arrays, so a run that loses a card can restart on any device
count whose factorization supports the parallelism plan: `remesh` picks
the largest (data, model) grid that fits the live devices, and
`reshard_restore` rebuilds the placements from the same logical rules and
cuts the restored model onto the new mesh.  The same path implements
scale-up.  `best_grid` is a copy of the reference's.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.device import DeviceLike, resolve_device


def best_grid(n_devices: int, model_pref: int = 16) -> Tuple[int, int]:
    """(data, model) grid with data*model = n; model_pref wins when it
    divides, else the largest power-of-two model axis that does."""
    cands = [model_pref] + [m for m in (16, 8, 4, 2, 1) if m != model_pref]
    for m in cands:
        if m <= n_devices and n_devices % m == 0:
            return (n_devices // m, m)
    return (n_devices, 1)


def remesh(devices: Optional[Sequence[Union[str, torch.device]]] = None,
           model_pref: int = 16) -> ShardMesh:
    """A ('data', 'model') mesh of `best_grid`'s shape over the live
    devices (default: every card of the node), one device a shard."""
    from repro_torch.launch.mesh import model_mesh
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("no live card to remesh onto; name the "
                               "devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    data, model = best_grid(len(devices), model_pref)
    return model_mesh((data, model), ("data", "model"),
                      list(devices)[: data * model])


def reshard_restore(ckpt, tree_like: Any,
                    mesh: Union[ShardMesh, DeviceLike] = None,
                    cfg: Optional[ModelConfig] = None,
                    step: Optional[int] = None, *,
                    device: DeviceLike = None) -> Any:
    """Restore a checkpoint into a new mesh topology (elastic restart).

    With a `ShardMesh` and the model's `cfg`: `tree_like` is a model's
    params in the reference's tree (`repro_torch.convert.lm_params_to_numpy`'s
    layout, which `specs.param_shardings` mirrors), and the model comes
    back placed on `mesh` (`specs.ShardedLM`).  Otherwise the tree comes
    back as tensors on a device (`mesh` or `device`; the card unless
    named), in any `Checkpointer` layout, the reference's too."""
    if isinstance(mesh, ShardMesh):
        from repro_torch.models import specs
        if cfg is None:
            raise ValueError("restoring onto a mesh needs the model's cfg")
        placed = ckpt.restore(tree_like, step=step,
                              shardings=specs.param_shardings(cfg, mesh))
        return specs.from_placed_tree(cfg, mesh, placed)
    return ckpt.restore(tree_like, step=step,
                        device=resolve_device(device if mesh is None
                                              else mesh))
