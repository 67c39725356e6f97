"""Device selection shared by every entry point of the port.

Entry points run on the CUDA card unless the caller names another device
(the CPU tests pass ``device="cpu"``).  With no card and no device named,
they raise: nothing falls back to the CPU silently.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else cuda."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return torch.device("cuda")


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`x` (numpy, list or tensor) as a contiguous tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(x, dtype=dtype).to(device).contiguous()

