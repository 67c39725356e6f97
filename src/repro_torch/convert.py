"""Carry an IVF state across between the JAX package and the port.

A state of the reference, brought to the host (``jax.device_get``), is a
NamedTuple of numpy arrays with the same field names, shapes and dtypes as
the port's `IVFState`; these two functions move it bit for bit.  The parity
tests run both packages on one index this way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import IVFState
from repro_torch.device import DeviceLike, resolve_device


def ivf_state_from_numpy(state, device: DeviceLike = None) -> IVFState:
    """The port's IVFState on `device` from any NamedTuple of host arrays
    with IVFState's fields (unset ``q_*`` fields stay None)."""
    dev = resolve_device(device)
    fields = {}
    for name in IVFState._fields:
        value = getattr(state, name, None)
        fields[name] = None if value is None else torch.from_numpy(
            np.array(value, copy=True)).to(dev)
    return IVFState(**fields)


def ivf_state_to_numpy(state: IVFState) -> IVFState:
    """An IVFState of host numpy arrays (the reference's host layout)."""
    return IVFState(**{
        name: None if value is None else value.detach().cpu().numpy()
        for name, value in state._asdict().items()})
