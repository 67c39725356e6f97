"""Carry an IVF state across between the JAX package and the port.

A state of the reference, brought to the host (``jax.device_get``), is a
NamedTuple of numpy arrays with the same field names, shapes and dtypes as
the port's `IVFState`; these two functions move it bit for bit.  The parity
tests run both packages on one index this way.

A sharded state of the reference is one such NamedTuple in its global
layout (lists ``[C, L*S, D]``, per-shard scalars stacked); the port holds
it as a tuple of S shard-local states on a `ShardMesh`.  The sharded pair
moves between the two, bit for bit, through
`repro_torch.core.distributed.split_host` / `assemble_host`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import ShardMesh, assemble_host, \
    share_centroids, split_host
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


def sharded_state_from_numpy(state, mesh: ShardMesh) -> tuple:
    """The port's sharded state on `mesh` (shard i on ``mesh.devices[i]``,
    one centroids tensor per device) from a reference state in the global
    sharded layout, as host arrays."""
    return share_centroids([
        ivf_state_from_numpy(local, dev)
        for local, dev in zip(split_host(state, mesh.size), mesh.devices)])


def sharded_state_to_numpy(state) -> IVFState:
    """A port sharded state as one IVFState of numpy arrays in the
    reference's global layout."""
    return assemble_host(state)
