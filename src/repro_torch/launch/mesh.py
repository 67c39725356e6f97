"""Production mesh construction; port of ``src/repro/launch/mesh.py``.

Functions, not module-level constants, so importing this module touches no
device.  Each returns the port's `ShardMesh` (one process drives every
shard, or with `process_mesh` each process of a process group its run of
them; `repro_torch.models.sharding`).  With no devices named a mesh takes
one card a shard (``cuda:0`` .. ``cuda:n-1``) and raises when the node has
fewer: devices are never cycled silently.  A device named alone holds
every shard (``devices="cuda"``: eight shards on the one card), and a list
names one device a shard.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.configs.base import MeshConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.device import resolve_device

Devices = Union[None, str, torch.device, Sequence[Union[str, torch.device]]]


def mesh_devices(n: int, devices: Devices = None) -> Tuple[torch.device, ...]:
    """The n devices of an n-shard mesh (see the module's docstring)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of {n} shards takes {n} cards and this node has "
                f"{have}; name the devices (devices='cuda' puts every shard "
                "on one card)")
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, (str, torch.device)):
        return (resolve_device(devices),) * n
    devices = tuple(resolve_device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"a mesh of {n} shards, {len(devices)} devices")
    return devices


def model_mesh(shape: Sequence[int], axes: Sequence[str],
               devices: Devices = None) -> ShardMesh:
    """A `ShardMesh` of `shape` over `axes`: shard i on devices[i], in the
    reference's row-major order."""
    shape = tuple(int(s) for s in shape)
    return ShardMesh(shape, tuple(axes),
                     mesh_devices(math.prod(shape), devices))


def process_mesh(shape: Sequence[int], axes: Sequence[str],
                 device: Union[str, torch.device, None] = None
                 ) -> ShardMesh:
    """A `ShardMesh` of `shape` over `axes` whose shards span the processes
    of the default process group (`repro_torch.launch.multihost.init`):
    process p holds the p-th run of ``prod(shape) / world`` shards in
    row-major order, every one on its `device` (default: its card,
    `multihost.local_device`, which raises without one: the CPU is taken
    only when named); the other processes' shards are stand-ins on the
    ``meta`` device (`sharding.is_local`)."""
    from repro_torch.launch import multihost
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh over processes needs the process group "
                           "(repro_torch.launch.multihost.init)")
    shape = tuple(int(s) for s in shape)
    n, world, me = math.prod(shape), dist.get_world_size(), dist.get_rank()
    if n % world:
        raise ValueError(f"{n} shards do not divide over {world} processes")
    per = n // world
    dev = resolve_device(device) if device is not None else \
        multihost.local_device()
    owners = tuple(i // per for i in range(n))
    return ShardMesh(shape, tuple(axes), tuple(
        dev if o == me else torch.device("meta") for o in owners), owners)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Devices = None) -> ShardMesh:
    """16x16 ('data','model') single-pod, or 2x16x16 ('pod','data','model');
    256 or 512 cards unless `devices` are named."""
    mc = MeshConfig(multi_pod=multi_pod)
    return model_mesh(mc.shape, mc.axes, devices)


def make_mesh(mc: MeshConfig, devices: Devices = None) -> ShardMesh:
    return model_mesh(mc.shape, mc.axes, devices)


def describe(mesh) -> str:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return "x".join(f"{a}={n}" for a, n in sizes.items())
