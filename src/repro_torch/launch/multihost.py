"""Multi-process initialization for launches over several processes; port
of ``src/repro/launch/multihost.py``.

Every process runs the same program; `init()` joins them in one
``torch.distributed`` process group, and a mesh over them
(`repro_torch.launch.mesh.process_mesh`) gives each process its run of
the shards.  The collectives of `repro_torch.models.sharding` move the
data between them.

    # process 0                      # process i
    COORDINATOR=host0:8476 \\
    NUM_PROCESSES=2 PROCESS_ID=0    ... PROCESS_ID=i \\
      python -m repro_torch.launch.train --arch granite-3-2b --multihost \\
          --mesh 2x4

The backend is NCCL where each process has a card of its own, gloo on the
CPU, or the one the caller names (``backend="gloo"``: two processes on one
card, which NCCL refuses); it never falls back from one to the other, and
a process takes the CPU only when its caller names it: without a card and
without ``device="cpu"`` the default backend and `local_device` raise.
Under torchrun its ``env://`` variables (``MASTER_ADDR``, ``WORLD_SIZE``,
``RANK``) take the place of the reference's TPU VM auto-discovery.  Without
any of these variables `init` returns False: the single-process paths are
the default everywhere.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.device import resolve_device


def init(coordinator: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         backend: Optional[str] = None, device=None) -> bool:
    """``torch.distributed.init_process_group`` from the arguments or
    ``COORDINATOR`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` (a coordinator
    ``host:port``, or any init method URL: ``file://...``) on `backend`
    (default: `default_backend` of the `device` the caller names); False
    if single-process."""
    dist = torch.distributed
    coordinator = coordinator or os.environ.get("COORDINATOR")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env(
        "PROCESS_ID")
    if coordinator is None and num_processes is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE",
                                             "RANK")):
            return False
        dist.init_process_group(backend or default_backend(device),
                                init_method="env://")
        return True
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process launch names COORDINATOR, "
                         "NUM_PROCESSES and PROCESS_ID")
    method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or default_backend(device),
                            init_method=method, world_size=num_processes,
                            rank=process_id)
    return True


def default_backend(device=None) -> str:
    """gloo where the caller names the CPU (`device`), else NCCL; without
    a card and without the CPU named it raises (`resolve_device`)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    resolve_device(None)
    return "nccl"


def local_device() -> torch.device:
    """This process's card: on NCCL its own (``LOCAL_RANK``, else the rank
    modulo the node's cards), on gloo the current one.  It never picks the
    CPU: without a card it raises (`resolve_device`); a caller that wants
    the CPU names it."""
    dist = torch.distributed
    resolve_device(None)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        local = _int_env("LOCAL_RANK")
        if local is None:
            local = dist.get_rank() % torch.cuda.device_count()
        return torch.device("cuda", local)
    return torch.device("cuda", torch.cuda.current_device())


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def host_info() -> dict:
    """The reference's four keys: this process's index, the process count,
    its devices and every process's."""
    dist = torch.distributed
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if not (dist.is_available() and dist.is_initialized()):
        return {"process_index": 0, "process_count": 1,
                "local_devices": local, "global_devices": local}
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": local, "global_devices": sum(counts)}
