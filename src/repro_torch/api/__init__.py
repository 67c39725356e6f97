"""Multi-tenant agentic-memory API of the port (see ``repro.api``).

    from repro_torch.api import MemoryService, MemoryOp

    svc = MemoryService()                        # collections on the card
    svc.create_collection("notes", cfg)
    svc.build("notes", vectors)                  # sync = .submit().result()
    fut = svc.submit(MemoryOp("query", "notes", queries, k=5))
    ids, scores = fut.result()
"""
from repro_torch.api.collection import Collection
from repro_torch.api.ops import MemoryOp, OpFuture
from repro_torch.api.replication import ReplicaSet
from repro_torch.api.residency import ResidencyManager
from repro_torch.api.service import MaintenanceController, MemoryService
from repro_torch.core.scheduler import AdmissionControl, Overloaded

__all__ = ["AdmissionControl", "Collection", "MaintenanceController",
           "MemoryOp", "MemoryService", "OpFuture", "Overloaded",
           "ReplicaSet", "ResidencyManager"]
