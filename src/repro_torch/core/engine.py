"""AgenticMemoryEngine — the single-tenant shim (paper §4.1); port of
``src/repro/core/engine.py``.

The public API is the multi-tenant service:

    from repro_torch.api import MemoryService

    svc = MemoryService()
    svc.create_collection("notes", cfg)
    svc.build("notes", vectors)
    ids, scores = svc.query("notes", queries, k=5)

This module keeps the original single-index facade as a thin wrapper over
a one-collection `MemoryService`, with the reference's semantics: the
synchronous methods run on the calling thread against the collection
(they never consume a user-supplied scheduler's capacity), while `submit()`
routes through the workload templates and the windowed scheduler.  Its
entry points (`build/insert/delete/query/rebuild/submit/stats/save/load`)
keep the reference's signatures and on-disk layout (a checkpoint of the
state plus ``engine.json``), so an engine saved by either package loads in
the other.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import EngineConfig
from repro_torch.core import index as ivf
from repro_torch.core import templates
from repro_torch.core.scheduler import Task, WindowedScheduler
from repro_torch.device import DeviceLike

_COLLECTION = "default"


class AgenticMemoryEngine:
    """Single-tenant facade; new code uses `repro_torch.api.MemoryService`."""

    def __init__(self, cfg: EngineConfig, *, seed: int = 0,
                 scheduler: Optional[WindowedScheduler] = None,
                 spill_capacity: int = 4096,
                 thresholds: Optional[templates.TemplateThresholds] = None,
                 device: DeviceLike = None):
        from repro_torch.api import MemoryService
        self.cfg = cfg
        self.scheduler = scheduler        # user-owned; None = service-owned
        self._service = MemoryService(scheduler=scheduler, device=device)
        self._coll = self._service.create_collection(
            _COLLECTION, cfg, seed=seed, spill_capacity=spill_capacity,
            thresholds=thresholds)

    # ------------------------------------------------------------------
    # State passthroughs
    # ------------------------------------------------------------------
    @property
    def state(self) -> ivf.IVFState:
        return self._coll.snapshot()

    @state.setter
    def state(self, value: ivf.IVFState) -> None:
        self._coll._swap(value)

    @property
    def counters(self) -> dict:
        return self._coll.counters

    @property
    def thresholds(self) -> templates.TemplateThresholds:
        return self._coll.thresholds

    @property
    def _next_id(self) -> int:
        return self._coll._next_id

    @_next_id.setter
    def _next_id(self, value: int) -> None:
        self._coll._next_id = value

    @property
    def _built(self) -> bool:
        return self._coll._built

    @_built.setter
    def _built(self, value: bool) -> None:
        self._coll._built = value

    # ------------------------------------------------------------------
    # Sync facade: runs on the calling thread, never on a user scheduler
    # ------------------------------------------------------------------
    def build(self, vectors, ids=None) -> dict:
        """Bulk build (paper 'index template')."""
        return self._coll.build(vectors, ids=ids)

    def insert(self, vectors, ids=None) -> int:
        """Insert rows (paper 'update template'). Returns #spilled."""
        return self._coll.insert(vectors, ids=ids)

    def delete(self, ids) -> None:
        return self._coll.delete(ids)

    def query(self, queries, k: Optional[int] = None,
              nprobe: Optional[int] = None,
              path: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids i32[B, k], scores f32[B, k])."""
        return self._coll.query(queries, k=k, nprobe=nprobe, path=path)

    def rebuild(self) -> dict:
        """Reclaim tombstones + drain spill (paper 'index template')."""
        return self._coll.rebuild()

    # ------------------------------------------------------------------
    # Scheduler-mediated async API (paper 'query-update hybrid template')
    # ------------------------------------------------------------------
    def submit(self, kind: str, payload=None, **kw) -> Task:
        """Returns the scheduler Task (contract: `.done.wait()`)."""
        from repro_torch.api import MemoryOp
        if self.scheduler is None:
            raise RuntimeError("engine created without scheduler")
        op = MemoryOp(kind, _COLLECTION, payload,
                      ids=kw.pop("ids", None), k=kw.pop("k", None),
                      nprobe=kw.pop("nprobe", None),
                      path=kw.pop("path", None),
                      concurrent=kw.pop("concurrent", False))
        if kw:
            raise TypeError(f"unknown submit kwargs {sorted(kw)}")
        return self._service.submit(op).task

    def stats(self) -> dict:
        return self._coll.stats()

    # ------------------------------------------------------------------
    # Persistence — the single-directory layout of the reference's engine
    # ------------------------------------------------------------------
    def save(self, directory: str, step: int = 0) -> None:
        """Durable snapshot: index state + id counter (atomic commit)."""
        from repro_torch.api.collection import atomic_write_json
        from repro_torch.checkpoint.checkpointer import Checkpointer
        ck = Checkpointer(directory)
        with self._coll._lock:
            state = self._coll.snapshot()
            meta = {"next_id": self._coll._next_id,
                    "counters": dict(self._coll.counters)}
        ck.save(step, state._asdict())
        atomic_write_json(os.path.join(directory, "engine.json"), meta)

    @classmethod
    def load(cls, directory: str, cfg: EngineConfig, *,
             step: Optional[int] = None, **kw) -> "AgenticMemoryEngine":
        from repro_torch.checkpoint.checkpointer import Checkpointer
        eng = cls(cfg, **kw)
        restored = Checkpointer(directory).restore(
            eng.state._asdict(), step=step, device=eng._coll.device)
        eng.state = ivf.IVFState(**restored)
        eng._built = True
        mpath = os.path.join(directory, "engine.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                meta = json.load(f)
            eng._next_id = int(meta.get("next_id", 0))
            eng.counters.update(meta.get("counters", {}))
        return eng
