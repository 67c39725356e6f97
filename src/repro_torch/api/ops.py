"""Uniform operation requests + futures for the MemoryService; copy of
``src/repro/api/ops.py``.

`MemoryOp` is the one request type every tenant-facing call lowers to:
build/insert/delete/query/rebuild against a named collection.  The service
routes each op through `templates.route` (execution path, scheduler backend,
priority) and hands back an `OpFuture`.

`OpFuture` is deliberately tiny — an event + result/error pair — because it
must be settable from two producers: a scheduler worker running a single op,
or the cross-collection batch executor demultiplexing one fused dispatch
into many futures.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

OP_KINDS = ("build", "insert", "delete", "query", "rebuild",
            "promote", "demote", "probe")


@dataclass
class MemoryOp:
    """One memory operation against one named collection.

    payload: vectors for build/insert, queries for query, ids for delete,
             None for rebuild/promote/demote/probe (a probe is one sampled
             exact-oracle recall measurement + tuner step; see
             `Collection.recall_probe`).
    ids:     explicit external ids for build/insert (else auto-assigned).
    k / nprobe / path: query parameters (None = collection defaults; `path`
             overrides the template router, as in the benchmarks).
    concurrent: hint that queries are in flight (routes inserts to the
             background lane, the paper's query-update hybrid template).
    batch:   queries only — park the op in the service's pending window so
             it can fuse with same-signature queries from other collections.
    shard:   rebuild only — compact just this mesh shard of a sharded
             collection (shard-local maintenance); None rebuilds them all.
    tier:    demote only — target residency tier: "warm" (host RAM, the
             default) or "cold" (disk checkpoint).  Promote always targets
             the device tier ("hot"), so it takes no tier.
    """

    kind: str
    collection: str
    payload: Any = None
    ids: Any = None
    k: Optional[int] = None
    nprobe: Optional[int] = None
    path: Optional[str] = None
    concurrent: bool = False
    batch: bool = False
    shard: Optional[int] = None
    tier: Optional[str] = None

    def __post_init__(self):
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}; "
                             f"expected one of {OP_KINDS}")
        if self.batch and self.kind != "query":
            raise ValueError("batch=True is only meaningful for queries")
        if self.shard is not None and self.kind != "rebuild":
            raise ValueError("shard= is only meaningful for rebuild ops")
        if self.tier is not None:
            if self.kind != "demote":
                raise ValueError("tier= is only meaningful for demote ops")
            if self.tier not in ("warm", "cold"):
                raise ValueError(f"demote tier must be 'warm' or 'cold', "
                                 f"got {self.tier!r}")

    @property
    def batch_size(self) -> int:
        shape = getattr(self.payload, "shape", None)
        if shape:
            return int(shape[0]) if len(shape) > 1 else 1
        try:
            return len(self.payload)
        except TypeError:
            return 1


@dataclass
class OpFuture:
    """Result handle for a submitted MemoryOp.

    Thread-safety: safe to share across threads.  `done()` never blocks;
    `wait()` / `result()` / `exception()` block the *calling* thread until a
    scheduler worker (or the batch demultiplexer) settles the future —
    device compute itself always runs on the worker, never on the waiter.
    Waiting on a batch-parked query first flushes the service's pending
    window, so `result()` can never hang on an op nobody dispatched.
    `result()` re-raises the op's error in the caller's thread."""

    op: MemoryOp
    _event: threading.Event = field(default_factory=threading.Event)
    _result: Any = None
    _error: Optional[BaseException] = None
    task: Any = None          # backing scheduler Task, when 1:1 (not batched)
    # set on batch-parked ops: waiting on the future flushes the batch
    # window, so result() can never hang on an op nobody dispatched
    _on_wait: Any = None

    # -- producer side -------------------------------------------------
    def _set_result(self, value: Any) -> None:
        self._result = value
        self._event.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    # -- consumer side -------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not self._event.is_set() and self._on_wait is not None:
            cb, self._on_wait = self._on_wait, None
            cb()
        return self._event.wait(timeout)

    def exception(self, timeout: Optional[float] = None):
        if not self.wait(timeout):
            raise TimeoutError(f"op {self.op.kind!r} on "
                               f"{self.op.collection!r} still pending")
        return self._error

    def result(self, timeout: Optional[float] = None):
        err = self.exception(timeout)
        if err is not None:
            raise err
        return self._result
