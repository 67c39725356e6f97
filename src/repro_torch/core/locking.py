"""Lock construction + debug-mode lock-order validation (tsan-lite); copy of
``src/repro/core/locking.py`` with the same lock names and levels.

Every lock participating in the documented cross-component hierarchy is
created through `make_lock` / `make_rlock` with its *hierarchy name*.  The
documented order (see docs/ARCHITECTURE.md, "Invariants & analysis") is,
outermost first:

    _rebuild_locks  (40)  per-shard rebuild serialization; taken with no
                          other hierarchy lock held
    _repl_lock      (35)  ReplicaSet pump/failover serialization — held
                          while applying shipped deltas to replicas, which
                          takes their admission + writer locks below
    _admit_lock     (30)  ResidencyManager admission/eviction serialization
    _writer_lock    (20)  per-collection writer serialization
    _ship_lock      (15)  per-collection shipping-log append/tail — written
                          from inside the primary's writer critical section
    _lock           (10)  leaf locks: snapshot-pointer/counter/registry
                          sections (Collection, ResidencyManager,
                          MaintenanceController, MemoryService, StackCache)

A thread may acquire a lock only if every hierarchy lock it already holds
has a *higher* level — i.e. lock acquisition order always descends.  Equal
levels across distinct instances are allowed (e.g. the admission path takes
one victim collection's writer lock at a time); cycles among them are what
the runtime graph check catches.

In production the factories return plain `threading.Lock`/`RLock` — zero
overhead.  With ``AME_DEBUG_LOCKS=1`` in the environment they return
instrumented wrappers that maintain a per-thread held stack and a global
cross-thread acquired-while-holding graph, recording a violation when

* a thread acquires a lock whose level is >= a held lock's level on a
  *different* instance of a lower level (hierarchy inversion), or
* the acquired-while-holding graph gains a cycle (two threads taking the
  same pair of same-level locks in opposite orders), or
* a non-reentrant `Lock` is re-acquired by its holder (self-deadlock).

Violations are *recorded*, not raised: raising from inside a writer's
critical section would corrupt the state under test and turn one finding
into a cascade.  The port's service tests drain this module's `validator`
after every test (an autouse fixture in ``tests/test_torch_service.py``) and
fail the test that produced them.  The static mirror of this hierarchy lives
in ``tools/analyze/invariants.py``.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Dict, List, Set, Tuple

# hierarchy name -> level; acquisition order must strictly descend
LEVELS: Dict[str, int] = {
    "_rebuild_locks": 40,
    "_repl_lock": 35,
    "_admit_lock": 30,
    "_writer_lock": 20,
    "_ship_lock": 15,
    "_lock": 10,
}

_SEQ = itertools.count()


def debug_enabled() -> bool:
    """True when AME_DEBUG_LOCKS asks for instrumented locks (tests/CI)."""
    return os.environ.get("AME_DEBUG_LOCKS", "") not in ("", "0")


class LockOrderValidator:
    """Global acquisition-order recorder shared by all instrumented locks.

    Tracks, per thread, the stack of held instrumented locks, and globally
    the set of (held, acquired) instance edges.  `violations` accumulates
    human-readable descriptions; `drain()` returns-and-clears them (the
    test fixture's contract), `reset()` additionally clears the graph so
    one test's lock population can't alias another's.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held_key, acquired_key) instance edges, cumulative across threads
        self._edges: Set[Tuple[str, str]] = set()
        self.violations: List[str] = []

    # -- per-thread held stack -----------------------------------------
    def _held(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- recording ------------------------------------------------------
    def _record(self, msg: str) -> None:
        with self._mu:
            self.violations.append(msg)

    def before_acquire(self, lock: "_InstrumentedLockBase") -> None:
        held = self._held()
        if any(h is lock for h in held):
            if not lock.reentrant:
                self._record(
                    f"re-acquire of non-reentrant lock {lock.key} by its "
                    "holding thread (self-deadlock)")
            return                      # RLock re-entry: no new ordering
        for h in held:
            if h.level < lock.level:
                self._record(
                    f"hierarchy inversion: acquiring {lock.key} "
                    f"(level {lock.level}) while holding {h.key} "
                    f"(level {h.level}); order must descend "
                    f"{' > '.join(sorted(LEVELS, key=LEVELS.get, reverse=True))}")
        if held:
            edge = (held[-1].key, lock.key)
            cycle: List[str] = []
            with self._mu:
                if edge not in self._edges:
                    self._edges.add(edge)
                    cycle = self._find_path(lock.key, held[-1].key)
            if cycle:  # record outside _mu: _record re-takes it
                self._record("acquisition-order cycle: "
                             + " -> ".join(cycle + [cycle[0]]))

    def _find_path(self, src: str, dst: str) -> List[str]:
        """DFS path src -> dst in the edge graph (caller holds _mu)."""
        adj: Dict[str, List[str]] = {}
        for a, b in self._edges:
            adj.setdefault(a, []).append(b)
        stack, seen = [(src, [src])], set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in adj.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return []

    def after_acquire(self, lock: "_InstrumentedLockBase") -> None:
        self._held().append(lock)

    def on_release(self, lock: "_InstrumentedLockBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    # -- test-fixture surface -------------------------------------------
    def drain(self) -> List[str]:
        with self._mu:
            out, self.violations = self.violations, []
        return out

    def reset(self) -> None:
        with self._mu:
            self.violations = []
            self._edges = set()


validator = LockOrderValidator()


class _InstrumentedLockBase:
    """Wrapper recording hierarchy/order events around a real lock."""

    reentrant = False

    def __init__(self, real, name: str, vdtor: LockOrderValidator) -> None:
        if name not in LEVELS:
            raise ValueError(f"unknown hierarchy lock name {name!r}; "
                             f"known: {sorted(LEVELS)}")
        self._real = real
        self.name = name
        self.level = LEVELS[name]
        self.key = f"{name}#{next(_SEQ)}"
        self._validator = vdtor

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._validator.before_acquire(self)
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._validator.after_acquire(self)
        return ok

    def release(self) -> None:
        self._real.release()
        self._validator.on_release(self)

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _InstrumentedLock(_InstrumentedLockBase):
    reentrant = False


class _InstrumentedRLock(_InstrumentedLockBase):
    reentrant = True


def make_lock(name: str, *, _validator: LockOrderValidator = None):
    """A `threading.Lock` under hierarchy name `name` (instrumented when
    AME_DEBUG_LOCKS is set)."""
    if debug_enabled() or _validator is not None:
        return _InstrumentedLock(threading.Lock(), name,
                                 _validator or validator)
    return threading.Lock()


def make_rlock(name: str, *, _validator: LockOrderValidator = None):
    """A `threading.RLock` under hierarchy name `name` (instrumented when
    AME_DEBUG_LOCKS is set)."""
    if debug_enabled() or _validator is not None:
        return _InstrumentedRLock(threading.RLock(), name,
                                  _validator or validator)
    return threading.RLock()
