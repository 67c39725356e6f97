"""Device-residency manager — the tiered-storage subsystem; port of
``src/repro/api/residency.py`` (the same budget, LRU eviction, counters and
`stats()` keys) for unsharded collections on one device.

On the card the tiers are: HOT = CUDA tensors; WARM = host tensors, filled
by one D2H copy per leaf on the demoting thread's current stream into
page-locked memory, published only after that stream is synchronised;
COLD = a checkpoint namespace in the reference's layout (each package
reads the other's).  On the CPU, WARM is a separate copy of every leaf.
See `Collection.demote` / `Collection.promote`.

AME's premise is a tight on-device memory budget serving a corpus that does
not fit in it: with millions of tenants, most collections are cold at any
instant, so they cannot all be device-resident.  `ResidencyManager`
generalizes the fusion layer's version-tagged `StackCache` into the
service-wide device tier: it owns a byte budget, tracks every collection's
residency tier, and evicts least-recently-used tenants when an admission
would overflow the budget.

Residency state machine (per collection; see `Collection.demote/promote`):

    HOT   — IVFState lives on device; queries/writes run directly.
    WARM  — state snapshotted to host RAM (host tensors); no device
            memory held.
    COLD  — state exists only as a disk checkpoint (the same per-collection
            Checkpointer namespace persistence uses); neither device nor
            host RAM held.

    HOT --demote("warm")--> WARM --demote("cold")--> COLD
    WARM/COLD --promote()--> HOT        (never WARM<-COLD: that is a load)

Transitions serialize through the collection's writer lock, so a demotion
can never tear an in-flight write, and an in-flight delta-replay rebuild is
aborted by the demotion's epoch bump exactly like a bulk build would abort
it.  Queries stay wait-free on HOT collections; a query against a non-HOT
collection promotes first (the service chains promote→query inside one
scheduler task and surfaces the cold-hit latency here, separately from hot
query latency).

Locking protocol (deadlock-free by ordering):

    _admit_lock  >  collection writer locks  >  _lock (stats/registry)

`make_room_for` holds `_admit_lock` while demoting victims (taking their
writer locks); everything that *enters* the device tier (promote, build)
reserves its bytes under `_admit_lock` BEFORE taking its own writer lock,
and nothing ever calls into the manager's admission path while holding a
writer lock.  `_lock` is a leaf lock guarding counters and the registry —
never held across a call into a collection's locked methods that block.

Capacity accounting is by *logical index bytes* (`ivf.state_nbytes` — exact
for the static per-collection shapes, equal to the audited
`footprint(state)["index_bytes"]`), plus the StackCache's stacked fused
states, which live on device and are charged against (and evicted from) the
same budget first — a cached stack is strictly more disposable than a live
tenant.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core import locking

TIERS = ("hot", "warm", "cold")


class ResidencyManager:
    """Byte-budgeted device tier with LRU eviction over named collections.

    Parameters
    ----------
    device_budget_bytes:
        Device-tier capacity.  None = unbounded (tiers and stats still
        tracked; nothing is ever evicted for space).
    spill_dir:
        Directory for COLD checkpoints (one `<spill_dir>/<name>` namespace
        per collection).  None disables the cold tier — demote-to-cold
        raises, idle cold-demotion never triggers.
    idle_demote_s / cold_after_s:
        Background demotion policy, consumed by the service's
        MaintenanceController: a HOT collection idle longer than
        `idle_demote_s` is due for WARM; a WARM one idle longer than
        `cold_after_s` is due for COLD.  None (default) disables that rung.
    cache:
        The service's `StackCache`; its device bytes count against the
        budget and its entries are evicted before any live tenant is.

    Thread-safety: all public methods are safe from any thread.  `_lock`
    guards the registry + counters only; `_admit_lock` serializes
    admissions/evictions so two concurrent promotions cannot both conclude
    the budget has room for them.
    """

    def __init__(self, *, device_budget_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 idle_demote_s: Optional[float] = None,
                 cold_after_s: Optional[float] = None,
                 cache=None):
        self.device_budget_bytes = device_budget_bytes
        self.spill_dir = spill_dir
        self.idle_demote_s = idle_demote_s
        self.cold_after_s = cold_after_s
        self._cache = cache
        self._admit_lock = locking.make_lock("_admit_lock")
        self._lock = locking.make_lock("_lock")
        self._collections: Dict[str, object] = {}
        # bytes reserved by in-flight admissions (promote/build between the
        # make-room decision and the collection actually turning HOT)
        self._reserved: Dict[str, int] = {}
        self.promotions = 0
        self.demotions = 0
        self.evictions = 0          # demotions forced by budget pressure
        self.cache_evictions = 0    # StackCache entries dropped for space
        self.cold_hits = 0          # queries that found their tenant non-HOT
        self.over_budget_events = 0
        self._promote_s_total = 0.0
        self._promote_s_max = 0.0
        self._demote_s_total = 0.0

    # ------------------------------------------------------------------
    # Registry
    # ------------------------------------------------------------------
    def register(self, coll) -> None:
        """Track `coll` and, if it is HOT, charge it against the budget
        (evicting LRU tenants if needed — a freshly created collection
        allocates its device state immediately)."""
        coll._residency_mgr = self
        with self._lock:
            self._collections[coll.name] = coll
        if coll.residency == "hot":
            try:
                self.make_room_for(coll)
            finally:
                self.finish_admit(coll)

    def forget(self, coll) -> None:
        with self._lock:
            if self._collections.get(coll.name) is coll:
                del self._collections[coll.name]
        if coll._residency_mgr is self:
            coll._residency_mgr = None

    def _colls(self) -> List[object]:
        with self._lock:
            return list(self._collections.values())

    # ------------------------------------------------------------------
    # Byte accounting
    # ------------------------------------------------------------------
    def _tier_bytes(self) -> Dict[str, int]:
        out = {"hot": 0, "warm": 0, "cold": 0}
        for c in self._colls():
            tier = c.residency
            if tier in out:
                out[tier] += c.index_nbytes()
        return out

    def device_bytes(self) -> int:
        """Bytes the device tier holds right now: HOT collection states
        plus the StackCache's stacked fused copies."""
        n = self._tier_bytes()["hot"]
        if self._cache is not None:
            n += self._cache.device_bytes()
        return n

    def _device_bytes_excluding(self, coll) -> int:
        n = 0
        for c in self._colls():
            if c is not coll and c.residency == "hot":
                n += c.index_nbytes()
        if self._cache is not None:
            n += self._cache.device_bytes()
        return n

    def _reserved_bytes(self) -> int:
        with self._lock:
            return sum(self._reserved.values())

    # ------------------------------------------------------------------
    # Admission / eviction (the budget enforcement path)
    # ------------------------------------------------------------------
    def make_room_for(self, coll) -> None:
        """Reserve `coll`'s bytes in the device tier, evicting LRU tenants
        until it fits.  Caller must pair with `finish_admit(coll)` once the
        collection is HOT (or the admission failed).

        Called with NO collection locks held (promote/build take their
        writer lock only after this returns).  Holds `_admit_lock` across
        victim demotions so concurrent admissions serialize; victims demote
        to WARM only — pushing them to disk is the background controller's
        slower, idle-driven decision, not the admission fast path's.
        """
        if self.device_budget_bytes is None:
            return
        need = coll.index_nbytes()
        with self._admit_lock:
            with self._lock:
                self._reserved[coll.name] = need

            def over() -> bool:
                return (self._device_bytes_excluding(coll)
                        + self._reserved_bytes()
                        > self.device_budget_bytes)

            try:
                # cached fused stacks are pure derived copies — drop them
                # before demoting any live tenant
                while over() and self._cache is not None \
                        and self._cache.pop_lru():
                    with self._lock:
                        self.cache_evictions += 1
                if not over():
                    return
                victims = sorted(
                    (c for c in self._colls()
                     if c is not coll and c.residency == "hot"),
                    key=lambda c: c.last_used())
                for v in victims:
                    if not over():
                        break
                    r = v.demote("warm")
                    if r.get("demoted"):
                        with self._lock:
                            self.evictions += 1
                if over():
                    # budget smaller than this one collection (or every
                    # other tenant is mid-admission): admit anyway, note it
                    with self._lock:
                        self.over_budget_events += 1
            except BaseException:
                with self._lock:
                    self._reserved.pop(coll.name, None)
                raise

    def finish_admit(self, coll) -> None:
        """Release the admission reservation (the collection is now HOT and
        counted by `device_bytes`, or the admission was abandoned)."""
        with self._lock:
            self._reserved.pop(coll.name, None)

    # ------------------------------------------------------------------
    # Transitions
    # ------------------------------------------------------------------
    def ensure_hot(self, coll) -> float:
        """Promote `coll` if it is not HOT; returns the promote latency in
        seconds (0.0 on a hot hit).  This is the query path's cold-hit
        seam: the service calls it inside the same scheduler task that
        runs the query, so a cold query is one promote→query chain."""
        if coll.residency == "hot":
            return 0.0
        r = coll.promote()
        with self._lock:
            self.cold_hits += 1
        return float(r.get("promote_s", 0.0))

    def demote(self, coll, tier: str = "warm") -> dict:
        """Demote one collection (service `demote` ops land here).  Resolves
        the COLD checkpoint namespace from `spill_dir`."""
        directory = None
        if tier == "cold":
            if self.spill_dir is None:
                raise ValueError(
                    f"cannot demote {coll.name!r} to cold: no spill_dir "
                    "configured (MemoryService(residency_dir=...))")
            directory = os.path.join(self.spill_dir, coll.name)
        return coll.demote(tier, directory=directory)

    # records from Collection.promote/demote (any caller, not just ours)
    def _record_promotion(self, seconds: float) -> None:
        with self._lock:
            self.promotions += 1
            self._promote_s_total += seconds
            self._promote_s_max = max(self._promote_s_max, seconds)

    def _record_demotion(self, tier: str, seconds: float) -> None:
        with self._lock:
            self.demotions += 1
            self._demote_s_total += seconds

    # ------------------------------------------------------------------
    # Background demotion policy (polled by the MaintenanceController)
    # ------------------------------------------------------------------
    def demotion_due(self) -> List[Tuple[str, str]]:
        """(collection, target_tier) pairs a background sweep should demote.

        Three rungs: HOT idle past `idle_demote_s` → warm; WARM idle past
        `cold_after_s` → cold (needs `spill_dir`); and — independent of
        idleness — LRU HOT tenants while the device tier sits over budget
        (the budget can be overshot by StackCache growth or an over-large
        single tenant admitted with `over_budget_events`).
        """
        now = time.monotonic()
        out: List[Tuple[str, str]] = []
        hot = [(c.last_used(), c) for c in self._colls()
               if c.residency == "hot"]
        hot.sort(key=lambda t: t[0])
        if self.idle_demote_s is not None:
            out.extend((c.name, "warm") for t, c in hot
                       if now - t > self.idle_demote_s)
        if self.cold_after_s is not None and self.spill_dir is not None:
            out.extend((c.name, "cold") for c in self._colls()
                       if c.residency == "warm"
                       and now - c.last_used() > self.cold_after_s)
        if self.device_budget_bytes is not None:
            over = (self.device_bytes() + self._reserved_bytes()
                    - self.device_budget_bytes)
            named = {n for n, _ in out}
            for _, c in hot:
                if over <= 0:
                    break
                if c.name not in named:
                    out.append((c.name, "warm"))
                    over -= c.index_nbytes()
        return out

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Device/host/disk byte breakdown + transition counters.

        `device_bytes + host_bytes + disk_bytes` equals the sum of every
        collection's audited `footprint(...)["index_bytes"]` (each counted
        once, in its current tier) plus the StackCache's stacked copies —
        the service-level capacity invariant the tests assert.
        """
        tiers = self._tier_bytes()
        cache_bytes = (self._cache.device_bytes()
                       if self._cache is not None else 0)
        with self._lock:
            colls = list(self._collections.values())
            promotions = self.promotions
            stats = {
                "device_budget_bytes": self.device_budget_bytes,
                "device_bytes": tiers["hot"] + cache_bytes,
                "host_bytes": tiers["warm"],
                "disk_bytes": tiers["cold"],
                "stack_cache_bytes": cache_bytes,
                "reserved_bytes": sum(self._reserved.values()),
                "promotions": promotions,
                "demotions": self.demotions,
                "evictions": self.evictions,
                "cache_evictions": self.cache_evictions,
                "cold_hits": self.cold_hits,
                "over_budget_events": self.over_budget_events,
                # cold-hit latency, surfaced separately from hot queries
                "promote_s_mean": (self._promote_s_total / promotions
                                   if promotions else None),
                "promote_s_max": (self._promote_s_max
                                  if promotions else None),
                "demote_s_total": self._demote_s_total,
            }
        # each collection's `residency` property takes that collection's
        # leaf lock — never nest those under the manager's own leaf lock
        # (two same-level locks in a fixed cross-object order is a cycle
        # waiting for the opposite nesting to appear)
        stats["tiers"] = {c.name: c.residency for c in colls}
        return stats
