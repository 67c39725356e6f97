"""Template-driven execution (paper §4.3, Fig. 5); copy of
``src/repro/core/templates.py``.

The paper routes four recurring workload scenarios — query, update, index
rebuild, query-update hybrid — to the compute units profiling says fit best.
Here the degrees of freedom are (a) which *execution path* an op takes
(probe-path vs full-scan GEMM; kernel vs plain version) and (b) its
*scheduler class* (latency-critical vs background, window size).

`route()` is the dispatch for every `MemoryOp` the `repro_torch.api.
MemoryService` submits: each collection carries its own
`TemplateThresholds`, and the returned `ExecPlan` decides the execution
path, the scheduler backend class, and the priority of the op.  The
full-scan crossover keeps the reference's default (an occupancy ratio of 8);
it is still to be re-fit on the H100.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import EngineConfig


@dataclass(frozen=True)
class ExecPlan:
    template: str            # query | update | index | hybrid
    path: str                # probed | full_scan | insert | rebuild
    backend: str             # latency | throughput | background
    priority: int            # 0 = latency-critical, larger = later
    window: int              # scheduler submission window for this class
    scan_dtype: str = "float32"   # coarse-scan operand stream: float32 | int8


@dataclass
class TemplateThresholds:
    """Crossover points, profiling-guided (Fig. 4 heatmap analogue).

    full_scan_batch: batch size at which the union of probed lists would
    cover >~ the whole database, so one dense scan beats per-query probing.
    Cost model: probe ~ B*(C + nprobe*L)*D vs full ~ B*(C*L)*D but with far
    better matrix-unit occupancy; the default assumes occupancy ratio ~8x,
    i.e. switch when B*nprobe >= C/8 (the reference's value, still to be
    re-fit on the H100).

    maintenance_*: workload-triggered rebuild thresholds consumed by the
    service's `MaintenanceController` (paper: index maintenance interleaves
    with live traffic instead of waiting for an explicit caller).  A rebuild
    is scheduled once tombstones exceed `maintenance_tombstone_frac` of the
    index capacity or spill writes exceed `maintenance_spill_frac` of the
    spill buffer — but never below `maintenance_min_pending` pending rows,
    so a handful of deletes can't trigger a full re-cluster.

    The maintenance thresholds are *per shard*: on a mesh-sharded
    collection every shard owns `cfg.capacity` list slots and its own spill
    buffer, and the controller schedules shard-local rebuilds independently
    (one hot shard must not stall its siblings), so each shard's pressure
    is compared against the same limits an unsharded (1-shard) collection
    uses.  `maintenance_shard_min_pending` optionally lowers the pending-
    rows floor for shard-local decisions — a shard holds 1/S of the
    traffic, so its pressure accrues S× slower than the aggregate.
    """
    full_scan_batch: int = 32
    background_rebuild_chunk: int = 65536
    maintenance_tombstone_frac: float = 0.1
    maintenance_spill_frac: float = 0.5
    maintenance_min_pending: int = 64
    maintenance_shard_min_pending: Optional[int] = None
    # Size-based index policy (EngineConfig.index_policy == "auto"): a
    # collection at or below `flat_max_rows` live rows answers queries with
    # the exact full-scan GEMM (probing a tiny index costs more than
    # scanning it), one at or above `hnsw_min_rows` serves from the derived
    # HNSW graph, and everything between runs the IVF probe path.
    flat_max_rows: int = 2048
    hnsw_min_rows: int = 100_000
    # Recall probe cadence (EngineConfig.target_recall > 0): one sampled
    # exact-oracle recall measurement per `probe_interval_ops` ops, over
    # `probe_sample` live rows drawn from the current snapshot.
    probe_interval_ops: int = 512
    probe_sample: int = 64

    @classmethod
    def from_profile(cls, cfg: EngineConfig,
                     occupancy_ratio: float = 8.0) -> "TemplateThresholds":
        b = max(1, int(cfg.n_clusters / (occupancy_ratio * max(cfg.nprobe, 1))))
        return cls(full_scan_batch=b)

    def maintenance_limits(self, capacity: int, spill_capacity: int,
                           per_shard: bool = True) -> Tuple[int, int]:
        """(tombstone_limit, spill_limit) trigger points for one shard.

        `capacity` / `spill_capacity` are the SHARD-LOCAL slot counts (for
        an unsharded collection, the whole index).  `per_shard=True` applies
        `maintenance_shard_min_pending` when set; both limits are floored by
        the pending-rows minimum so trickle deletes never schedule a
        rebuild."""
        pending = self.maintenance_min_pending
        if per_shard and self.maintenance_shard_min_pending is not None:
            pending = self.maintenance_shard_min_pending
        return (max(pending, int(self.maintenance_tombstone_frac * capacity)),
                max(pending, int(self.maintenance_spill_frac * spill_capacity)))


DEFAULT_THRESHOLDS = TemplateThresholds()


def route(kind: str, batch: int, cfg: EngineConfig,
          thresholds: Optional[TemplateThresholds] = None,
          concurrent_queries: bool = False,
          fused_lanes: int = 1) -> ExecPlan:
    """Map (workload kind, batch) -> execution plan.

    kind: "build" | "query" | "insert" | "delete" | "rebuild" |
          "promote" | "demote" | "probe"

    fused_lanes: number of distinct collection lanes a cross-collection
    batched dispatch stacks (1 = a plain single-collection op).  A fused
    dispatch — sharded or not — is one padded GEMM over G·Bmax rows: even
    when each lane's batch sits below the full-scan crossover, the stacked
    dispatch is throughput-shaped, so it routes to the throughput class and
    the full submission window rather than stealing a latency worker for
    what is structurally bulk work.  (The execution *path* of a fused group
    is fixed by its batch signature, not by this plan — the plan decides
    scheduling only.)
    """
    t = thresholds or TemplateThresholds.from_profile(cfg)
    # the per-collection dtype policy rides on every plan: a quantized
    # collection's scans stream int8 codes (coarse scan + f32 rescore), and
    # the batching layer only fuses lanes whose plans agree on this
    sd = cfg.store_dtype
    if kind == "query":
        full = batch >= t.full_scan_batch
        if fused_lanes > 1:
            return ExecPlan("query", "full_scan" if full else "probed",
                            "throughput", 0, cfg.window, sd)
        if full:
            return ExecPlan("query", "full_scan", "throughput", 0, cfg.window,
                            sd)
        return ExecPlan("query", "probed", "latency", 0,
                        max(cfg.window // 2, 1), sd)
    if kind == "insert":
        # paper update template: lightweight, frequent; never preempts queries
        backend = "background" if concurrent_queries else "throughput"
        return ExecPlan("update", "insert", backend, 1, cfg.window, sd)
    if kind == "delete":
        return ExecPlan("update", "delete", "background", 1, cfg.window, sd)
    if kind == "build":
        # bulk build: one-shot index construction, GEMM-heavy like rebuild
        # but callers usually block on it -> throughput class, not background
        return ExecPlan("index", "build", "throughput", 1, 1, sd)
    if kind == "rebuild":
        # paper index template: large, latency-insensitive, all units
        return ExecPlan("index", "rebuild", "background", 2, 1, sd)
    if kind == "promote":
        # residency template: device (re)admission ahead of queries — bulk
        # host->device transfer, throughput-shaped but query-blocking, so
        # it must never sit behind background index work
        return ExecPlan("residency", "promote", "throughput", 0,
                        cfg.window, sd)
    if kind == "demote":
        # eviction/idle demotion: device->host/disk drain, pure background
        return ExecPlan("residency", "demote", "background", 2, 1, sd)
    if kind == "probe":
        # recall probe: sampled exact-oracle rescan + tuner step — read-only
        # measurement work that must never preempt serving traffic
        return ExecPlan("probe", "probe", "background", 2, 1, sd)
    raise ValueError(f"unknown workload kind {kind!r}")
