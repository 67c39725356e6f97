"""One run of one cell: set-up, the measured window, the check.

Set-up makes the corpus on the device from the seed, builds the memory
through `MemoryService`, and warms every shape of the cell's traffic by
running that traffic for a short while (and, where it writes, one
rebuild).  The window then runs the traffic mix's closed-loop sessions for
`seconds`: recall sessions that each send one query request and wait for
it, writer sessions that each insert a batch of fresh rows and then delete
the oldest live ids.  Once the window has closed and every session has
come back, the run reads its counters, frees the program, and judges a
sample of the window's answers against the plain reference (`oracle`).

The clients' own random draws (each session's batch sizes, which live
rows it perturbs, and the noise) are made before a phase starts, so that
a request in the window costs its session a gather and a renormalisation
and nothing more.  That work, and the writers' making of their rows, runs
inside a `CLIENT` profiler range, by which the traced run leaves it out of
the device's busy time (`devtrace`).

Every id's life is recorded by batch: the host times at which its insert
was sent and acknowledged, and its delete sent and acknowledged.  Inserts
take ids in order and deletes take the oldest, so the live ids are always
one range, which keeps the memory at its size while it learns and forgets.
"""
from __future__ import annotations

import gc
import math
import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from portbench.lib import corpus, costs, devtrace, manifest, verdict
from portbench.lib.ledger import Ledger
from portbench.lib.readers import COLLECTION, Counters

RESULT_TIMEOUT_S = 120.0
POOL = 16384             # query vectors drawn ahead for each session
CLIENT = devtrace.CLIENT


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@dataclass
class Request:
    b: int
    path: str
    t_sub: float
    t_done: float = math.inf
    ok: bool = False
    ids: Optional[np.ndarray] = None
    scores: Optional[np.ndarray] = None
    q: Optional[torch.Tensor] = None
    target: Optional[torch.Tensor] = None
    rebuilds_before: int = 0


@dataclass
class Write:
    kind: str
    rows: int
    t_sub: float
    t_done: float = math.inf
    ok: bool = False


@dataclass
class Draw:
    sizes: object                # iterator of batch sizes
    offsets: torch.Tensor        # i64[POOL]: distance below the newest id
    noise: torch.Tensor          # f32[POOL, D]


@dataclass
class Phase:
    t0: float = 0.0
    stop: float = 0.0
    threads: list = field(default_factory=list)
    per_q: list = field(default_factory=list)
    per_w: list = field(default_factory=list)
    requests: List[Request] = field(default_factory=list)
    writes: List[Write] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# the traffic's clients
# ---------------------------------------------------------------------------

def size_sequence(sizes: List[int], repeats: int, rng):
    """Batch sizes in blocks that hold each size `repeats` times, shuffled
    block by block: every seed gives the same mix, in its own order."""
    block = np.repeat(np.asarray(sizes, dtype=np.int64), repeats)
    while True:
        for b in rng.permutation(block):
            yield int(b)


class Clients:
    def __init__(self, svc, coll, traffic: dict, ring: torch.Tensor,
                 centers: torch.Tensor, ledger: Ledger, seed: int, paths):
        self.svc, self.coll, self.traffic = svc, coll, traffic
        self.ring, self.centers, self.ledger = ring, centers, ledger
        self.seed, self.paths = seed, paths
        self.k = int(traffic["k"])
        self.perturb = float(traffic["perturb"])
        self.n0, self.ins_rows = ledger.n0, ledger.ins_rows

    def draw(self, phase_tag: int, i: int) -> Draw:
        """Session i's draws for one phase, made before the phase starts:
        its batch sizes, and for `POOL` query vectors an offset below the
        newest live id and the noise.  A session that uses them all starts
        over."""
        t = self.traffic
        rng = np.random.default_rng(corpus.mix(self.seed, corpus.SESSION,
                                               phase_tag, i))
        g = corpus.generator(self.ring.device, self.seed, corpus.SESSION,
                             phase_tag, i)
        # the live range never holds fewer rows than this (a delete follows
        # its writer's own acknowledged insert)
        span = self.n0 - int(t["writer_sessions"]) * self.ins_rows
        return Draw(
            sizes=size_sequence(t["batch_sizes"], int(t["block_repeats"]),
                                rng),
            offsets=torch.randint(0, span, (POOL,), generator=g,
                                  device=self.ring.device),
            noise=corpus.noise(POOL, self.ring.shape[1], g, self.perturb))

    def query_loop(self, draw: Draw, phase: Phase, out: list,
                   gate: threading.Barrier) -> None:
        from repro_torch.api import MemoryOp
        n_ring = self.ring.shape[0]
        pos = 0
        gate.wait()
        while time.perf_counter() < phase.stop:
            b = next(draw.sizes)
            if pos + b > POOL:
                pos = 0
            with torch.profiler.record_function(CLIENT):
                _, hi = self.ledger.live_range()
                target = (hi - 1) - draw.offsets[pos:pos + b]
                q = corpus.perturb(self.ring[target % n_ring],
                                   draw.noise[pos:pos + b])
            pos += b
            req = Request(b=b, path=self.paths[b], t_sub=0.0, q=q,
                          target=target,
                          rebuilds_before=self.coll.counters["rebuilds"])
            req.t_sub = time.perf_counter()
            try:
                fut = self.svc.submit(MemoryOp("query", COLLECTION, q,
                                               k=self.k))
                req.ids, req.scores = fut.result(timeout=RESULT_TIMEOUT_S)
                req.ok = True
            except Exception as e:  # noqa: BLE001 - a failed request counts
                phase.errors.append(f"query: {e!r}")
            req.t_done = time.perf_counter()
            out.append(req)

    def writer_turn(self, out: list, errors: list) -> None:
        """Insert one batch of fresh rows, then delete the oldest ids."""
        from repro_torch.api import MemoryOp
        led = self.ledger
        n_ins, n_del = led.ins_rows, led.del_rows
        j, start = led.alloc_insert()
        with torch.profiler.record_function(CLIENT):
            rows = corpus.batch_rows(self.centers, self.seed, j, n_ins)
            slots = torch.arange(start, start + n_ins,
                                 device=rows.device) % self.ring.shape[0]
            self.ring.index_copy_(0, slots, rows)
        ids = np.arange(start, start + n_ins, dtype=np.int32)
        w = Write("insert", n_ins, time.perf_counter())
        led.ins_sent[j] = w.t_sub
        try:
            self.svc.submit(MemoryOp("insert", COLLECTION, rows, ids=ids,
                                     concurrent=True)
                            ).result(timeout=RESULT_TIMEOUT_S)
            w.ok = True
        except Exception as e:  # noqa: BLE001
            errors.append(f"insert: {e!r}")
        w.t_done = time.perf_counter()
        if w.ok:
            led.acked_insert(start, w.t_done)
        out.append(w)
        m, dstart = led.alloc_delete()
        d = Write("delete", n_del, time.perf_counter())
        led.del_sent[m] = d.t_sub
        try:
            self.svc.submit(MemoryOp(
                "delete", COLLECTION,
                np.arange(dstart, dstart + n_del, dtype=np.int32))
            ).result(timeout=RESULT_TIMEOUT_S)
            d.ok = True
        except Exception as e:  # noqa: BLE001
            errors.append(f"delete: {e!r}")
        d.t_done = time.perf_counter()
        led.del_acked[m] = d.t_done
        out.append(d)

    def writer_loop(self, phase: Phase, out: list,
                    gate: threading.Barrier) -> None:
        gate.wait()
        while time.perf_counter() < phase.stop:
            self.writer_turn(out, phase.errors)

    def run_phase(self, seconds: float, phase_tag: int,
                  on_start=None) -> Phase:
        """All sessions for `seconds`; `on_start()` runs just before they
        are let go, and the phase's clock starts after it."""
        t = self.traffic
        n_q, n_w = int(t["recall_sessions"]), int(t["writer_sessions"])
        gate = threading.Barrier(n_q + n_w + 1)
        phase = Phase()
        per_q = [[] for _ in range(n_q)]
        per_w = [[] for _ in range(n_w)]
        draws = [self.draw(phase_tag, i) for i in range(n_q)]
        _sync(self.ring.device)
        threads = [threading.Thread(
            target=self.query_loop, args=(draws[i], phase, per_q[i], gate),
            name=f"bench-recall-{i}", daemon=True) for i in range(n_q)]
        threads += [threading.Thread(
            target=self.writer_loop, args=(phase, per_w[i], gate),
            name=f"bench-writer-{i}", daemon=True) for i in range(n_w)]
        for th in threads:
            th.start()
        if on_start is not None:
            on_start()
        phase.t0 = time.perf_counter()
        phase.stop = phase.t0 + seconds
        gate.wait()
        phase.threads = threads
        phase.per_q, phase.per_w = per_q, per_w
        return phase

    @staticmethod
    def join(phase: Phase, grace: float) -> None:
        for th in phase.threads:
            th.join(timeout=max(1.0, phase.stop + grace - time.perf_counter()))
        if any(th.is_alive() for th in phase.threads):
            phase.errors.append("a session did not come back")
        phase.requests = [r for rs in phase.per_q for r in list(rs)]
        phase.writes = [w for ws in phase.per_w for w in list(ws)]


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def live_ids(coll) -> torch.Tensor:
    st = coll.snapshot()
    ids = torch.cat([st.list_ids.reshape(-1), st.spill_ids])
    return torch.sort(ids[ids >= 0]).values


def mismatch(got: torch.Tensor, lo: int, hi: int) -> int:
    """Ids of lo..hi-1 missing from `got`, plus ids in `got` outside it
    (a repeated id counts as one too many)."""
    want = torch.arange(lo, hi, device=got.device, dtype=got.dtype)
    if got.numel() == want.numel() and torch.equal(got, want):
        return 0
    extra = int(torch.isin(got, want, invert=True).sum())
    dups = int(got.numel() - torch.unique(got).numel())
    return int(torch.isin(want, got, invert=True).sum()) + extra + dups


def run(cell, seed: int, seconds: float, trace: bool, *,
        t_process: float, device: str = "cuda",
        control: Optional[str] = None, want_ctx: bool = False):
    """One run of `cell` (a `manifest.Cell`).  Returns the result: the
    metrics (end-to-end, or per-layer with `trace`), the checks, the device
    and, traced, the breakdown.  With `want_ctx`, returns (result, ctx),
    where `ctx` is what the metric readers read: the window's requests and
    writes, `MemoryService.counters()` differenced across the window
    (`counters`, a `readers.Counters`) and the scheduler's share of them
    per op kind (`delta(kind)`), and, traced, the device trace (`trace`)
    and its spans table (`spans`, `lib/spans.py`; None untraced).
    `control` puts the reference in the program's place at that lower
    precision for the check (the program still serves the window)."""
    from repro_torch.api import MemoryOp, MemoryService
    from repro_torch.configs.base import EngineConfig

    dev = torch.device(device)
    conf, traffic, limits = cell.config, cell.traffic, cell.limits
    engine = dict(conf["engine"])
    if engine["metric"] != "ip":
        raise ValueError("the reference scores inner products only")
    cfg = EngineConfig(**engine)
    spill = int(conf["spill_capacity"])
    n0 = int(conf["corpus"]["rows"])
    writers = int(traffic["writer_sessions"])
    if writers:
        ins_rows = int(traffic["insert_rows"])
        del_rows = int(traffic["delete_rows"])
        ring_n = n0 + (writers + 2) * ins_rows
    else:
        ins_rows = del_rows = 1      # no batch is ever written
        ring_n = n0
    topics = corpus.n_topics(n0, int(conf["corpus"]["rows_per_topic"]))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    centers = corpus.topic_centers(seed, topics, cfg.dim, dev)
    ring = torch.empty((ring_n, cfg.dim), dtype=torch.float32, device=dev)
    corpus.corpus_into(ring[:n0], centers, seed)
    ledger = Ledger(n0, ins_rows, del_rows)

    svc = MemoryService(device=dev, maintenance=True)
    coll = svc.create_collection(COLLECTION, cfg,
                                 seed=corpus.mix(seed, corpus.PROGRAM),
                                 spill_capacity=spill)
    _sync(dev)
    t_b = time.perf_counter()
    svc.build(COLLECTION, ring[:n0], ids=np.arange(n0, dtype=np.int32))
    _sync(dev)
    build_s = time.perf_counter() - t_b
    lost = mismatch(live_ids(coll), 0, n0)
    paths = {b: coll.resolve_query(b, int(traffic["k"]), None, None)[2]
             for b in traffic["batch_sizes"]}
    clients = Clients(svc, coll, traffic, ring, centers, ledger, seed, paths)

    # warm-up: the cell's own traffic for a while, then one rebuild where
    # the traffic writes; none of it is measured
    warm = clients.run_phase(float(traffic["warmup_seconds"]), 0)
    clients.join(warm, RESULT_TIMEOUT_S + 30)
    if writers:
        svc.submit(MemoryOp("rebuild", COLLECTION)).result(
            timeout=RESULT_TIMEOUT_S)
    if warm.errors:
        raise RuntimeError(f"warm-up failed: {warm.errors[:3]}")
    _sync(dev)

    handle = {}

    def on_start():
        handle["c0"] = svc.counters()
        handle["rb0"] = coll.counters["rebuilds"]
        if trace:
            handle["trace"] = devtrace.start()
        handle["setup_s"] = time.perf_counter() - t_process

    win = clients.run_phase(seconds, 1, on_start)
    t0, t1 = win.t0, win.stop
    time.sleep(max(0.0, t1 - time.perf_counter()))
    c1 = svc.counters()
    counters = Counters({k: v - handle["c0"].get(k, 0)
                         for k, v in c1.items()})
    tr = None
    if trace:
        tr = devtrace.stop(handle["trace"])
    clients.join(win, RESULT_TIMEOUT_S + 30)
    _sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # every acknowledged write read back: the live ids are exactly the range
    lost += mismatch(live_ids(coll), ledger.del_next, ledger.ins_next)
    rebuilds_window = counters("sched.rebuild.n")
    svc.shutdown()
    del svc, coll, clients
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx = SimpleNamespace(
        cfg=engine, spill=spill, seconds=seconds, t0=t0, t1=t1,
        requests=win.requests, writes=win.writes, counters=counters,
        delta=lambda kind: tuple(counters(f"sched.{kind}.{k}")
                                 for k in ("n", "wait_s", "lat_s")),
        trace=tr, spans=tr["spans"] if tr else None, build_s=build_s,
        setup_s=handle["setup_s"],
        live_rows=ledger.ins_next - ledger.del_next, costs=costs,
        rebuilds=rebuilds_window)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"], cell.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # the client's rate and tail in every cell, for the record only
    client = {name: manifest.reader(name, cell.root)(ctx)
              for name in ("queries_per_s", "query_p95_ms")}

    del ring
    ref_corpus = _corpus(n0, cfg.dim, centers, seed)
    checks = verdict.check(
        win, ledger, seed=seed, k=int(traffic["k"]), limits=limits,
        lost=lost, rebuilds_before=handle["rb0"], control=control,
        rows=lambda lo, hi: _rows(lo, hi, n0, ins_rows, centers, seed,
                                  ref_corpus),
        device=dev)
    del ref_corpus
    attempted = len(win.requests) + len(win.writes)
    failed = sum(not r.ok for r in win.requests) + sum(
        not w.ok for w in win.writes)
    out = {"correct": checks["correct"], "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    out["notes"] = {"rebuilds_in_window": rebuilds_window, **client,
                    **({"client_device_s": tr["client_s"]} if tr else {}),
                    "build_s": build_s, "errors": win.errors[:5],
                    **checks["info"]}
    out["checks"] = checks["numbers"]
    return (out, ctx) if want_ctx else out


def _corpus(n0: int, d: int, centers: torch.Tensor, seed: int):
    out = torch.empty((n0, d), dtype=torch.float32, device=centers.device)
    return corpus.corpus_into(out, centers, seed)


def _rows(lo: int, hi: int, n0: int, ins_rows: int, centers, seed: int,
          ref_corpus: torch.Tensor) -> torch.Tensor:
    """Rows of ids lo..hi-1, made again: the corpus, then inserted batches."""
    parts = []
    if lo < n0:
        parts.append(ref_corpus[lo:min(hi, n0)])
    i = max(lo, n0)
    while i < hi:
        j = (i - n0) // ins_rows
        b0 = n0 + j * ins_rows
        rows = corpus.batch_rows(centers, seed, j, ins_rows)
        parts.append(rows[i - b0:min(hi, b0 + ins_rows) - b0])
        i = b0 + ins_rows
    return torch.cat(parts) if len(parts) > 1 else parts[0]
