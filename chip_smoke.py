#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit; TF32 off for f32 products.
2. build: compile the Hopper kernels from ``src/repro_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (PAPER_1M) and at ragged shapes, with times, the
   least time the card could take, and one PyTorch library call's time.
   Both scans are checked and timed in both variants (``stream``,
   ``generic``), and ``kmeans_assign`` in both of its (``wgmma``,
   ``generic``) at the build, rebuild and insert shapes, with ties across
   centroid tiles and slices.  Both scans also take a lane axis (G
   collections in one launch): each is checked against its lane plain
   version in both variants, lane g against the 2-D launch on lane g bit
   for bit, and timed at phase 6's fused shapes.  ``scan_scores`` is also
   checked and timed at phase 11a's retrieval (B=8 over the 1,503,232 slots
   of a PAPER_1M layout at dim 2048).
4. main path, f32: the PAPER_1M memory lifecycle (build, recall@10 against
   an exact brute force, queries, concurrent inserts, deletes, a
   delta-replay rebuild under inserts, queries again) through
   ``repro_torch.api.MemoryService`` on a synthetic clustered corpus made
   from ``--seed``; launch counters show it ran the kernels, every scan in
   its ``stream`` variant and every assignment in its ``wgmma`` one.
5. main path, int8: the same lifecycle on the same corpus with
   ``store_dtype="int8"`` (coarse ``scan_scores_q8`` scan, exact f32
   rescore), then ``save`` / ``load`` of the service and the same query
   ids from the loaded one; its recall@10 must reach 0.95 x phase 4's.
6. fused windows: twelve PAPER_100K tenants (eight f32, four int8) and
   then two PAPER_1M tenants in one ``MemoryService`` each, queried through
   batched windows (``batch=True`` + ``flush``): two dispatches for a mixed
   window, one lane launch per scan step, stack-cache hits, a write seen,
   the probed template, a drop evicting its stacks; every fused result
   equals the per-collection query.
7. residency: a PAPER_1M f32 and a PAPER_1M int8 tenant demoted to host
   memory and promoted three times each (the f32 one also to disk and back
   through a query), every answer after a promotion bit-equal to the one
   recorded before, the card's allocated memory down by at least 0.95 x
   the state's bytes after every demotion; 24 PAPER_100K tenants under a
   device budget of 8.5 tenants queried by a Zipf(1.1) trace of 240 B=1
   queries (every answer the recorded one, the budget and the byte
   breakdown held after every query); a batched window over 8 tenants, 2
   of them demoted, flushes as 1 fused group + 2 promoting singletons.
8. routing: a PAPER_1M f32 and int8 tenant with target recall 0.95 from
   nprobe 4, probed through ``MemoryOp("probe")`` until the knob settles
   (the walk equals a fresh tuner's, recall@k at the knob over 256 fresh
   rows against the card's oracle, B=1 p50 at nprobe 64 and at the knob),
   with B=1 queries from a thread meanwhile and a probe the maintenance
   poll schedules; PAPER_100K tenants under the flat, auto (flat -> ivf
   -> hnsw by inserts) and hnsw policies, the probe tuning ef, the graph
   mirroring writes and dropped by a rebuild and a demotion; a window
   over two tenants tuned apart and two graph tenants flushing as 3
   dispatches; the tuned tenant saved and loaded with its knob.
9. replication: a ``ReplicaSet`` of two replicas on the card over a fresh
   service before the PAPER_1M build (the build ships, the replicas catch
   up leaf for leaf), inserts and a delete with pumps between while
   threads query the replicas and the primary, insert rows/s with the
   ship hook and without in turns; scripted drop, delay and duplicate,
   the primary killed with writes pending (``failover`` replays them, no
   acknowledged write lost, the survivor ends bit-equal), a replica killed
   mid-apply (atomic); a planned failover replays nothing; a query shed to
   a replica when admission control rejects it on the primary; an int8
   set bit-equal and an hnsw replica whose graph mirrors shipped writes.
10. sharded tier: four PAPER_1M shards on the one card (4,000,000 rows,
   f32) through ``MemoryService`` on a ``ShardMesh``: the build, recall@10
   against an exact brute force and the merged answer equal to a global
   top-k over the shards' kernel scores, B=1 and B=64 queries, inserts
   while queries run, a 10,000-id delete counted per shard, a shard
   rebuild under an inserter (zero lost rows), a quiet one that leaves its
   siblings' storage untouched, and a full sweep; the int8 store on two
   shards; a fused window over four sharded PAPER_100K tenants as one
   dispatch (and a mixed window as two); a sharded tenant saved, reloaded,
   resharded onto two shards, refused on a mismatched mesh, demoted to
   WARM and COLD and promoted bit-equal, and rebuilt shard-locally by the
   maintenance poll.
11. serving: ``python -m repro_torch.launch.serve``'s body at granite-3-2b's
   full width (40 layers, d_model 2048, bf16 weights from ``--seed``)
   beside a 1,000,000-row memory at dim 2048 in PAPER_1M's layout: three
   turns of 8 requests (512-token prompts, 32 greedy tokens: retrieval
   spliced into the prefill, KV-cached decode) while 256 rows go in as
   32-row concurrent inserts and each turn's query embeddings after it;
   every turn's ids equal the plain version's on the same snapshot, every
   acknowledged insert live; the projection branch over a PAPER_100K
   memory (dim 1024); the model in float32, its decode logits equal to
   ``forward_train``'s within 2e-3.
12. families: the same serving path for the MoE, VLM, SSM and hybrid
   families at full width (weights from ``--seed``): olmoe-1b-7b beside
   the 1,000,000-row memory with 11a's workload and checks (its MoE
   combine bit-equal on a rerun, a finite aux loss); deepseek-moe-16b,
   qwen2-vl-7b, rwkv6-1.6b and zamba2-2.7b one at a time, one turn each
   through the projection branch over PAPER_100K with concurrent inserts;
   olmoe-1b-7b, rwkv6-1.6b and zamba2-2.7b in float32, decode logits equal
   to ``forward_train``'s within 2e-3.
13. enc-dec: seamless-m4t-large-v2 at full width (24 + 24 layers, bf16
   weights from ``--seed``): 8 requests of 256 source frames and 256
   tokens, a prefill and 32 greedy decode steps against the cached self
   and cross K/V, twice; in float32, decode logits equal to
   ``forward_train``'s within 2e-3.
14. training: granite-3-2b at full width on f32 master weights through
   ``repro_torch.train.Trainer`` (remat, 8 x 512 tokens a step, 10 steps
   on one batch; the loss falls); grad accumulation 2 == 1 in float32 at
   2 layers; bf16 and int8 gradient compression train at 4 layers; a
   checkpoint, a preemption and a restore bit-equal in a fresh trainer;
   one step of each other family at full width and 2 layers.
15. dry run: ``repro_torch.launch.dryrun`` over the 40-cell grid at full
   width on the meta device (32 cells, 8 skipped) within 120 s of host
   time, each cell's H100 roofline terms; then granite-3-2b in three cells
   cut only in batch (train at S = 4096, prefill of 32,768 tokens, decode
   over a 32,768-slot cache), each dry-run and run on the card: the same
   dot FLOPs, the same argument bytes, the peak within 0.8-1.25 x the
   predicted, and the median step beside its roofline bound.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports only torch, numpy
and the port (never jax, never the JAX package).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside the tensor
# cores, device memory rate
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

N_ROWS = 1_000_000       # PAPER_1M's corpus: HotpotQA's 1 M passages
SERVE_REQUESTS = 8       # phase 11a's requests a turn (phase 3 times its scan)
SERVE_DIM = 2048         # granite-3-2b's d_model, the memory's dim in 11a
# phase 6a's per-lane query batches, eight f32 tenants and four int8 ones;
# phase 3 checks and times the lane launches at the Bmax these give
F32_BATCHES = (1, 2, 3, 5, 8, 13, 16, 21)
Q8_BATCHES = (2, 5, 13, 21)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms over `reps` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` launches queued behind a
    spin kernel: the card runs them back to back, so the host time between
    launches, which at the probed shape (tens of microseconds) is most of
    a `cuda_ms` time, does not count."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)       # ~50 ms, longer than the enqueue
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def race(fns, reps):
    """Device ms of each named call (`queued_ms`), in turns a, b, b, a."""
    ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        ms[k].append(queued_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in ms.items()}


class tf32_on:
    """TF32 tensor-core products inside the block, f32 outside (the script
    runs with TF32 off)."""

    def __enter__(self):
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = False


def release() -> None:
    """Free the device memory of services that were shut down and let go:
    a service's futures and scheduler tasks refer to each other, so only
    the cycle collector frees them, not the last `del`."""
    gc.collect()
    torch.cuda.empty_cache()


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_scan(got, want, tol=2e-2, name="scan_scores") -> float:
    """Masked slots identical, finite scores within rtol = atol = tol."""
    if got.shape != want.shape:
        raise AssertionError(f"{name} shape {got.shape} != {want.shape}")
    if not torch.equal(torch.isinf(got), torch.isinf(want)) or not \
            torch.equal(got[torch.isinf(got)], want[torch.isinf(want)]):
        raise AssertionError(f"{name} masks disagree with the plain version")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    bad = err > tol + tol * want[fin].abs()
    if bool(bad.any()) or not bool(torch.isfinite(got[fin]).all()):
        raise AssertionError(f"{name} off by {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def check_assign(x, cent, idx, dist, tol=3e-2, fused=True) -> float:
    """dist within tol of the plain version; idx equal wherever the plain
    version's best-vs-second margin exceeds tol."""
    from repro_torch.kernels import ref
    ridx, rdist = ref.kmeans_assign_ref(x, cent, fused_conversion=fused)
    err = (dist - rdist).abs()
    if bool((err > tol + tol * rdist.abs()).any()):
        raise AssertionError(f"kmeans_assign dist off by {float(err.max())}")
    if cent.shape[0] == 1:
        sure = torch.ones_like(ridx, dtype=torch.bool)
    else:
        rnd = ref.round_bf16 if fused else (lambda t: t)
        d = (rnd(x) @ rnd(cent).T).mul_(-2.0)
        d += (cent ** 2).sum(1)[None, :]
        two = torch.topk(d, 2, dim=1, largest=False).values
        sure = (two[:, 1] - two[:, 0]) > tol
        del d
    if not torch.equal(idx[sure], ridx[sure]):
        n = int((idx[sure] != ridx[sure]).sum())
        raise AssertionError(f"kmeans_assign idx differs on {n} rows with "
                             f"a margin above {tol}")
    if bool(((idx < 0) | (idx >= cent.shape[0])).any()):
        raise AssertionError("kmeans_assign idx out of [0, C)")
    return float(err.max()) if err.numel() else 0.0


def check_segsum(got, want, rtol=1e-4, atol=1e-3) -> float:
    (s, c), (rs, rc) = got, want
    if not torch.equal(c, rc):
        raise AssertionError("segsum_gemm counts are not exact")
    err = (s - rs).abs()
    if bool((err > atol + rtol * rs.abs()).any()):
        raise AssertionError(f"segsum_gemm sums off by {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def phase_kernels(seed: int, cfg) -> dict:
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8
    from repro_torch.kernels import segsum_gemm as sg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def ids_with_holes(n, frac=0.1):
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        holes = torch.rand(n, generator=g, device=dev) < frac
        return torch.where(holes, torch.full_like(ids, -1), ids)

    d = cfg.dim
    c = cfg.n_clusters
    n_full = c * cfg.list_capacity + 4096          # lists + spill slots
    n_probe = cfg.nprobe * cfg.list_capacity + 4096
    m_build = N_ROWS
    out = {}

    # -- scan_scores ------------------------------------------------------
    def variants(mod, b, n, dd, *ptrs):
        """Both variants where the shape takes the stream one."""
        return (("stream", "generic")
                if mod.variant_for(b, n, dd, *ptrs) == "stream"
                else ("generic",))

    err = 0.0
    for (b, n, dd, metric) in [(33, 777, 192, "l2"), (5, 1000, 130, "ip"),
                               (17, 129, d, "l2"), (1, c, d, "ip"),
                               (64, 3000, d, "ip"), (2, 4099, 68, "l2"),
                               (97, 3001, d, "l2"), (200, 100, 768, "ip"),
                               (7, 1000, 256, "l2")]:
        q, db, ids = randn(b, dd), randn(n, dd), ids_with_holes(n)
        norms = (db ** 2).sum(1) if metric == "l2" else None
        want = ref.scan_scores_ref(q, db, ids, norms, metric=metric)
        for v in variants(ss, b, n, dd, q.data_ptr(), db.data_ptr()):
            err = max(err, check_scan(ss.scan_scores(q, db, ids, norms,
                                                     metric=metric,
                                                     _variant=v), want))
    scan_times = {}
    # probed slab B=1, full scan B=64, the recall probe's centroid scan
    # (phase 8: its 64 sampled rows against the C centroids), and phase
    # 11a's retrieval (8 requests over a PAPER_1M layout at granite-3-2b's
    # d_model)
    for label, b, n, d in (("probed", 1, n_probe, d), ("full", 64, n_full, d),
                           ("probe_centroids", 64, c, d),
                           ("serving", SERVE_REQUESTS, n_full, SERVE_DIM)):
        q, db, ids = randn(b, d), randn(n, d), ids_with_holes(n)
        picked = ss.variant_for(b, n, d, q.data_ptr(), db.data_ptr())
        if picked != "stream" and label != "probe_centroids":
            raise AssertionError(f"scan_scores at PAPER_1M {label} does not "
                                 "take the stream variant")
        want = ref.scan_scores_ref(q, db, ids)
        for v in ("stream", "generic"):
            err = max(err, check_scan(ss.scan_scores(q, db, ids, _variant=v),
                                      want))
        del want
        reps = 50 if b == 1 else 10
        var_ms = race({v: (lambda v=v: ss.scan_scores(q, db, ids,
                                                      _variant=v))
                       for v in ("stream", "generic")}, reps)
        ms = cuda_ms(lambda: ss.scan_scores(q, db, ids), reps=reps)
        plain = cuda_ms(lambda: ref.scan_scores_ref(q, db, ids),
                        reps=10 if b == 1 else 3)
        with tf32_on():
            lib = cuda_ms(lambda: torch.mm(q, db.T), reps=reps)
        f32 = cuda_ms(lambda: torch.mm(q, db.T), reps=reps)
        bnd = bound_ms(4 * (n * d + n + b * d + b * n), 2 * b * n * d,
                       PEAK_BF16)
        scan_times[label] = {
            "shape": f"B={b} N={n} D={d} ip", "ms": ms, "variant_ms": var_ms,
            "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": lib, "library_f32_ms": f32}
        if label == "probe_centroids":
            # launch-sized: device times only, queued behind a spin kernel
            with tf32_on():
                lib_q = queued_ms(lambda: torch.mm(q, db.T), reps)
            scan_times[label].update(variant=picked,
                                     library_queued_ms=lib_q)
        del q, db, ids
        torch.cuda.empty_cache()
    full, probed = scan_times["full"], scan_times["probed"]
    d = cfg.dim
    print(f"  scan_scores probe centroids: {scan_times['probe_centroids']}",
          flush=True)
    print(f"  scan_scores serving: {scan_times['serving']}", flush=True)
    out["scan_scores"] = {
        "name": "scan_scores", "route": "cuda",
        "source": "src/repro_torch/csrc/scan_scores.cu",
        "header": "src/repro_torch/csrc/scan_stream.cuh",
        "replaces": "src/repro/kernels/scan_scores.py:203",
        "shape": f"full scan {full.pop('shape')}", "max_abs_err": err,
        **full,
        # TF32 reads the same f32 bytes on the tensor cores; the f32 mm
        # without TF32 runs on the CUDA cores and is bound by operations
        "library_call": "torch.mm(q, db.T) f32 inputs, TF32 on",
        "probed": probed,
        "probe_centroids": scan_times["probe_centroids"],
        "serving": scan_times["serving"],
    }

    # -- scan_scores_q8 ---------------------------------------------------
    def q8_args(b, n, dd, metric):
        """Random operands over the whole int8 range, the scalars the
        store's affine fit gives unit rows, ~10 % tombstones."""
        qc = torch.randint(-127, 128, (b, dd), generator=g, device=dev,
                           dtype=torch.int8)
        codes = torch.randint(-127, 128, (n, dd), generator=g, device=dev,
                              dtype=torch.int8)
        sq = torch.rand(b, generator=g, device=dev) * 1e-2 + 1e-3
        norms = (torch.rand(n, generator=g, device=dev) * 2
                 if metric == "l2" else None)
        return (qc, codes, ids_with_holes(n),
                torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4,
                torch.randn(n, generator=g, device=dev) * 1e-2, sq,
                ref.query_corr(qc, sq), norms)

    def q8_bytes(b, n, dd, metric):
        # codes + ids/scales/zeros (+ norms) + query codes and scalars + out
        return (n * dd + 4 * n * (3 + (metric == "l2")) + b * dd + 8 * b
                + 4 * b * n)

    def q8_check(args, metric, variant):
        return check_scan(q8.scan_scores_q8(*args, metric=metric,
                                            _variant=variant),
                          ref.scan_scores_q8_plain(*args, metric=metric),
                          tol=1e-5, name=f"scan_scores_q8 ({variant})")

    err = 0.0
    for (b, n, dd, metric) in [(97, 3001, 130, "ip"), (97, 3001, 130, "l2"),
                               (5, 1000, 130, "l2"), (1, 777, 130, "ip"),
                               (17, 129, d, "l2"), (64, 4099, d, "ip"),
                               (200, 100, 768, "l2"), (7, 1000, 256, "ip"),
                               (65, 3001, d, "l2")]:
        args = q8_args(b, n, dd, metric)
        for v in variants(q8, b, n, dd, args[0].data_ptr(),
                          args[1].data_ptr()):
            err = max(err, q8_check(args, metric, v))
    q8_times = {}
    for label, b, n in (("probed", 1, n_probe), ("full", 64, n_full)):
        args = q8_args(b, n, d, "ip")
        if q8.variant_for(b, n, d, args[0].data_ptr(),
                          args[1].data_ptr()) != "stream":
            raise AssertionError(f"scan_scores_q8 at PAPER_1M {label} does "
                                 "not take the stream variant")
        for v in ("stream", "generic"):
            err = max(err, q8_check(args, "ip", v))
        reps = 50 if b == 1 else 20
        var_ms = race({v: (lambda v=v: q8.scan_scores_q8(*args, _variant=v))
                       for v in ("stream", "generic")}, reps)
        ms = cuda_ms(lambda: q8.scan_scores_q8(*args), reps=reps)
        plain = cuda_ms(lambda: ref.scan_scores_q8_plain(*args), reps=3)
        # torch._int_mm computes only the int32 product (no epilogue, no
        # mask) and needs more than 16 rows: B=1 goes in padded to 32
        qc = args[0]
        if b <= 16:
            qc = torch.zeros((32, d), dtype=torch.int8, device=dev)
            qc[:b] = args[0]
        codes_t = args[1].t()
        lib = cuda_ms(lambda: torch._int_mm(qc, codes_t), reps=reps)
        qb, qby = bound_ms(q8_bytes(b, n, d, "ip"), 2 * b * n * d, PEAK_INT8)
        q8_times[label] = {
            "shape": f"B={b} N={n} D={d} ip", "ms": ms, "variant_ms": var_ms,
            "plain_ms": plain, "bound_ms": qb, "bound_by": qby,
            "library_ms": lib}
        del args, qc, codes_t
        torch.cuda.empty_cache()
    full, probed = q8_times["full"], q8_times["probed"]
    probed["shape"] += " (_int_mm at 32 rows)"
    out["scan_scores_q8"] = {
        "name": "scan_scores_q8", "route": "cuda",
        "source": "src/repro_torch/csrc/scan_scores_q8.cu",
        "header": "src/repro_torch/csrc/scan_stream.cuh",
        "replaces": "src/repro/kernels/scan_scores.py:135",
        "shape": f"full scan {full.pop('shape')}", "max_abs_err": err,
        **full,
        "library_call": "torch._int_mm(qc, codes.t()): the int32 product "
                        "only, a lower yardstick",
        "probed": probed,
    }

    # -- kmeans_assign ----------------------------------------------------
    def assign_variants(x, cent):
        """Both variants where the shape takes the wgmma one."""
        (m, dd), cc = x.shape, cent.shape[0]
        return (ka.VARIANTS
                if ka.variant_for(m, cc, dd, x.data_ptr(),
                                  cent.data_ptr()) == "wgmma"
                else ("generic",))

    err = 0.0
    err_f32 = 0.0
    for (m, cc, dd) in [(1000, 96, 128), (777, 200, 130), (300, 1, 64),
                        (4097, c, d), (1024, c, d)]:
        x, cent = randn(m, dd), randn(cc, dd)
        for v in assign_variants(x, cent):
            idx, dist = ka.kmeans_assign(x, cent, _variant=v)
            err = max(err, check_assign(x, cent, idx, dist))
        # the f32-product variant (ablation rung fused_conversion=False)
        idx, dist = ka.kmeans_assign(x, cent, fused_conversion=False)
        err_f32 = max(err_f32, check_assign(x, cent, idx, dist, fused=False))
    # ties: copies of three rows in every centroid tile, and at M = 1024 in
    # every C-slice of the wgmma variant, go to the lowest index; the split
    # merge gives the same bits twice
    x, cent = randn(1024, d), randn(c, d)
    for base in (1000, 700, 300, 5):
        cent[base:base + 3] = x[:3]
    for v in ka.VARIANTS:
        idx, dist = ka.kmeans_assign(x, cent, _variant=v)
        err = max(err, check_assign(x, cent, idx, dist))
        if idx[:3].tolist() != [5, 6, 7]:
            raise AssertionError(f"kmeans_assign ({v}) tie went to "
                                 f"{idx[:3].tolist()}, not [5, 6, 7]")
        again = ka.kmeans_assign(x, cent, _variant=v)
        if not (torch.equal(idx, again[0]) and torch.equal(dist, again[1])):
            raise AssertionError(f"kmeans_assign ({v}) is not deterministic")
    # the main path's three shapes: build (the corpus), rebuild (every
    # slot of the lists and the spill), insert (one batch)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assign_times = {}
    for label, m in (("build", m_build), ("rebuild", n_full),
                     ("insert", 1024)):
        x, cent = randn(m, d), randn(c, d)
        if ka.variant_for(m, c, d, x.data_ptr(),
                          cent.data_ptr()) != "wgmma":
            raise AssertionError(f"kmeans_assign at the {label} shape does "
                                 "not take the wgmma variant")
        for v in ka.VARIANTS:
            idx, dist = ka.kmeans_assign(x, cent, _variant=v)
            err = max(err, check_assign(x, cent, idx, dist))
        del idx, dist
        reps = 10 if m > 100_000 else 50
        var_ms = race({v: (lambda v=v: ka.kmeans_assign(x, cent,
                                                        _variant=v))
                       for v in ka.VARIANTS}, reps)
        plain = cuda_ms(lambda: ref.kmeans_assign_ref(x, cent),
                        reps=3 if m > 100_000 else 10)
        # the bf16 product alone, on operands converted before the timing
        xb, cb = x.to(torch.bfloat16), cent.to(torch.bfloat16)
        lib = queued_ms(lambda: torch.mm(xb, cb.t()), reps)
        ab, aby = bound_ms(4 * (m * d + c * d + 2 * m), 2 * m * c * d,
                           PEAK_BF16)
        assign_times[label] = {
            "shape": f"M={m} C={c} D={d}", "ms": var_ms["wgmma"],
            "variant_ms": var_ms, "plain_ms": plain, "bound_ms": ab,
            "bound_by": aby, "library_ms": lib,
            "c_split": ka.c_split(m, c, sms)}
        if label == "build":
            # the f32-product rung (ablation B): kernel, plain version, and
            # the f32 product alone (TF32 off) as its yardstick
            f32_ms = cuda_ms(lambda: ka.kmeans_assign(
                x, cent, fused_conversion=False), reps=3)
            f32_plain = cuda_ms(lambda: ref.kmeans_assign_ref(
                x, cent, fused_conversion=False), reps=3)
            f32_lib = cuda_ms(lambda: torch.mm(x, cent.t()), reps=3)
        del x, cent, xb, cb
        torch.cuda.empty_cache()
    # phase 11a's build and insert at granite-3-2b's d_model: the wgmma
    # variant's resident row tile leaves no room for two ring stages at
    # D = 2048, so `variant_for` gives these shapes to generic
    for label, m in (("serving_build", m_build), ("serving_insert", 32)):
        x, cent = randn(m, SERVE_DIM), randn(c, SERVE_DIM)
        picked = ka.variant_for(m, c, SERVE_DIM, x.data_ptr(),
                                cent.data_ptr())
        idx, dist = ka.kmeans_assign(x, cent)
        err = max(err, check_assign(x, cent, idx, dist))
        del idx, dist
        reps = 3 if m > 100_000 else 50
        ms = cuda_ms(lambda: ka.kmeans_assign(x, cent), reps=reps)
        plain = cuda_ms(lambda: ref.kmeans_assign_ref(x, cent), reps=3)
        xb, cb = x.to(torch.bfloat16), cent.to(torch.bfloat16)
        lib = queued_ms(lambda: torch.mm(xb, cb.t()), reps)
        ab, aby = bound_ms(4 * (m * SERVE_DIM + c * SERVE_DIM + 2 * m),
                           2 * m * c * SERVE_DIM, PEAK_BF16)
        assign_times[label] = {
            "shape": f"M={m} C={c} D={SERVE_DIM}", "variant": picked,
            "ms": ms, "plain_ms": plain, "bound_ms": ab, "bound_by": aby,
            "library_ms": lib}
        del x, cent, xb, cb
        torch.cuda.empty_cache()
    print(f"  kmeans_assign serving: {assign_times['serving_build']} "
          f"{assign_times['serving_insert']}", flush=True)
    f32_bound = bound_ms(4 * (m_build * d + c * d + 2 * m_build),
                         2 * m_build * c * d, PEAK_F32)
    build_t = assign_times["build"]
    out["kmeans_assign"] = {
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "header": "src/repro_torch/csrc/scan_stream.cuh",
        "replaces": "src/repro/kernels/kmeans_assign.py:84",
        "shape": f"build {build_t.pop('shape')}", "max_abs_err": err,
        **build_t,
        "library_call": "torch.mm(xb, cb.t()) on bf16 operands converted "
                        "before the timing: the product only, no "
                        "conversion of x and no argmin, a lower yardstick",
        "rebuild": assign_times["rebuild"],
        "insert": assign_times["insert"],
        "serving_build": assign_times["serving_build"],
        "serving_insert": assign_times["serving_insert"],
        "f32_variant": {"max_abs_err": err_f32, "ms": f32_ms,
                        "plain_ms": f32_plain, "library_ms": f32_lib,
                        "library_call": "torch.mm(x, c.t()) f32, TF32 off: "
                                        "the product only",
                        "bound_ms": f32_bound[0], "bound_by": f32_bound[1]},
    }

    # -- segsum_gemm ------------------------------------------------------
    err = 0.0
    for (m, cc, dd, lo, hi) in [(999, 64, 128, 0, 64), (100, 8, 130, -1, 8),
                                (513, 100, 64, -3, 110), (0, 4, 32, 0, 4),
                                (5000, c, d, -1, c)]:
        x = randn(m, dd)
        a = torch.randint(lo, hi, (m,), generator=g, device=dev,
                          dtype=torch.int32)
        got = sg.segsum_gemm(x, a, n_clusters=cc)
        err = max(err, check_segsum(got, sg.segsum_gemm_plain(
            x, a, n_clusters=cc)))
        if not torch.equal(got[0], sg.segsum_gemm(x, a, n_clusters=cc)[0]):
            raise AssertionError("segsum_gemm is not deterministic")
    # the main path's builds: PAPER_1M's (phases 4-10) and phase 11a's at
    # granite-3-2b's d_model
    sum_times = {}
    for label, dd in (("build", d), ("serving_build", SERVE_DIM)):
        x = randn(m_build, dd)
        a = torch.randint(0, c, (m_build,), generator=g, device=dev,
                          dtype=torch.int32)
        got = sg.segsum_gemm(x, a, n_clusters=c)
        err = max(err, check_segsum(got, sg.segsum_gemm_plain(
            x, a, n_clusters=c)))
        if not torch.equal(got[0], sg.segsum_gemm(x, a, n_clusters=c)[0]):
            raise AssertionError("segsum_gemm is not deterministic")
        ms = cuda_ms(lambda: sg.segsum_gemm(x, a, n_clusters=c), reps=10)
        plain = cuda_ms(lambda: sg.segsum_gemm_plain(x, a, n_clusters=c),
                        reps=3)
        acc = torch.zeros(c, dd, device=dev)
        a64 = a.long()
        lib = cuda_ms(lambda: acc.index_add_(0, a64, x), reps=10)
        sb, sby = bound_ms(4 * (m_build * dd + m_build + c * dd + c),
                           m_build * dd, PEAK_F32)
        sum_times[label] = {
            "shape": f"M={m_build} C={c} D={dd}", "ms": ms,
            "plain_ms": plain, "bound_ms": sb, "bound_by": sby,
            "library_ms": lib}
        del x, a, a64, acc, got
        torch.cuda.empty_cache()
    print(f"  segsum_gemm serving: {sum_times['serving_build']}", flush=True)
    build_s = sum_times["build"]
    out["segsum_gemm"] = {
        "name": "segsum_gemm", "route": "cuda",
        "source": "src/repro_torch/csrc/segsum_gemm.cu",
        "replaces": "src/repro/kernels/segsum_gemm.py:69",
        "max_abs_err": err, **build_s,
        "library_call": "Tensor.index_add_ (f32 rows, atomics)",
        "serving_build": sum_times["serving_build"],
    }
    return out


# ---------------------------------------------------------------------------
# phase 3, lanes: both scans with a lane axis (G collections, one launch)
# ---------------------------------------------------------------------------

def slots(cfg, nprobe=None) -> int:
    """Rows a scan of `cfg` streams: every list slot and the spill (full
    scan), or `nprobe` lists and the spill (a probed query)."""
    return (cfg.n_clusters if nprobe is None else nprobe) \
        * cfg.list_capacity + 4096


def phase_lanes(seed: int) -> dict:
    """Each scan's lane launch against its lane plain version, in both
    variants, at the fused shapes of phase 6 and at ragged shapes; lane g
    of a lane launch against the 2-D launch on lane g, bit for bit; times
    of the fused shapes beside the bound and a library call."""
    from repro_torch.configs.ame_paper import PAPER_100K, PAPER_1M
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    d = PAPER_100K.dim

    def lane_ids(g, n):
        ids = torch.arange(n, dtype=torch.int32, device=dev).repeat(g, 1)
        holes = torch.rand(g, n, generator=gen, device=dev) < 0.1
        return torch.where(holes, torch.full_like(ids, -1), ids)

    def f32_args(g, b, n, dd):
        return (torch.randn(g, b, dd, generator=gen, device=dev),
                torch.randn(g, n, dd, generator=gen, device=dev),
                lane_ids(g, n))

    def q8_args(g, b, n, dd):
        qc = torch.randint(-127, 128, (g, b, dd), generator=gen, device=dev,
                           dtype=torch.int8)
        sq = torch.rand(g, b, generator=gen, device=dev) * 1e-2 + 1e-3
        return (qc, torch.randint(-127, 128, (g, n, dd), generator=gen,
                                  device=dev, dtype=torch.int8),
                lane_ids(g, n),
                torch.rand(g, n, generator=gen, device=dev) * 1e-3 + 1e-4,
                torch.randn(g, n, generator=gen, device=dev) * 1e-2, sq,
                ref.query_corr(qc, sq))

    def lane(args, i):
        return [a[i] for a in args]

    def check(mod, args, plain, tol, name, variants):
        """Lane launch vs the lane plain version (tol) and vs 2-D launches
        of each lane (bit for bit), in each variant; the max error."""
        want = plain(*args)
        err = 0.0
        for v in variants:
            got = mod(*args, _variant=v)
            err = max(err, check_scan(got, want, tol=tol,
                                      name=f"{name} lanes ({v})"))
            for i in range(args[0].shape[0]):
                if not torch.equal(got[i], mod(*lane(args, i), _variant=v)):
                    raise AssertionError(f"{name} ({v}): lane {i} of a lane "
                                         "launch differs from its 2-D launch")
        return err

    out = {"scan_scores": {}, "scan_scores_q8": {}}
    both = ("stream", "generic")
    # ragged lanes: f32 at D = 1000 takes stream (4000-byte rows), D = 130
    # only generic; int8 codes at D = 1024 take stream, D = 1000 generic
    err = 0.0
    for (g, b, n, dd), vs in (((3, 5, 1000, 1000), both),
                              ((3, 5, 1000, 130), ("generic",)),
                              ((2, 97, 300, 768), both)):
        args = f32_args(g, b, n, dd)
        if ss.variant_for(b, n, dd, args[0].data_ptr(),
                          args[1].data_ptr()) != vs[0]:
            raise AssertionError(f"scan_scores lanes {(g, b, n, dd)} do not "
                                 f"take {vs[0]}")
        err = max(err, check(ss.scan_scores, args, ref.scan_scores_lanes_ref,
                             2e-2, "scan_scores", vs))
    err8 = 0.0
    for (g, b, n, dd), vs in (((3, 5, 1000, 1024), both),
                              ((3, 5, 1000, 1000), ("generic",)),
                              ((2, 97, 300, 768), both)):
        args = q8_args(g, b, n, dd)
        if q8.variant_for(b, n, dd, args[0].data_ptr(),
                          args[1].data_ptr()) != vs[0]:
            raise AssertionError(f"scan_scores_q8 lanes {(g, b, n, dd)} do "
                                 f"not take {vs[0]}")
        err8 = max(err8, check(q8.scan_scores_q8, args,
                               ref.scan_scores_q8_lanes_plain, 0.0,
                               "scan_scores_q8", vs))

    # the fused shapes phase 6 launches: each group's full scan at Bmax,
    # its centroid scan at Bmax (probed windows; the int8 group's centroids
    # are f32) and its probed slabs at B = 1 per lane, and 6b's PAPER_1M
    # centroid scan and slabs
    g32, b32 = len(F32_BATCHES), max(F32_BATCHES)
    g8, b8 = len(Q8_BATCHES), max(Q8_BATCHES)
    for label, g, b, n in (
            ("full PAPER_100K", g32, b32, slots(PAPER_100K)),
            ("centroids PAPER_100K", g32, b32, PAPER_100K.n_clusters),
            ("centroids PAPER_100K int8 group", g8, b8,
             PAPER_100K.n_clusters),
            ("probed PAPER_100K", g32, 1,
             slots(PAPER_100K, PAPER_100K.nprobe)),
            ("centroids PAPER_1M", 2, 1, PAPER_1M.n_clusters),
            ("probed PAPER_1M", 2, 1, slots(PAPER_1M, PAPER_1M.nprobe))):
        args = f32_args(g, b, n, d)
        if ss.variant_for(b, n, d, args[0].data_ptr(),
                          args[1].data_ptr()) != "stream":
            raise AssertionError(f"scan_scores lanes {label} do not take "
                                 "the stream variant")
        err = max(err, check(ss.scan_scores, args, ref.scan_scores_lanes_ref,
                             2e-2, "scan_scores", both))
        q, db, ids = args
        reps = 50 if n < 50_000 else 10
        var_ms = race({v: (lambda v=v: ss.scan_scores(*args, _variant=v))
                       for v in both}, reps)
        plain = cuda_ms(lambda: ref.scan_scores_lanes_ref(*args), reps=3)
        dbt = db.transpose(1, 2)
        with tf32_on():
            lib = queued_ms(lambda: torch.bmm(q, dbt), reps)
        lib_f32 = queued_ms(lambda: torch.bmm(q, dbt), reps)
        bnd = bound_ms(4 * g * (n * d + n + b * d + b * n), 2 * g * b * n * d,
                       PEAK_BF16)
        out["scan_scores"][label] = {
            "shape": f"G={g} B={b} N={n} D={d} ip", "ms": var_ms["stream"],
            "variant_ms": var_ms, "plain_ms": plain, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": lib, "library_f32_ms": lib_f32,
            "library_call": "torch.bmm(q, db.transpose(1, 2)) f32 inputs, "
                            "TF32 on"}
        del args, q, db, ids, dbt
        torch.cuda.empty_cache()
    for label, g, b, n in (
            ("full PAPER_100K", g8, b8, slots(PAPER_100K)),
            ("probed PAPER_100K", g8, 1,
             slots(PAPER_100K, PAPER_100K.nprobe))):
        args = q8_args(g, b, n, d)
        if q8.variant_for(b, n, d, args[0].data_ptr(),
                          args[1].data_ptr()) != "stream":
            raise AssertionError(f"scan_scores_q8 lanes {label} do not take "
                                 "the stream variant")
        err8 = max(err8, check(q8.scan_scores_q8, args,
                               ref.scan_scores_q8_lanes_plain, 0.0,
                               "scan_scores_q8", both))
        reps = 50 if n < 50_000 else 20
        var_ms = race({v: (lambda v=v: q8.scan_scores_q8(*args, _variant=v))
                       for v in both}, reps)
        plain = cuda_ms(lambda: ref.scan_scores_q8_lanes_plain(*args), reps=3)
        # no batched int8 product in PyTorch: G back-to-back torch._int_mm,
        # the queries padded to 32 rows (its least), the product only
        qc = torch.zeros((g, 32, d), dtype=torch.int8, device=dev)
        qc[:, :b] = args[0]
        codes_t = [args[1][i].t() for i in range(g)]

        def int_mm():
            for i in range(g):
                torch._int_mm(qc[i], codes_t[i])

        lib = queued_ms(int_mm, reps)
        # codes + ids/scales/zeros + query codes and scalars + out
        nbytes = g * (n * d + 12 * n + b * d + 8 * b + 4 * b * n)
        bnd = bound_ms(nbytes, 2 * g * b * n * d, PEAK_INT8)
        out["scan_scores_q8"][label] = {
            "shape": f"G={g} B={b} N={n} D={d} ip", "ms": var_ms["stream"],
            "variant_ms": var_ms, "plain_ms": plain, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": lib,
            "library_call": f"{g} x torch._int_mm(qc, codes.t()), the "
                            "queries padded to 32 rows: the int32 product "
                            "only, a lower yardstick"}
        del args, qc, codes_t
        torch.cuda.empty_cache()
    out["scan_scores"]["max_abs_err"] = err
    out["scan_scores_q8"]["max_abs_err"] = err8
    return out


# ---------------------------------------------------------------------------
# phase 4: the PAPER_1M memory lifecycle through MemoryService
# ---------------------------------------------------------------------------

def make_corpus(n: int, d: int, g: torch.Generator) -> torch.Tensor:
    """Unit rows around n/25 random topic directions (about 25 rows a
    topic): clustered, yet spread over enough topics that 1024 k-means
    lists stay under their 1.5x-mean capacity."""
    dev = g.device
    n_topics = max(1, n // 25)
    centers = torch.nn.functional.normalize(
        torch.randn(n_topics, d, generator=g, device=dev), dim=1)
    topic = torch.randint(0, n_topics, (n,), generator=g, device=dev)
    x = centers[topic]
    del centers
    x += torch.randn(n, d, generator=g, device=dev).div_(math.sqrt(d))
    return torch.nn.functional.normalize(x, dim=1, out=x)


def perturb(rows: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    noise = torch.randn(rows.shape, generator=g, device=rows.device)
    return torch.nn.functional.normalize(
        rows + 0.3 * noise / math.sqrt(rows.shape[1]), dim=1)


def phase_main(seed: int, cfg) -> dict:
    """The memory lifecycle of `cfg` at PAPER_1M scale on the card; under
    the int8 policy it ends with a save/load round trip of the service."""
    from repro_torch.api import MemoryOp, MemoryService
    from repro_torch.core import metrics
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8
    from repro_torch.kernels import segsum_gemm as sg

    n, dev = N_ROWS, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = make_corpus(n, cfg.dim, g)
    live = np.zeros(n + 200_000, dtype=bool)    # the host-side id set
    live[:n] = True
    next_id = n
    out = {"store_dtype": cfg.store_dtype}

    def check_live(coll, what):
        st = coll.snapshot()
        ids = torch.cat([st.list_ids.reshape(-1), st.spill_ids])
        got = torch.sort(ids[ids >= 0]).values
        want = torch.from_numpy(np.nonzero(live)[0].astype(np.int32)).to(dev)
        if not torch.equal(got, want):
            raise AssertionError(
                f"live ids after {what}: {got.numel()} in the index vs "
                f"{want.numel()} acknowledged")

    def fresh_rows(b):
        nonlocal next_id
        rows = torch.nn.functional.normalize(
            torch.randn(b, cfg.dim, generator=g, device=dev), dim=1)
        ids = np.arange(next_id, next_id + b, dtype=np.int32)
        next_id += b
        return rows, ids

    def targets(b):
        cand = np.nonzero(live[:n])[0]
        pick = torch.randint(0, len(cand), (b,), generator=g, device=dev)
        return cand[pick.cpu().numpy()]

    def queries(b):
        t = targets(b)
        return t, perturb(x[torch.from_numpy(t).to(dev)], g)

    def hit_rate(svc, b, reps, path):
        hits = tot = 0
        lat = []
        for _ in range(reps):
            t, q = queries(b)
            t0 = time.perf_counter()
            ids, _ = svc.query("mem", q)
            lat.append(time.perf_counter() - t0)
            hits += int((ids[:, 0] == t).sum())
            tot += b
        rate = hits / tot
        if rate < 0.99:
            raise AssertionError(f"{path} queries found their row first on "
                                 f"{rate:.4f} < 0.99 of queries")
        return rate, lat

    kernels = {"scan_scores": ss, "scan_scores_q8": q8, "kmeans_assign": ka,
               "segsum_gemm": sg}
    for mod in kernels.values():
        mod.launches.reset()
        for counter in getattr(mod, "launches_by_variant", {}).values():
            counter.reset()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as saved:
        with MemoryService() as svc:
            coll = svc.create_collection("mem", cfg, seed=seed,
                                         spill_capacity=4096)
            if svc.device.type != "cuda":
                raise AssertionError(f"service runs on {svc.device}")
            t0 = time.perf_counter()
            r = svc.build("mem", x, ids=np.arange(n, dtype=np.int32))
            out["build_s"] = time.perf_counter() - t0
            out["build_spilled"] = r["spilled"]
            check_live(coll, "build")
            if coll.stats()["store_dtype"] != cfg.store_dtype:
                raise AssertionError("the collection's store policy changed")

            # recall@10 of both query paths against an exact f32 brute force
            _, rq = queries(256)
            truth = metrics.brute_force_topk(
                rq, x, torch.arange(n, device=dev), 10, cfg.metric,
                device=dev)
            for path in ("full_scan", "probed"):
                got, _ = svc.query("mem", rq, k=10, path=path)
                out[f"recall10_{path}"] = metrics.recall_at_k(got, truth)
            del rq, truth

            # the router sends B=1 down the probed path, B=64 to the full scan
            if coll.resolve_query(1, None, None, None)[2] != "probed" or \
                    coll.resolve_query(64, None, None, None)[2] != "full_scan":
                raise AssertionError("PAPER_1M routing changed")
            hit_rate(svc, 1, 3, "probed")                # warm-up
            out["probed_hit"], lat = hit_rate(svc, 1, 50, "probed")
            out["probed_p50_ms"] = 1e3 * float(np.median(lat))
            hit_rate(svc, 64, 1, "full scan")            # warm-up
            out["full_hit"], lat = hit_rate(svc, 64, 8, "full scan")
            out["full_scan_qps"] = 64 * len(lat) / sum(lat)

            # 8 insert batches as futures while probed queries run
            batches = [fresh_rows(1024) for _ in range(8)]
            t0 = time.perf_counter()
            futs = [svc.submit(MemoryOp("insert", "mem", rows, ids=ids,
                                        concurrent=True))
                    for rows, ids in batches]
            hit_rate(svc, 1, 10, "probed (during inserts)")
            for f in futs:
                f.result(timeout=300)
            out["insert_rows_per_s"] = 8 * 1024 / (time.perf_counter() - t0)
            for _, ids in batches:
                live[ids] = True
            check_live(coll, "inserts")

            # delete 10,000 live corpus ids
            gone = np.random.default_rng(seed).choice(n, 10_000, replace=False)
            n_hit = svc.delete("mem", gone.astype(np.int32))
            if n_hit != 10_000:
                raise AssertionError(f"delete tombstoned {n_hit} of 10000")
            live[gone] = False
            check_live(coll, "delete")

            # rebuild while inserts keep landing: they go to the delta log
            # and are replayed onto the rebuilt index before it is published
            t0 = time.perf_counter()
            fut = svc.submit(MemoryOp("rebuild", "mem"))
            landed = 0
            while not fut.done() and landed < 400:
                rows, ids = fresh_rows(256)
                svc.insert("mem", rows, ids=ids)
                live[ids] = True
                landed += 1
            rb = fut.result(timeout=600)
            out["rebuild_s"] = time.perf_counter() - t0
            out["rebuild_replayed_rows"] = rb["replayed"]
            out["inserts_during_rebuild"] = landed
            if rb["aborted"] or rb["replayed"] == 0:
                raise AssertionError(f"rebuild did not replay a delta: {rb}")
            check_live(coll, "rebuild")

            out["probed_hit_after"], _ = hit_rate(svc, 1, 30, "probed")
            out["full_hit_after"], _ = hit_rate(svc, 64, 4, "full scan")
            st = coll.stats()
            out["live"] = st["live"]
            out["spill"] = st["spill"]
            out["index_gb"] = st["index_bytes"] / 1e9
            if cfg.quantized:
                _, sq = queries(64)
                want = [svc.query("mem", sq),
                        svc.query("mem", sq[:8], path="probed")]
                t0 = time.perf_counter()
                svc.save(saved)
                out["save_s"] = time.perf_counter() - t0
        del svc, coll                 # free the state before loading a copy
        release()
        if cfg.quantized:
            t0 = time.perf_counter()
            with MemoryService.load(saved) as back:
                out["load_s"] = time.perf_counter() - t0
                got = [back.query("mem", sq),
                       back.query("mem", sq[:8], path="probed")]
                check_live(back.collection("mem"), "save/load")
            for (gi, gs), (wi, ws) in zip(got, want):
                if not (np.array_equal(gi, wi) and np.array_equal(gs, ws)):
                    raise AssertionError("the loaded service answers "
                                         "differently from the saved one")
            out["reload_same_ids"] = True
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["launches"] = {k: m.launches.value for k, m in kernels.items()}
    needed = (("scan_scores_q8", "scan_scores", "kmeans_assign", "segsum_gemm")
              if cfg.quantized else
              ("scan_scores", "kmeans_assign", "segsum_gemm"))
    for k in needed:
        if out["launches"][k] <= 0:
            raise AssertionError(f"main path ({cfg.store_dtype}) never "
                                 f"launched {k}")
    # every scan and assignment of the main path is at D = 1024 and takes
    # the fast variant (stream for the scans, wgmma for kmeans_assign)
    out["launches_by_variant"] = {
        k: {v: c.value for v, c in kernels[k].launches_by_variant.items()}
        for k in ("scan_scores", "scan_scores_q8", "kmeans_assign")}
    for k, by in out["launches_by_variant"].items():
        fast = next(iter(by))
        if by["generic"] or by[fast] != out["launches"][k]:
            raise AssertionError(f"main path ({cfg.store_dtype}) {k} "
                                 f"launches by variant {by}: not all {fast}")
    return out


# ---------------------------------------------------------------------------
# phase 6: fused multi-tenant windows through MemoryService
# ---------------------------------------------------------------------------

def phase_fused(seed: int, card: str) -> dict:
    """Cross-collection fused windows on the card.  6a: twelve PAPER_100K
    tenants (eight f32, four int8) in one service, a window of unequal
    per-lane batches (full scans: two dispatches, one lane launch per
    group), the window again (stack-cache hits), after an insert (one miss,
    the new row visible), a probed window (1 + Bmax lane launches per
    group), then a drop (its stacks evicted).  6b: two PAPER_1M f32 tenants
    with one query each (the probed path).  Every fused result equals the
    same request run per collection (ids equal, scores to 1e-5), and every
    scan is a `stream` lane launch."""
    from repro_torch.api import MemoryOp, MemoryService
    from repro_torch.configs.ame_paper import PAPER_100K, PAPER_1M
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8
    from repro_torch.kernels import segsum_gemm as sg

    dev = torch.device("cuda")
    mods = {"scan_scores": ss, "scan_scores_q8": q8}
    kernels = {**mods, "kmeans_assign": ka, "segsum_gemm": sg}
    for m in kernels.values():          # the tenants' builds count too
        for c in (m.launches, *getattr(m, "launches_by_variant", {}).values(),
                  *getattr(m, "launches_by_lanes", {}).values()):
            c.reset()
    torch.cuda.reset_peak_memory_stats()

    def counts():
        return {k: (m.launches.value, m.launches_by_lanes["G>1"].value)
                for k, m in mods.items()}

    def window(svc, reqs, path=None):
        """One batched window: (dispatches, results, wall s, launches)."""
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [svc.submit(MemoryOp("query", n, q, path=path, batch=True))
                for n, q in reqs]
        n_disp = svc.flush()
        res = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        after = counts()
        launched = {k: (after[k][0] - before[k][0],
                        after[k][1] - before[k][1]) for k in mods}
        for k, (n_all, n_lanes) in launched.items():
            if n_all != n_lanes:
                raise AssertionError(f"fused window: {n_all} {k} launches, "
                                     f"only {n_lanes} of them lane launches")
        return n_disp, res, wall, launched

    def per_collection(svc, reqs, path=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [svc.query(n, q, path=path) for n, q in reqs]
        return res, time.perf_counter() - t0

    def same(got, want, what):
        for (gi, gs), (wi, ws) in zip(got, want):
            if not np.array_equal(gi, wi):
                raise AssertionError(f"{what}: fused ids differ from the "
                                     "per-collection query")
            if not np.allclose(gs, ws, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{what}: fused scores differ by "
                                     f"{float(np.abs(gs - ws).max())}")

    def corpus_of(i, n, d):
        g = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        return make_corpus(n, d, g), g

    out = {}
    # -- 6a ---------------------------------------------------------------
    f32_names = [f"f{i}" for i in range(len(F32_BATCHES))]
    q8_names = [f"q{i}" for i in range(len(Q8_BATCHES))]
    sizes = dict(zip(f32_names + q8_names, F32_BATCHES + Q8_BATCHES))
    q8_cfg = dataclasses.replace(PAPER_100K, store_dtype="int8")
    with MemoryService(batch_window=64, maintenance=False) as svc:
        reqs = []
        t0 = time.perf_counter()
        for i, name in enumerate(f32_names + q8_names):
            cfg = PAPER_100K if name in f32_names else q8_cfg
            svc.create_collection(name, cfg, seed=seed + i)
            x, g = corpus_of(i, 100_000, cfg.dim)
            svc.build(name, x, ids=np.arange(100_000) + 1_000_000 * i)
            pick = torch.randint(0, 100_000, (sizes[name],), generator=g,
                                 device=dev)
            reqs.append((name, perturb(x[pick], g)))
            del x
        out["build_12_s"] = time.perf_counter() - t0
        out["6a_build_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()        # the windows' own peak
        if any(svc.collection(n).resolve_query(b, None, None, None)[2]
               != "full_scan" for n, b in sizes.items()):
            raise AssertionError("PAPER_100K routing changed")
        bmax = {"f32": max(sizes[n] for n in f32_names),
                "int8": max(sizes[n] for n in q8_names)}
        want, _ = per_collection(svc, reqs)          # also the warm-up

        n_disp, got, wall_first, launched = window(svc, reqs)
        if n_disp != 2:
            raise AssertionError(f"the mixed window flushed as {n_disp} "
                                 "dispatches, not 2 (f32 and int8 apart)")
        same(got, want, "6a full scan")
        # one lane launch per kernel: the f32 group's scan_scores, the int8
        # group's scan_scores_q8 (its rescore is exact f32 arithmetic)
        if launched != {"scan_scores": (1, 1), "scan_scores_q8": (1, 1)}:
            raise AssertionError(f"6a full-scan window launches {launched}")
        st0 = svc.stats()["stack_cache"]
        _, got, wall, _ = window(svc, reqs)
        st1 = svc.stats()["stack_cache"]
        if st1["hits"] != st0["hits"] + 2 or st1["misses"] != st0["misses"]:
            raise AssertionError(f"repeated window: stack cache {st0} -> "
                                 f"{st1}, not two hits")
        same(got, want, "6a repeated window")
        # host-clock walls vary on a shared host: medians of five
        wall = float(np.median([window(svc, reqs)[2] for _ in range(5)]))
        sync_s = float(np.median([per_collection(svc, reqs)[1]
                                  for _ in range(5)]))
        st1 = svc.stats()["stack_cache"]
        n_q = sum(sizes.values())
        out["6a_full"] = {
            "tenants": "8 f32 + 4 int8 PAPER_100K", "queries": n_q,
            "bmax": bmax, "dispatches": n_disp,
            "first_window_s": wall_first, "window_s": wall,
            "window_qps": n_q / wall, "sync_loop_s": sync_s,
            "sync_loop_qps": n_q / sync_s, "launches": launched}

        # an insert into one tenant: its group restacks, the row is seen
        new_id = 1_000_000 * len(sizes) + 7
        row = torch.nn.functional.normalize(
            torch.randn(1, PAPER_100K.dim, device=dev), dim=1)
        svc.insert("f3", row, ids=np.asarray([new_id], np.int32))
        reqs2 = reqs + [("f3", row)]
        want2, _ = per_collection(svc, reqs2)
        _, got, _, _ = window(svc, reqs2)
        st2 = svc.stats()["stack_cache"]
        if st2["misses"] != st1["misses"] + 1 or \
                st2["hits"] != st1["hits"] + 1:
            raise AssertionError(f"after an insert: stack cache {st1} -> "
                                 f"{st2}, not one miss and one hit")
        same(got, want2, "6a after insert")
        if int(got[-1][0][0, 0]) != new_id:
            raise AssertionError("the inserted row is not visible to the "
                                 "fused window")

        # the fused probed template: 1 + Bmax lane launches per group
        wantp, _ = per_collection(svc, reqs, path="probed")
        n_disp, got, _, launched = window(svc, reqs, path="probed")
        same(got, wantp, "6a probed")
        wallp = float(np.median([window(svc, reqs, path="probed")[2]
                                 for _ in range(3)]))
        syncp_s = float(np.median([per_collection(svc, reqs, "probed")[1]
                                   for _ in range(3)]))
        want_l = {"scan_scores": (2 + bmax["f32"],) * 2,
                  "scan_scores_q8": (bmax["int8"],) * 2}
        if n_disp != 2 or launched != want_l:
            raise AssertionError(f"6a probed window: {n_disp} dispatches, "
                                 f"launches {launched}, not {want_l}")
        out["6a_probed"] = {"window_s": wallp, "window_qps": n_q / wallp,
                            "sync_loop_s": syncp_s,
                            "sync_loop_qps": n_q / syncp_s,
                            "launches": launched}
        out["6a_stack_cache"] = svc.stats()["stack_cache"]

        # a drop evicts every stack holding the tenant
        gone = svc.collection("f5")
        svc.drop_collection("f5")
        held = [k for k in svc._stack_cache._entries
                if any(c is gone for c, _ in k[1])]
        if held:
            raise AssertionError("drop_collection left stacks of the tenant")
        out["6a_stack_cache_after_drop"] = svc.stats()["stack_cache"]
        del gone, held
    del svc, reqs, reqs2, want, want2, wantp, got, row
    out["6a_windows_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    release()

    # -- 6b ---------------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    with MemoryService(batch_window=64, maintenance=False) as svc:
        reqs = []
        for i, name in enumerate(("m0", "m1")):
            svc.create_collection(name, PAPER_1M, seed=seed + 20 + i)
            x, g = corpus_of(20 + i, N_ROWS, PAPER_1M.dim)
            svc.build(name, x, ids=np.arange(N_ROWS) + 10_000_000 * i)
            reqs.append((name, perturb(x[:1], g)))
            del x
        out["6b_build_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        if svc.collection("m0").resolve_query(1, None, None, None)[2] != \
                "probed":
            raise AssertionError("PAPER_1M routing changed")
        want, _ = per_collection(svc, reqs)
        sync_s = float(np.median([per_collection(svc, reqs)[1]
                                  for _ in range(5)]))
        n_disp, got, wall_first, launched = window(svc, reqs)
        same(got, want, "6b")
        for i, (ids, _) in enumerate(got):
            if int(ids[0, 0]) != 10_000_000 * i:
                raise AssertionError("6b: a query missed its own row")
        walls = [window(svc, reqs)[2] for _ in range(5)]
        if n_disp != 1 or launched != {"scan_scores": (2, 2),
                                       "scan_scores_q8": (0, 0)}:
            raise AssertionError(f"6b window: {n_disp} dispatches, "
                                 f"launches {launched}")
        out["6b_probed"] = {
            "tenants": "2 f32 PAPER_1M", "queries": 2,
            "first_window_s": wall_first,
            "window_s_p50": float(np.median(walls)),
            "window_qps": 2 / float(np.median(walls)),
            "sync_loop_s": sync_s, "sync_loop_qps": 2 / sync_s,
            "launches": launched,
            "stack_cache": svc.stats()["stack_cache"]}
    del svc, reqs, want, got
    out["6b_windows_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    release()
    out["card"] = card
    out["launches"] = {k: m.launches.value for k, m in kernels.items()}
    out["launches_by_lanes"] = {
        k: {key: c.value for key, c in m.launches_by_lanes.items()}
        for k, m in mods.items()}
    out["launches_by_variant"] = {
        k: {v: c.value for v, c in kernels[k].launches_by_variant.items()}
        for k in ("scan_scores", "scan_scores_q8", "kmeans_assign")}
    for k, n in out["launches"].items():
        if n <= 0:
            raise AssertionError(f"phase 6 never launched {k}")
    # every scan a stream launch, every assignment a wgmma one
    for k, by in out["launches_by_variant"].items():
        fast = next(iter(by))
        if by["generic"] or by[fast] != out["launches"][k]:
            raise AssertionError(f"phase 6 {k} launches by variant {by}: "
                                 f"not all {fast}")
    return out


# ---------------------------------------------------------------------------
# phase 7: residency tiers (HOT on the card, WARM in host memory, COLD on
# disk) through MemoryService
# ---------------------------------------------------------------------------

N_TENANTS = 24          # 7b: PAPER_100K tenants, about a third of them HOT
TENANT_ROWS = 100_000   # each 7b tenant's corpus: PAPER_100K's size
BUDGET_TENANTS = 8.5    # 7b's device budget, in tenants' state bytes
TRACE_LEN = 240         # 7b: B=1 queries drawn Zipf(ZIPF_S) over tenants
ZIPF_S = 1.1


def same_bits(got, want, what):
    for (gi, gs), (wi, ws) in zip(got, want):
        if not (np.array_equal(gi, wi) and np.array_equal(gs, ws)):
            raise AssertionError(f"{what}: the answer differs from the one "
                                 "recorded before the demotion")


def promote_s_total(st) -> float:
    return (st["promote_s_mean"] or 0.0) * st["promotions"]


def pct_ms(xs, p):
    return 1e3 * float(np.percentile(xs, p)) if xs else None


def phase_residency(seed: int, card: str) -> dict:
    """Residency on the card.  7a: a PAPER_1M f32 and a PAPER_1M int8
    tenant, each demoted to WARM and promoted three times (the first apart
    from the steady state), the f32 one also demoted to COLD and promoted
    by a query; every answer after a promotion bit-equal to the recorded
    one, and `memory_allocated` down by >= 0.95 x the state's bytes after
    every demotion.  7b: 24 PAPER_100K f32 tenants under a budget of 8.5
    tenants and a Zipf(1.1) trace of 240 B=1 queries over them: every
    answer the recorded one, the budget and the byte breakdown held after
    every query, no over-budget admission.  7c: a batched window over 8
    tenants of which 2 were demoted flushes as one fused group of 6 lanes
    plus 2 self-promoting singletons."""
    from repro_torch.api import MemoryOp, MemoryService
    from repro_torch.configs.ame_paper import PAPER_100K, PAPER_1M
    from repro_torch.core import index as ivf
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8
    from repro_torch.kernels import segsum_gemm as sg

    dev = torch.device("cuda")
    kernels = {"scan_scores": ss, "scan_scores_q8": q8, "kmeans_assign": ka,
               "segsum_gemm": sg}
    for m in kernels.values():
        for c in (m.launches, *getattr(m, "launches_by_variant", {}).values(),
                  *getattr(m, "launches_by_lanes", {}).values()):
            c.reset()
    out = {"card": card}

    def demote(svc, name, tier):
        """Demote through the service; returns (seconds, bytes freed)."""
        coll = svc.collection(name)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = svc.submit(MemoryOp("demote", name, tier=tier)).result(
            timeout=600)
        wall = time.perf_counter() - t0
        freed = before - torch.cuda.memory_allocated()
        if not r["demoted"] or coll.residency != tier:
            raise AssertionError(f"{name} did not demote to {tier}: {r}")
        if freed < 0.95 * coll.index_nbytes():
            raise AssertionError(
                f"demoting {name} to {tier} freed {freed} bytes of the "
                f"card's memory, < 0.95 x its {coll.index_nbytes()}")
        return wall, freed

    def host_bytes(coll):
        host = coll._host_state
        leaves = [t for t in host if t is not None]
        if not all(t.is_pinned() for t in leaves):
            raise AssertionError(f"{coll.name}: a WARM leaf is not in "
                                 "page-locked memory")
        return sum(t.numel() * t.element_size() for t in leaves)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_residency_") as tmp:
        # -- 7a ---------------------------------------------------------------
        torch.cuda.reset_peak_memory_stats()
        with MemoryService(maintenance=False, residency_dir=tmp) as svc:
            for i, cfg in enumerate(
                    (PAPER_1M, dataclasses.replace(PAPER_1M,
                                                   store_dtype="int8"))):
                name = f"r{cfg.store_dtype}"
                coll = svc.create_collection(name, cfg, seed=seed + 30 + i)
                g = torch.Generator(device=dev).manual_seed(seed + 30 + i)
                x = make_corpus(N_ROWS, cfg.dim, g)
                svc.build(name, x, ids=np.arange(N_ROWS, dtype=np.int32))
                pick = torch.randint(0, N_ROWS, (80,), generator=g,
                                     device=dev)
                q = perturb(x[pick], g)
                del x, pick
                reqs = [(q[:64], "full_scan")] + [
                    (q[64 + j:65 + j], "probed") for j in range(16)]

                def answers():
                    return [svc.query(name, qq, path=p) for qq, p in reqs]

                want = answers()
                nb = coll.index_nbytes()
                rec = {"index_bytes": nb, "warm": []}
                for rep in range(3):
                    dem_s, freed = demote(svc, name, "warm")
                    held = host_bytes(coll)
                    alloc = torch.cuda.memory_allocated()
                    reserved = torch.cuda.memory_reserved()
                    t0 = time.perf_counter()
                    if svc.promote(name) != "hot":
                        raise AssertionError(f"{name} did not promote")
                    pro_s = time.perf_counter() - t0
                    same_bits(answers(), want,
                              f"7a {name} after warm promotion {rep}")
                    rec["warm"].append({
                        "demote_s": dem_s, "demote_gbps": nb / dem_s / 1e9,
                        "promote_s": pro_s, "promote_gbps": nb / pro_s / 1e9,
                        "freed_bytes": freed, "host_bytes": held,
                        "allocated_while_warm": alloc,
                        "reserved_while_warm": reserved})
                if not cfg.quantized:
                    dem_s, freed = demote(svc, name, "cold")
                    res = svc.residency.stats()
                    t0 = time.perf_counter()
                    got = svc.query(name, reqs[0][0], path="full_scan")
                    hit_s = time.perf_counter() - t0
                    # the promotion's own seconds, as ensure_hot timed it
                    pro_s = promote_s_total(svc.residency.stats()) \
                        - promote_s_total(res)
                    if coll.residency != "hot":
                        raise AssertionError("a query did not promote the "
                                             "COLD tenant")
                    same_bits([got] + answers()[1:], want,
                              f"7a {name} after cold promotion")
                    rec["cold"] = {
                        "demote_s": dem_s, "demote_gbps": nb / dem_s / 1e9,
                        "promote_by_query_s": hit_s,
                        "promote_s": pro_s, "promote_gbps": nb / pro_s / 1e9,
                        "freed_bytes": freed,
                        "disk_bytes": res["disk_bytes"]}
                out[f"7a_{cfg.store_dtype}"] = rec
                # release this tenant's card memory before the next one
                demote(svc, name, "warm")
            out["7a_residency"] = svc.residency.stats()
            if hasattr(torch.cuda, "host_memory_stats"):
                out["7a_host_allocator"] = {
                    k: v for k, v in torch.cuda.host_memory_stats().items()
                    if k.endswith(".current") or k.endswith(".peak")}
        del svc, coll, q, reqs, want, got
        out["7a_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        release()

        # -- 7b ---------------------------------------------------------------
        torch.cuda.reset_peak_memory_stats()
        nb = ivf.state_nbytes(PAPER_100K)
        budget = int(BUDGET_TENANTS * nb)
        names = [f"t{i:02d}" for i in range(N_TENANTS)]
        with MemoryService(maintenance=False, batch_window=64,
                           device_budget_bytes=budget,
                           residency_dir=tmp) as svc:
            def check_budget(what):
                st = svc.residency.stats()
                if st["device_bytes"] - st["stack_cache_bytes"] > budget:
                    raise AssertionError(f"{what}: {st['device_bytes']} "
                                         f"device bytes over the budget")
                total = st["device_bytes"] + st["host_bytes"] \
                    + st["disk_bytes"]
                if total != len(st["tiers"]) * nb + st["stack_cache_bytes"]:
                    raise AssertionError(f"{what}: tiers hold {total} bytes")
                if st["over_budget_events"]:
                    raise AssertionError(f"{what}: an over-budget admission")
                return st

            queries, want = {}, {}
            t0 = time.perf_counter()
            for i, name in enumerate(names):
                coll = svc.create_collection(name, PAPER_100K,
                                             seed=seed + 40 + i)
                if coll.index_nbytes() != nb:
                    raise AssertionError("PAPER_100K state bytes changed")
                g = torch.Generator(device=dev).manual_seed(seed + 40 + i)
                x = make_corpus(TENANT_ROWS, PAPER_100K.dim, g)
                svc.build(name, x, ids=np.arange(TENANT_ROWS) + 1_000_000 * i)
                pick = torch.randint(0, TENANT_ROWS, (4,), generator=g,
                                     device=dev)
                queries[name] = perturb(x[pick], g)
                del x, pick
                want[name] = [svc.query(name, queries[name][j:j + 1])
                              for j in range(4)]
                check_budget(f"7b build {name}")
            out["7b_build_s"] = time.perf_counter() - t0
            st0 = check_budget("7b builds")

            rng = np.random.default_rng(seed)
            popularity = rng.permutation(N_TENANTS)
            p = 1.0 / (1.0 + popularity) ** ZIPF_S
            trace = rng.choice(N_TENANTS, TRACE_LEN, p=p / p.sum())
            which = rng.integers(0, 4, TRACE_LEN)
            hot_s, cold_s = [], []
            for t, j in zip(trace, which):
                name = names[t]
                was_hot = svc.collection(name).residency == "hot"
                t0 = time.perf_counter()
                got = svc.query(name, queries[name][j:j + 1])
                (hot_s if was_hot else cold_s).append(
                    time.perf_counter() - t0)
                same_bits([got], [want[name][j]], f"7b {name} query {j}")
                st = check_budget(f"7b trace ({name})")
            out["7b"] = {
                "tenants": N_TENANTS, "state_bytes": nb,
                "budget_bytes": budget, "queries": TRACE_LEN,
                "hot_hits": len(hot_s), "cold_hits": len(cold_s),
                "hot_p50_ms": pct_ms(hot_s, 50), "hot_p99_ms": pct_ms(hot_s, 99),
                "cold_p50_ms": pct_ms(cold_s, 50),
                "cold_p99_ms": pct_ms(cold_s, 99),
                "promotions": st["promotions"] - st0["promotions"],
                "evictions": st["evictions"] - st0["evictions"],
                "over_budget_events": st["over_budget_events"],
                "device_bytes": st["device_bytes"],
                "host_bytes": st["host_bytes"],
                "peak_allocated_gib":
                    torch.cuda.max_memory_allocated() / 2**30}

            # -- 7c -----------------------------------------------------------
            hot = [n for n in names if svc.collection(n).residency == "hot"]
            if len(hot) != 8:
                raise AssertionError(f"7b left {len(hot)} tenants HOT, not 8")
            for name in hot[:2]:
                demote(svc, name, "warm")
            futs = [svc.submit(MemoryOp("query", n, queries[n][:1],
                                        batch=True)) for n in hot]
            n_disp = svc.flush()
            got = [f.result(timeout=600) for f in futs]
            if n_disp != 3:
                raise AssertionError(f"7c flushed as {n_disp} dispatches, "
                                     "not 3 (6 fused lanes + 2 singletons)")
            for n, (gi, gs) in zip(hot, got):
                wi, ws = want[n][0]
                if not np.array_equal(gi, wi) or \
                        not np.allclose(gs, ws, rtol=1e-5, atol=1e-5):
                    raise AssertionError(f"7c {n}: the answer differs")
            same_bits(got[:2], [want[n][0] for n in hot[:2]],
                      "7c singletons")
            st = check_budget("7c")
            out["7c"] = {"dispatches": n_disp,
                         "fused_bit_equal": all(
                             np.array_equal(g[1], want[n][0][1])
                             for n, g in zip(hot, got)),
                         "residency": {k: v for k, v in st.items()
                                       if k != "tiers"}}
        del svc, coll, queries, want, got, futs
        release()
    out["launches"] = {k: m.launches.value for k, m in kernels.items()}
    out["launches_by_variant"] = {
        k: {v: c.value for v, c in kernels[k].launches_by_variant.items()}
        for k in ("scan_scores", "scan_scores_q8", "kmeans_assign")}
    for k, n in out["launches"].items():
        if n <= 0:
            raise AssertionError(f"phase 7 never launched {k}")
    return out


# ---------------------------------------------------------------------------
# phase 8: recall-adaptive routing (the recall probe, the nprobe/ef tuners,
# the index policies, the derived HNSW graph tier) through MemoryService
# ---------------------------------------------------------------------------

PROBE_TARGET = 0.95     # 8a, 8c: the tuned tenants' target recall@k
PROBE_NPROBE0 = 4       # 8a: starting nprobe, lowered from 64 (a deviation
#                         from PAPER_1M) so that the tuner has to seek
MAX_PROBES = 12         # a tuner settles after two probes that leave its
#                         knob alone, or stops after this many
AUTO_FLAT_MAX = 2048    # 8c: the auto tenant's policy thresholds
AUTO_HNSW_MIN = 3072
# 8c: the hnsw tenant's rows, cut from PAPER_100K's 100,000: the host graph
# pays an O(N) np.concatenate and a per-node Python search for every row
# it adds (src/repro_torch/core/hnsw.py, a copy of the reference's), tens
# of milliseconds a row at d = 1024, and the auto tenant already builds
# one graph of AUTO_HNSW_MIN rows
HNSW_ROWS = 1000
HNSW2_ROWS = 300        # 8c, 8d: a second graph tenant of the same config
# the keys of a saved tuner (`RecallTuner.to_dict` in both packages)
TUNER_KEYS = {"target", "lo", "hi", "slack", "knob", "floor", "probes",
              "raises", "backoffs", "last_recall"}


def phase_routing(seed: int, card: str) -> dict:
    """Recall-adaptive routing on the card.  8a: a PAPER_1M f32 tenant and
    then an int8 one, target recall 0.95 from nprobe 4, probed through the
    service until the knob settles; the knob walk equals a fresh tuner fed
    the measured recalls, recall@k at the settled knob over 256 fresh live
    rows (the card oracle) is at least the target less the tuner's slack,
    and every such query's own row comes first.  8b: B=1 queries from a
    thread while the f32 tenant's probes retune it, and the maintenance
    poll's probe once 512 ops have passed: none fails, 99 % find their row.
    8c: PAPER_100K tenants under each policy: flat (every query a full
    scan), auto (flat -> ivf -> hnsw by inserts, the policy and the
    executed path agreeing at each step), hnsw (the probe tuning ef), and
    the graph's lifecycle (it mirrors an insert and a delete; a rebuild and
    a WARM demotion drop it, the next graph query rebuilds it; a probe on
    the demoted tenant is skipped).  8d: two PAPER_100K tenants at target
    0.80 and 0.99 probed until their knobs differ and a window over them
    and the two graph tenants (3 dispatches, every answer the sync one bit
    for bit); then the 8a f32 tenant saved and loaded with its knob."""
    import threading
    from repro_torch.api import MemoryOp, MemoryService
    from repro_torch.configs.ame_paper import PAPER_100K, PAPER_1M
    from repro_torch.core import metrics, templates
    from repro_torch.core.tuner import RecallTuner
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8
    from repro_torch.kernels import segsum_gemm as sg

    dev = torch.device("cuda")
    kernels = {"scan_scores": ss, "scan_scores_q8": q8, "kmeans_assign": ka,
               "segsum_gemm": sg}
    scans = ("scan_scores", "scan_scores_q8")
    for m in kernels.values():
        for c in (m.launches, *getattr(m, "launches_by_variant", {}).values(),
                  *getattr(m, "launches_by_lanes", {}).values()):
            c.reset()
    out = {"card": card, "deviations": [
        f"8a: PAPER_1M starts at nprobe {PROBE_NPROBE0}, not 64 (the router "
        "keeps PAPER_1M's thresholds)",
        f"8c: the hnsw tenant holds {HNSW_ROWS} rows and a second one "
        f"{HNSW2_ROWS}, not 100,000: the host graph's per-row add"]}

    def variants():
        return {k: {v: c.value for v, c in kernels[k].launches_by_variant.items()}
                for k in scans}

    def since(before):
        now = variants()
        return {k: {v: now[k][v] - before[k][v] for v in now[k]}
                for k in scans}

    def served(coll):
        """The path the probe measures: the policy's steady-state one."""
        return {"flat": "full_scan", "hnsw": "hnsw"}.get(
            coll.index_policy(), "probed")

    def knob_of(coll, path):
        return coll.tuned_ef() if path == "hnsw" else coll.tuned_nprobe()

    def settle(svc, name, what):
        """Probe ops until two in a row leave the knob alone (or
        MAX_PROBES): per probe the knob before and after, the recall, the
        wall ms and the scan launches by variant."""
        coll = svc.collection(name)
        log, still = [], 0
        for _ in range(MAX_PROBES):
            path = served(coll)
            before, v0 = knob_of(coll, path), variants()
            t0 = time.perf_counter()
            r = svc.submit(MemoryOp("probe", name)).result(timeout=900)
            ms = 1e3 * (time.perf_counter() - t0)
            if r["recall"] is None or r["path"] != path:
                raise AssertionError(f"{what}: probe {r} on path {path}")
            # scans by variant while the probe ran (queries running beside
            # it, at the same knob, count too)
            e = {"path": r["path"], "before": before, "after": r["knob"],
                 "recall": r["recall"], "ms": ms, "sample": r["sample"],
                 "launches_by_variant": since(v0)}
            if path == "probed":
                e["slab_rows"] = before * coll.cfg.list_capacity \
                    + coll.spill_capacity
            log.append(e)
            print(f"  {what} probe {len(log)}: {path} knob {before} -> "
                  f"{r['knob']} recall {r['recall']:.4f} {ms:.1f} ms "
                  f"{e['launches_by_variant']} [{card}]", flush=True)
            still = 0 if r["retuned"] else still + 1
            if still == 2:
                break
        return log

    def replay(log, tuner, what):
        """The knob walk equals a fresh port tuner fed the same recalls."""
        for e in log:
            if tuner.knob != e["before"] or \
                    tuner.observe(e["recall"]) != e["after"]:
                raise AssertionError(f"{what}: the knob walk {log} is not "
                                     "a fresh tuner's")

    def nprobe_tuner(cfg):
        return RecallTuner(cfg.target_recall,
                           max(1, min(cfg.nprobe, cfg.n_clusters)), 1,
                           cfg.n_clusters)

    def ef_tuner(cfg):
        lo, hi = max(1, cfg.k), max(1024, 8 * max(cfg.hnsw_ef, cfg.k))
        return RecallTuner(cfg.target_recall, min(max(cfg.hnsw_ef, lo), hi),
                           lo, hi)

    def fresh_recall(svc, name, rows, g, what, n=256, own_first=True):
        """recall@k of the served path at the tuned knob over n live rows
        drawn apart from the probes' samples, against the oracle on the
        card, and the share of queries whose own row comes first (all of
        them must, on the probed path)."""
        coll = svc.collection(name)
        sel = torch.randperm(rows.shape[0], generator=g, device=dev)[:n]
        qs = rows[sel]
        truth = metrics.brute_force_topk(
            qs, rows, torch.arange(rows.shape[0], device=dev), coll.cfg.k,
            coll.cfg.metric, device=dev)
        got, _ = svc.query(name, qs, path=served(coll))
        rec = metrics.recall_at_k(got, truth)
        own = float(np.mean(got[:, 0] == sel.cpu().numpy()))
        if rec < coll.cfg.target_recall - 0.03 or (own_first and own < 1.0):
            raise AssertionError(f"{what}: recall@{coll.cfg.k} {rec:.4f} at "
                                 f"the tuned knob, own row first on {own}")
        return rec, own

    def p50_ms(svc, name, rows, g, nprobe=None, reps=50):
        lat = []
        for i in range(reps + 3):
            t = torch.randint(0, rows.shape[0], (1,), generator=g,
                              device=dev)
            q = perturb(rows[t], g)
            t0 = time.perf_counter()
            svc.query(name, q, nprobe=nprobe)
            if i >= 3:
                lat.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(lat))

    # -- 8a, 8b -----------------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(seed + 80)
    x = make_corpus(N_ROWS, PAPER_1M.dim, g)
    ids = np.arange(N_ROWS, dtype=np.int32)
    th_1m = templates.TemplateThresholds.from_profile(PAPER_1M)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_routing_") as saved:
        # the daemon poll never runs (an hour between polls): 8b calls
        # poll_once itself, so that no probe lands between 8a's
        with MemoryService(maintenance_poll_interval_s=3600.0) as svc:
            for store in ("float32", "int8"):
                name = f"p{store}"
                cfg = dataclasses.replace(
                    PAPER_1M, store_dtype=store, nprobe=PROBE_NPROBE0,
                    target_recall=PROBE_TARGET)
                coll = svc.create_collection(name, cfg, seed=seed + 80,
                                             thresholds=th_1m)
                t0 = time.perf_counter()
                svc.build(name, x, ids=ids)
                rec = {"build_s": time.perf_counter() - t0}
                stop, errors, hits = threading.Event(), [], [0, 0]

                def serve():
                    rng = np.random.default_rng(seed + 81)
                    while not stop.is_set():
                        i = int(rng.integers(N_ROWS))
                        try:
                            got, _ = svc.query(name, x[i:i + 1])
                        except Exception as e:   # noqa: BLE001 — counted
                            errors.append(e)
                            return
                        hits[0] += int(got[0, 0] == i)
                        hits[1] += 1

                thread = threading.Thread(target=serve)
                if store == "float32":           # 8b: queries while tuning
                    thread.start()
                try:
                    v0 = variants()
                    rec["probes"] = settle(svc, name, f"8a {store}")
                    rec["launches_by_variant"] = since(v0)
                    if store == "float32":
                        # 8b: the poll schedules a probe once 512 ops passed
                        t0 = time.perf_counter()
                        while not coll.recall_probe_due():
                            if time.perf_counter() - t0 > 300:
                                raise AssertionError("8b: 512 ops never "
                                                     "passed")
                            time.sleep(0.01)
                        seq = coll.stats()["last_probe"]["seq"]
                        before = coll.tuned_nprobe()
                        if svc.maintenance.poll_once() < 1:
                            raise AssertionError("8b: the poll scheduled "
                                                 "nothing")
                        while coll.stats()["last_probe"]["seq"] == seq:
                            if time.perf_counter() - t0 > 600:
                                raise AssertionError("8b: the polled probe "
                                                     "never ran")
                            time.sleep(0.01)
                        # the polled probe is one more step of the walk
                        polled = coll.stats()["last_probe"]
                        rec["probes"].append({
                            "path": polled["path"], "before": before,
                            "after": polled["knob"],
                            "recall": polled["recall"], "polled": True})
                finally:
                    stop.set()
                    if thread.is_alive():
                        thread.join(timeout=600)
                if thread.is_alive():
                    raise AssertionError("8b: the query thread hung")
                if store == "float32":
                    maint = svc.stats()["maintenance"]
                    self_hit = hits[0] / max(1, hits[1])
                    if errors or maint["probes_triggered"] < 1 or \
                            self_hit < 0.99:
                        raise AssertionError(
                            f"8b: {len(errors)} failed queries "
                            f"{errors[:1]}, {maint['probes_triggered']} "
                            f"polled probes, self-hit {self_hit:.4f}")
                    out["8b"] = {"queries": hits[1], "self_hit": self_hit,
                                 "failed": len(errors),
                                 "probes_triggered":
                                     maint["probes_triggered"],
                                 "polled_probe": coll.stats()["last_probe"]}
                replay(rec["probes"], nprobe_tuner(cfg), f"8a {store}")
                n_scan = sum(sum(v.values()) for v in
                             rec["launches_by_variant"].values())
                if n_scan <= 0 or (store == "int8" and sum(
                        rec["launches_by_variant"]["scan_scores_q8"]
                        .values()) <= 0):
                    raise AssertionError(f"8a {store}: the probes launched "
                                         f"no scan {rec}")
                rec["settled_nprobe"] = coll.tuned_nprobe()
                rec["recall_at_knob"], rec["own_row_first"] = fresh_recall(
                    svc, name, x, g, f"8a {store}")
                rec["p50_ms_nprobe64"] = p50_ms(svc, name, x, g, nprobe=64)
                rec["p50_ms_settled"] = p50_ms(svc, name, x, g)
                out[f"8a_{store}"] = rec
                print(f"  8a {store}: settled nprobe "
                      f"{rec['settled_nprobe']} recall@{cfg.k} "
                      f"{rec['recall_at_knob']:.4f}, B=1 probed p50 "
                      f"{rec['p50_ms_nprobe64']:.3f} ms at 64, "
                      f"{rec['p50_ms_settled']:.3f} ms settled [{card}]",
                      flush=True)
            out["8a_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            # 8d (second half): the f32 tenant saved and loaded
            svc.drop_collection("pint8")
            coll = svc.collection("pfloat32")
            knob, stats = coll.tuned_nprobe(), coll.stats()
            svc.save(saved)
        del svc, coll
        release()
        with open(os.path.join(saved, "collections", "pfloat32",
                               "collection.json")) as f:
            meta = json.load(f)
        if set(meta.get("tuners", {})) != {"nprobe", "ef"} or any(
                set(t) != TUNER_KEYS for t in meta["tuners"].values()) or \
                meta.get("probe_seq") != stats["last_probe"]["seq"] + 1:
            raise AssertionError(f"8d: saved metadata {meta}")
        with MemoryService.load(saved, maintenance=False) as back:
            bc = back.collection("pfloat32")
            if bc.tuned_nprobe() != knob or \
                    bc.stats()["tuner"] != stats["tuner"]:
                raise AssertionError("8d: the loaded tenant lost its knob")
        out["8d_save_load"] = {"nprobe": knob,
                               "probe_seq": meta["probe_seq"]}
    del x, back, bc
    release()

    # -- 8c, 8d -----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    with MemoryService(batch_window=64, maintenance=False) as svc:
        def corpus(i, n):
            gi = torch.Generator(device=dev).manual_seed(seed + 90 + i)
            return make_corpus(n, PAPER_100K.dim, gi), gi

        def launched(fn):
            n0 = ss.launches.value
            r = fn()
            return r, ss.launches.value - n0

        def same(a, b, what):
            if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
                raise AssertionError(f"{what}: the answers differ")

        # flat: every query is a full scan
        cfg = dataclasses.replace(PAPER_100K, index_policy="flat")
        svc.create_collection("flat", cfg, seed=seed + 90)
        xf, gf = corpus(0, TENANT_ROWS)
        svc.build("flat", xf, ids=np.arange(TENANT_ROWS))
        coll = svc.collection("flat")
        for b in (1, 4, 64):
            q = perturb(xf[:b], gf)
            if coll.resolve_query(b, None, None, None)[2] != "full_scan":
                raise AssertionError("8c flat: not routed to the full scan")
            got, n = launched(lambda: svc.query("flat", q))
            same(got, svc.query("flat", q, path="full_scan"), "8c flat")
            if n != 1 or not np.array_equal(got[0][:, 0], np.arange(b)):
                raise AssertionError(f"8c flat: {n} scans for B={b}")
        out["8c_flat"] = {"rows": TENANT_ROWS, "full_scans": True}
        del xf

        # auto: flat -> ivf -> hnsw as inserts grow it
        cfg = dataclasses.replace(PAPER_100K, index_policy="auto")
        # the constructor's full_scan_batch (32) keeps B=1 on the probed
        # path under "ivf" (PAPER_100K's profile would give 1)
        th = templates.TemplateThresholds(flat_max_rows=AUTO_FLAT_MAX,
                                          hnsw_min_rows=AUTO_HNSW_MIN)
        coll = svc.create_collection("auto", cfg, seed=seed + 91,
                                     thresholds=th)
        xa, ga = corpus(1, AUTO_HNSW_MIN)
        steps = []
        for lo, hi, policy, path, n_scans in (
                (0, AUTO_FLAT_MAX * 3 // 4, "flat", "full_scan", 1),
                (AUTO_FLAT_MAX * 3 // 4, (AUTO_FLAT_MAX + AUTO_HNSW_MIN) // 2,
                 "ivf", "probed", 2),
                ((AUTO_FLAT_MAX + AUTO_HNSW_MIN) // 2, AUTO_HNSW_MIN,
                 "hnsw", "hnsw", 0)):
            op = svc.build if lo == 0 else svc.insert
            op("auto", xa[lo:hi], ids=np.arange(lo, hi))
            q = xa[lo:lo + 1]
            t0 = time.perf_counter()
            got, n = launched(lambda: svc.query("auto", q))
            wall = time.perf_counter() - t0
            if coll.index_policy() != policy or n != n_scans or \
                    coll.resolve_query(1, None, None, None)[2] != path or \
                    int(got[0][0, 0]) != lo:
                raise AssertionError(
                    f"8c auto at {hi} rows: policy {coll.index_policy()}, "
                    f"{n} scans, first id {got[0][0, 0]}; want {policy} "
                    f"({path}, {n_scans} scans)")
            same(got, svc.query("auto", q, path=path), f"8c auto {policy}")
            steps.append({"rows": hi, "policy": policy, "path": path,
                          "scans": n, "first_query_s": wall})
        out["8c_auto"] = {"thresholds": [AUTO_FLAT_MAX, AUTO_HNSW_MIN],
                          "steps": steps,
                          "graph_build_s_host": steps[-1]["first_query_s"]}
        del xa

        # hnsw: the probe tunes ef
        cfg_h = dataclasses.replace(PAPER_100K, index_policy="hnsw",
                                    target_recall=PROBE_TARGET)
        coll = svc.create_collection("h", cfg_h, seed=seed + 92)
        xh, gh = corpus(2, HNSW_ROWS)
        svc.build("h", xh, ids=np.arange(HNSW_ROWS))
        t0 = time.perf_counter()
        svc.query("h", xh[:1])                   # builds the graph
        first = time.perf_counter() - t0
        lat = []
        for i in range(20):
            q = perturb(xh[i + 1:i + 2], gh)
            t0 = time.perf_counter()
            got = svc.query("h", q)
            lat.append(time.perf_counter() - t0)
        rec = {"rows": HNSW_ROWS,
               "graph_build_s_host": first - float(np.median(lat)),
               "query_ms_host_ef_default": 1e3 * float(np.median(lat))}
        rec["probes"] = settle(svc, "h", "8c hnsw")
        replay(rec["probes"], ef_tuner(cfg_h), "8c hnsw")
        rec["settled_ef"] = coll.tuned_ef()
        rec["recall_at_ef"], rec["own_row_first"] = fresh_recall(
            svc, "h", xh, gh, "8c hnsw", own_first=False)
        lat = []
        for i in range(20):
            q = perturb(xh[i + 1:i + 2], gh)
            t0 = time.perf_counter()
            svc.query("h", q)
            lat.append(time.perf_counter() - t0)
        rec["query_ms_host_settled"] = 1e3 * float(np.median(lat))
        out["8c_hnsw"] = rec
        print(f"  8c hnsw: graph build {rec['graph_build_s_host']:.1f} s "
              f"(host), settled ef {rec['settled_ef']} recall "
              f"{rec['recall_at_ef']:.4f}, query "
              f"{rec['query_ms_host_settled']:.2f} ms (host)", flush=True)

        # the graph's lifecycle on a second graph tenant of the same config
        c2 = svc.create_collection("h2", cfg_h, seed=seed + 93)
        x2, g2 = corpus(3, HNSW2_ROWS + 16)
        svc.build("h2", x2[:HNSW2_ROWS], ids=np.arange(HNSW2_ROWS))
        svc.query("h2", x2[:1])

        def graph_matches(what):
            st = c2.snapshot()
            slots = torch.cat([st.list_ids.reshape(-1), st.spill_ids])
            live = set(slots[slots >= 0].tolist())
            if c2._graph is None or \
                    set(c2._graph.live_ids().tolist()) != live:
                raise AssertionError(f"8c graph {what}: the graph's ids "
                                     "are not the index's")

        new = np.arange(HNSW2_ROWS, HNSW2_ROWS + 16)
        svc.insert("h2", x2[HNSW2_ROWS:], ids=new)
        graph_matches("after an insert")
        got, _ = svc.query("h2", x2[HNSW2_ROWS:])
        if not np.array_equal(got[:, 0], new):
            raise AssertionError("8c graph: an inserted row is not found")
        gone = np.concatenate([new[:8], np.arange(8)])
        svc.delete("h2", gone)
        graph_matches("after a delete")
        probes_q = torch.cat([x2[HNSW2_ROWS:HNSW2_ROWS + 8], x2[:8]])

        def no_deleted(what):
            got, _ = svc.query("h2", probes_q)
            if np.isin(got, gone).any():
                raise AssertionError(f"8c graph {what}: a deleted id came "
                                     "back")

        no_deleted("after a delete")
        t0 = time.perf_counter()
        svc.demote("h2", "warm")
        dropped_by_demotion = c2._graph is None
        skipped = svc.submit(MemoryOp("probe", "h2")).result(timeout=60)
        no_deleted("after a promotion")
        graph_matches("after a promotion")
        r = svc.rebuild("h2")
        dropped_by_rebuild = c2._graph is None
        no_deleted("after a rebuild")
        graph_matches("after a rebuild")
        if not (dropped_by_demotion and dropped_by_rebuild) or \
                skipped != {"skipped": "warm", "recall": None} or \
                r["aborted"]:
            raise AssertionError(f"8c graph: demotion dropped it "
                                 f"{dropped_by_demotion}, rebuild "
                                 f"{dropped_by_rebuild}, probe {skipped}")
        out["8c_graph_lifecycle"] = {
            "rows": HNSW2_ROWS, "inserted": 16, "deleted": len(gone),
            "dropped_by_demotion": dropped_by_demotion,
            "dropped_by_rebuild": dropped_by_rebuild,
            "probe_when_warm": skipped,
            "s_host": time.perf_counter() - t0}

        # 8d: two probed tenants tuned apart, one window with the graphs
        for i, target in enumerate((0.80, 0.99)):
            name = f"t{int(target * 100)}"
            svc.create_collection(
                name, dataclasses.replace(PAPER_100K, target_recall=target),
                seed=seed + 94 + i)
            xt, _ = corpus(4 + i, TENANT_ROWS)
            svc.build(name, xt, ids=np.arange(TENANT_ROWS))
            del xt
        knobs = []
        for _ in range(MAX_PROBES):
            for name in ("t80", "t99"):
                svc.submit(MemoryOp("probe", name)).result(timeout=600)
            knobs.append([svc.collection(n).tuned_nprobe()
                          for n in ("t80", "t99")])
            if knobs[-1][0] != knobs[-1][1]:
                break
        sig = [svc.collection(n).batch_signature(1, None, None, "probed")
               for n in ("t80", "t99")]
        if sig[0][5] == sig[1][5]:
            raise AssertionError(f"8d: the knobs never differed {knobs}")
        gq = torch.Generator(device=dev).manual_seed(seed + 99)
        reqs = []
        for name in ("t80", "t80", "t99", "t99"):
            reqs.append((name, torch.nn.functional.normalize(
                torch.randn(1, PAPER_100K.dim, generator=gq, device=dev),
                dim=1), "probed"))
        reqs += [("h", perturb(xh[:1], gh), None),
                 ("h2", perturb(x2[20:21], g2), None)]
        futs = [svc.submit(MemoryOp("query", n, q, path=p, batch=True))
                for n, q, p in reqs]
        n_disp = svc.flush()
        got = [f.result(timeout=600) for f in futs]
        for (n, q, p), a in zip(reqs, got):
            same(a, svc.query(n, q, path=p), f"8d {n}")
        if n_disp != 3:
            raise AssertionError(f"8d: the window flushed as {n_disp} "
                                 "dispatches, not 3")
        out["8d_window"] = {"knobs": knobs, "dispatches": n_disp,
                            "nprobe": [s[5] for s in sig],
                            "bit_equal": True}
    out["8cd_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del svc, coll, c2, xh, x2
    release()
    out["launches"] = {k: m.launches.value for k, m in kernels.items()}
    out["launches_by_variant"] = {
        k: {v: c.value for v, c in kernels[k].launches_by_variant.items()}
        for k in ("scan_scores", "scan_scores_q8", "kmeans_assign")}
    for k, n in out["launches"].items():
        if n <= 0:
            raise AssertionError(f"phase 8 never launched {k}")
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 9: replication (shipping log, replica apply, failover, shedding)
# ---------------------------------------------------------------------------

REPL_INSERTS = 8        # 9a: 1024-row inserts under queries, pumps between
REPL_DELETES = 10_000   # 9a: corpus ids deleted after the inserts
GRAPH_ROWS = 300        # 9e: the hnsw tenant (the host graph's per-row add)


class ScriptedFaults:
    """A fault plan for `ReplicaSet.pump`: `ship` maps (replica, first seq
    of a shipped batch) to "drop" / "delay" / "duplicate", `kill_at` maps
    a replica to the seq whose apply kills it; each fires once."""

    def __init__(self):
        self.ship, self.kill_at, self.fired = {}, {}, []

    def on_ship(self, replica, collection, entries):
        verdict = self.ship.pop((replica, entries[0].seq), "ok")
        if verdict != "ok":
            self.fired.append((replica, entries[0].seq, verdict))
        return verdict

    def on_apply(self, replica, collection, entry):
        from repro_torch.api.replication import ReplicaDead
        if self.kill_at.get(replica) == entry.seq:
            del self.kill_at[replica]
            self.fired.append((replica, entry.seq, "kill"))
            raise ReplicaDead(f"{replica} killed applying seq {entry.seq}")


def same_leaves(a, b, what) -> None:
    """Every IVFState leaf of `a` equal to `b`'s, bit for bit."""
    for f, x, y in zip(a._fields, a, b):
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{what}: leaf {f} differs")


def phase_replication(seed: int, card: str, build_s_phase4: float) -> dict:
    """Replication on the card.  9a: a ReplicaSet of two replicas over a
    fresh service, created before phase 4's 1,000,000-row PAPER_1M build;
    the build ships and both replicas catch up leaf for leaf; 8 x 1024-row
    inserts and a 10,000-id delete with pumps between, while one thread
    queries the replicas and another the primary (none fails, 99 % find
    their row first); afterwards every leaf and the probed B=1 and full
    scan B=64 answers are equal across the three services; insert rows/s
    with the ship hook and without, in turns on one collection.  9b:
    scripted drop, delay and duplicate on 9a's set (lag, never loss); the
    primary killed with writes pending after `pump(max_batches=1)` (a
    write raises PrimaryDead, `failover` replays them, every acknowledged
    id is live on the promoted primary, which equals the dead one leaf for
    leaf); a new insert ships to the survivor, which ends bit-equal; then
    the survivor killed mid-apply keeps its pre-batch leaves and
    watermark.  9c/9d: a fresh PAPER_100K set whose primary has admission
    control: a wedged primary raises Overloaded and `rs.query` sheds to a
    replica; a planned failover replays nothing, and a new insert ships to
    the survivor.  9e: a PAPER_1M int8 set (codes and scales bit-equal
    after build, churn, pump) and a PAPER_100K hnsw tenant of 300 rows
    whose replica graph mirrors shipped inserts and deletes."""
    import threading
    from repro_torch.api import (AdmissionControl, MemoryService, Overloaded,
                                 ReplicaSet)
    from repro_torch.api.replication import PrimaryDead, ShippingLog
    from repro_torch.configs.ame_paper import PAPER_100K, PAPER_1M
    from repro_torch.core.scheduler import Task
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8
    from repro_torch.kernels import segsum_gemm as sg

    dev = torch.device("cuda")
    kernels = {"scan_scores": ss, "scan_scores_q8": q8, "kmeans_assign": ka,
               "segsum_gemm": sg}
    for m in kernels.values():
        for c in (m.launches, *getattr(m, "launches_by_variant", {}).values(),
                  *getattr(m, "launches_by_lanes", {}).values()):
            c.reset()
    out = {"card": card, "deviations": [
        "the primaries run without background maintenance: a rebuild is "
        "not shipped, so a primary rebuild would end the replicas' "
        "leaf-for-leaf equality (their live sets stay equal)",
        "9c/9d run on PAPER_100K (100,000 rows), 9e's graph tenant on "
        f"{GRAPH_ROWS} rows: the host graph's per-row add"]}
    n, d = N_ROWS, PAPER_1M.dim
    g = torch.Generator(device=dev).manual_seed(seed + 1)   # phase 4's corpus
    x = make_corpus(n, d, g)
    live = np.zeros(n + 200_000, dtype=bool)
    live[:n] = True
    gone = np.random.default_rng(seed).choice(n, REPL_DELETES, replace=False)
    keep = np.setdiff1d(np.arange(n), gone)                 # query targets
    next_id = n

    def fresh(b, dim=d, gen=g):
        nonlocal next_id
        rows = torch.nn.functional.normalize(
            torch.randn(b, dim, generator=gen, device=dev), dim=1)
        ids = np.arange(next_id, next_id + b, dtype=np.int32)
        next_id += b
        return rows, ids

    def check_live(svc, name, what):
        st = svc.collection(name).snapshot()
        ids = torch.cat([st.list_ids.reshape(-1), st.spill_ids])
        got = torch.sort(ids[ids >= 0]).values
        want = torch.from_numpy(np.nonzero(live)[0].astype(np.int32)).to(dev)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {got.numel()} live ids vs "
                                 f"{want.numel()} acknowledged")

    def all_equal(rs, name, what):
        prim = rs.primary.collection(name).snapshot()
        for rep in rs.replicas:
            if rep.alive:
                same_leaves(rep.service.collection(name).snapshot(), prim,
                            f"{what}: {rep.name}")

    def timed_ship(coll, into):
        """Time the collection's `_ship` of each hooked insert."""
        orig = coll._ship

        def ship(*args):
            t0 = time.perf_counter()
            orig(*args)
            if args[0] == "insert" and coll._ship_hook is not None:
                into.append(1e3 * (time.perf_counter() - t0))
        coll._ship = ship

    torch.cuda.reset_peak_memory_stats()
    # -- 9a ---------------------------------------------------------------
    t_a = time.perf_counter()
    svc = MemoryService(maintenance=False)
    faults = ScriptedFaults()
    rs = ReplicaSet(svc, n_replicas=2, ship_batch=64, fault_injector=faults)
    if svc.device.type != "cuda" or any(
            r.service.device != svc.device for r in rs.replicas):
        raise AssertionError("a replica is not on the primary's card")
    prim = rs.create_collection("mem", PAPER_1M, seed=seed)
    ship_ms = []
    timed_ship(prim, ship_ms)
    t0 = time.perf_counter()
    rs.build("mem", x, ids=np.arange(n, dtype=np.int32))
    a = {"build_ack_s": time.perf_counter() - t0,
         "phase4_build_s": build_s_phase4}
    entry = rs._logs["mem"].tail(0)[0]
    a["build_entry_gb"] = (entry.rows.nbytes + entry.ids.nbytes) / 1e9
    del entry
    t0 = time.perf_counter()
    rs.pump()
    a["pump_s"] = time.perf_counter() - t0
    a["catch_up_s"] = {r.name: r.monitor.durations[-1] for r in rs.replicas}
    all_equal(rs, "mem", "9a after the build")
    check_live(svc, "mem", "9a build")

    def query_loop(prefer, stop, res):
        qg = torch.Generator(device=dev).manual_seed(
            seed + (11 if prefer == "replica" else 12))
        while not stop.is_set() or res["n"] < 64:
            t = int(keep[torch.randint(0, len(keep), (1,), generator=qg,
                                       device=dev).item()])
            q = perturb(x[t:t + 1], qg)
            try:
                ids, _ = rs.query("mem", q, prefer=prefer)
                res["hits"] += int(ids[0, 0] == t)
            except Exception as e:   # noqa: BLE001 — counted, raised below
                res["failed"].append(repr(e))
            res["n"] += 1

    stop = threading.Event()
    res = {p: {"n": 0, "hits": 0, "failed": []}
           for p in ("replica", "primary")}
    threads = [threading.Thread(target=query_loop, args=(p, stop, res[p]))
               for p in res]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    try:
        for _ in range(REPL_INSERTS):
            rows, ids = fresh(1024)
            rs.insert("mem", rows, ids=ids)
            live[ids] = True
            rs.pump()
        rs.delete("mem", gone.astype(np.int32))
        live[gone] = False
        rs.pump()
    finally:
        stop.set()
        for th in threads:
            th.join()
    a["churn_s"] = time.perf_counter() - t0
    for p, r in res.items():
        if r["failed"]:
            raise AssertionError(f"9a: {len(r['failed'])} {p} queries "
                                 f"failed: {r['failed'][:3]}")
        a[f"{p}_queries"] = r["n"]
        a[f"{p}_self_hit"] = r["hits"] / r["n"]
        if r["hits"] < 0.99 * r["n"]:
            raise AssertionError(f"9a: {p} queries found their row first on "
                                 f"{r['hits']} of {r['n']}")
    all_equal(rs, "mem", "9a after the churn")
    for s in [svc] + [r.service for r in rs.replicas]:
        check_live(s, "mem", "9a churn")
    gq = torch.Generator(device=dev).manual_seed(seed + 13)
    q64 = perturb(x[torch.from_numpy(keep[:64]).to(dev)], gq)
    if prim.resolve_query(1, None, None, None)[2] != "probed" or \
            prim.resolve_query(64, None, None, None)[2] != "full_scan":
        raise AssertionError("9a: PAPER_1M routing changed")
    want = [svc.query("mem", q64[:1]), svc.query("mem", q64)]
    for rep in rs.replicas:
        got = [rep.service.query("mem", q64[:1]),
               rep.service.query("mem", q64)]
        for (gi, gs), (wi, ws) in zip(got, want):
            if not (np.array_equal(gi, wi) and np.array_equal(gs, ws)):
                raise AssertionError(f"9a: {rep.name} answers differ")
    st = rs.stats()
    a["log_retained"] = st["log_retained"]["mem"]
    a["apply_s"] = {r: st["replicas"][r]["straggler"] for r in st["replicas"]}
    if a["log_retained"] != 0 or any(st["lag"]["mem"].values()):
        raise AssertionError(f"9a: replicas not caught up: {st['lag']}")
    a["ship_ms_per_insert"] = {"p50": float(np.median(ship_ms)),
                               "max": max(ship_ms), "n": len(ship_ms)}

    # insert rows/s with and without the ship hook, in turns on one
    # collection (not replicated, so the unhooked writes lose nothing)
    tcoll = svc.create_collection("turns", PAPER_1M, seed=seed + 1)
    svc.build("turns", x, ids=np.arange(n, dtype=np.int32))
    turn_log = ShippingLog("turns")
    turn_ship = []
    timed_ship(tcoll, turn_ship)
    turns = {"hooked": [], "unhooked": []}
    tg = torch.Generator(device=dev).manual_seed(seed + 14)
    tid = 2 * n
    for arm in ("hooked", "unhooked", "unhooked", "hooked"):
        tcoll.set_ship_hook(turn_log.append if arm == "hooked" else None)
        batches = [torch.nn.functional.normalize(
            torch.randn(1024, d, generator=tg, device=dev), dim=1)
            for _ in range(REPL_INSERTS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rows in batches:
            svc.insert("turns", rows, ids=np.arange(tid, tid + 1024))
            tid += 1024
        turns[arm].append(REPL_INSERTS * 1024 / (time.perf_counter() - t0))
    if turn_log.retained() != 2 * REPL_INSERTS:
        raise AssertionError("9a: the hooked turns did not ship every insert")
    a["insert_rows_per_s"] = turns
    a["turn_ship_ms_p50"] = float(np.median(turn_ship))
    svc.drop_collection("turns")
    del tcoll, turn_log, batches
    release()
    a["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    a["s"] = time.perf_counter() - t_a
    out["9a"] = a
    print(f"  9a ship+parity [{card}]: build ack {a['build_ack_s']:.3f} s "
          f"(phase 4 build {build_s_phase4:.3f} s), entry "
          f"{a['build_entry_gb']:.3f} GB, catch-up "
          + ", ".join(f"{k} {v:.3f} s" for k, v in a["catch_up_s"].items())
          + f"; _ship {a['ship_ms_per_insert']['p50']:.3f} ms/insert; rows/s "
          f"hooked {turns['hooked']} unhooked {turns['unhooked']}; queries "
          f"{a['replica_queries']} replica / {a['primary_queries']} primary; "
          f"peak {a['peak_gib']:.1f} GiB", flush=True)

    # -- 9b ---------------------------------------------------------------
    t_b = time.perf_counter()
    b = {}
    log = rs._logs["mem"]

    def insert_batch():
        rows, ids = fresh(1024)
        rs.insert("mem", rows, ids=ids)
        live[ids] = True

    s0 = log.last_seq()
    faults.ship = {("replica-0", s0 + 1): "drop",
                   ("replica-1", s0 + 1): "duplicate"}
    insert_batch()
    rs.pump()
    lag1 = dict(rs.lag("mem")["mem"])
    faults.ship = {("replica-1", s0 + 2): "delay"}
    insert_batch()
    rs.pump()
    lag2 = dict(rs.lag("mem")["mem"])
    rs.pump()
    if lag1 != {"replica-0": 1, "replica-1": 0} or \
            lag2 != {"replica-0": 0, "replica-1": 1}:
        raise AssertionError(f"9b: lag after drop {lag1}, after delay {lag2}")
    counts = rs.stats()["fault_counts"]
    if (counts["drop"], counts["delay"], counts["duplicate"]) != (1, 1, 1):
        raise AssertionError(f"9b: fault counts {counts}")
    all_equal(rs, "mem", "9b after drop/delay/duplicate")
    b["lag_after_drop"], b["lag_after_delay"] = lag1, lag2

    # the primary dies with writes pending, replica-1 behind by a delay
    for _ in range(2):
        insert_batch()
    faults.ship = {("replica-1", log.last_seq() - 1): "delay"}
    rs.pump(max_batches=1)
    pending = 2
    for _ in range(pending):
        insert_batch()
    old = rs.primary
    rs.kill_primary()
    try:
        rs.insert("mem", fresh(8)[0])
    except PrimaryDead:
        pass
    else:
        raise AssertionError("9b: a write reached a dead primary")
    fo = rs.failover()
    if fo["replayed"] != pending or fo["promoted"] != "replica-0":
        raise AssertionError(f"9b: failover {fo}")
    same_leaves(rs.primary.collection("mem").snapshot(),
                old.collection("mem").snapshot(),
                "9b: the promoted primary against the dead one")
    check_live(rs.primary, "mem", "9b failover")
    old.shutdown()
    del old
    release()
    b["failover"] = fo
    insert_batch()                      # ships to the survivor (replica-1)
    rs.pump()
    (surv,) = [r for r in rs.replicas if r.alive]
    all_equal(rs, "mem", "9b survivor")
    check_live(surv.service, "mem", "9b survivor")
    # the survivor killed mid-apply keeps its pre-batch leaves and watermark
    mark = surv.watermark("mem")
    scoll = surv.service.collection("mem")
    snap = scoll.snapshot()
    kept = [None if t is None else t.clone() for t in snap]
    for _ in range(2):
        insert_batch()
    faults.kill_at = {surv.name: mark + 2}
    rs.pump()
    if surv.alive or surv.watermark("mem") != mark or \
            rs.stats()["fault_counts"]["kill"] != 1:
        raise AssertionError("9b: the kill mid-apply was not atomic")
    same_leaves(scoll.snapshot(), snap._make(kept), "9b killed replica")
    del kept, snap
    b["killed"] = {"replica": surv.name, "watermark": mark}
    b["fault_counts"] = rs.stats()["fault_counts"]
    b["s"] = time.perf_counter() - t_b
    out["9b"] = b
    print(f"  9b faults [{card}]: {b['fault_counts']}, failover "
          f"{fo['failover_ms']:.3f} ms replayed {fo['replayed']} "
          f"(promoted {fo['promoted']}), survivor bit-equal, "
          f"{surv.name} killed mid-apply atomically", flush=True)
    rs.shutdown()
    del rs, svc, prim, scoll, surv, x
    release()

    # -- 9c, 9d -----------------------------------------------------------
    t_c = time.perf_counter()
    adm = AdmissionControl(max_queue_depth=2, max_queue_wait_s=None)
    svc = MemoryService(maintenance=False, admission=adm)
    rs = ReplicaSet(svc, n_replicas=2, ship_batch=64)
    rs.create_collection("t", PAPER_100K, seed=seed + 2)
    g2 = torch.Generator(device=dev).manual_seed(seed + 15)
    xt = make_corpus(100_000, PAPER_100K.dim, g2)
    rs.build("t", xt, ids=np.arange(100_000))
    for _ in range(3):
        rs.insert("t", fresh(1024, gen=g2)[0])
    rs.delete("t", np.arange(0, 5000, 2))
    rs.pump()
    all_equal(rs, "t", "9c after churn")
    # 9d: wedge every worker and fill both query queues to the limit
    gate = threading.Event()

    def wedge(started):
        started.set()
        gate.wait()

    sched = svc.scheduler
    try:
        for backend in ("background", "throughput", "latency"):
            started = threading.Event()
            sched.submit(Task(fn=lambda ev=started: wedge(ev), kind="query",
                              backend=backend))
            if not started.wait(timeout=30):
                raise AssertionError(f"9d: the {backend} wedge never ran")
        for backend in ("latency", "throughput"):
            for _ in range(adm.max_queue_depth):
                sched.submit(Task(fn=lambda: None, kind="query",
                                  backend=backend))
        qs = perturb(xt[10:12], g2)
        try:
            svc.query("t", qs)
        except Overloaded:
            pass
        else:
            raise AssertionError("9d: the wedged primary admitted a query")
        got = rs.query("t", qs)
        picked = rs._pick_replica("t")
        own = picked.service.query("t", qs)
    finally:
        gate.set()
    if not (np.array_equal(got[0], own[0]) and np.array_equal(got[1], own[1])):
        raise AssertionError("9d: the shed answer is not the replica's own")
    if rs.stats()["shed_to_replica"] != 1:
        raise AssertionError(f"9d: shed {rs.stats()['shed_to_replica']}")
    out["9d"] = {"shed_to_replica": 1, "answered_by": picked.name,
                 "same_answer": True}
    print(f"  9d shedding [{card}]: Overloaded on the primary, shed to "
          f"{picked.name}, answer equal to its own", flush=True)
    pf = rs.planned_failover()
    if pf["replayed"] != 0 or rs.guard.should_checkpoint:
        raise AssertionError(f"9c: planned failover {pf}, guard "
                             f"{rs.guard.should_checkpoint}")
    old = svc
    rs.insert("t", fresh(1024, gen=g2)[0])
    rs.pump()
    all_equal(rs, "t", "9c survivor")
    out["9c"] = {"planned_failover": pf, "survivor_bit_equal": True,
                 "s": time.perf_counter() - t_c}
    print(f"  9c planned failover [{card}]: replayed {pf['replayed']} in "
          f"{pf['failover_ms']:.3f} ms, guard cleared, survivor bit-equal",
          flush=True)
    rs.shutdown()
    old.shutdown()
    del rs, svc, old, xt, picked
    release()

    # -- 9e ---------------------------------------------------------------
    t_e = time.perf_counter()
    e = {}
    cfg8 = dataclasses.replace(PAPER_1M, store_dtype="int8")
    svc = MemoryService(maintenance=False)
    rs = ReplicaSet(svc, n_replicas=1, ship_batch=64)
    rs.create_collection("q", cfg8, seed=seed + 3)
    g3 = torch.Generator(device=dev).manual_seed(seed + 1)
    x = make_corpus(n, d, g3)
    rs.build("q", x, ids=np.arange(n, dtype=np.int32))
    del x
    for _ in range(4):
        rs.insert("q", fresh(1024, gen=g3)[0])
    rs.delete("q", gone[:5000].astype(np.int32))
    rs.pump()
    all_equal(rs, "q", "9e int8")
    if svc.collection("q").snapshot().q_lists.dtype != torch.int8:
        raise AssertionError("9e: the int8 store is missing")
    qq = torch.nn.functional.normalize(
        torch.randn(64, d, generator=g3, device=dev), dim=1)
    want = [svc.query("q", qq[:1]), svc.query("q", qq)]
    got = [rs.replicas[0].service.query("q", qq[:1]),
           rs.replicas[0].service.query("q", qq)]
    for (gi, gs), (wi, ws) in zip(got, want):
        if not (np.array_equal(gi, wi) and np.array_equal(gs, ws)):
            raise AssertionError("9e: int8 answers differ")
    e["int8_bit_equal"] = True
    rs.shutdown()
    del rs, svc
    release()
    cfg_h = dataclasses.replace(PAPER_100K, index_policy="hnsw")
    svc = MemoryService(maintenance=False)
    rs = ReplicaSet(svc, n_replicas=1, ship_batch=64)
    rs.create_collection("h", cfg_h, seed=seed + 4)
    g4 = torch.Generator(device=dev).manual_seed(seed + 16)
    xh = make_corpus(GRAPH_ROWS + 16, cfg_h.dim, g4)
    rs.build("h", xh[:GRAPH_ROWS], ids=np.arange(GRAPH_ROWS))
    rs.pump()
    rcoll = rs.replicas[0].service.collection("h")
    t0 = time.perf_counter()
    for s in (svc, rs.replicas[0].service):
        s.query("h", xh[:1])                          # builds each graph
    e["graph_builds_s_host"] = time.perf_counter() - t0
    graph = rcoll._graph
    new = np.arange(GRAPH_ROWS, GRAPH_ROWS + 16)
    rs.insert("h", xh[GRAPH_ROWS:], ids=new)
    hgone = np.concatenate([new[:8], np.arange(8)])
    rs.delete("h", hgone)
    rs.pump()
    have = set(graph.live_ids().tolist()) if graph is not None else set()
    if graph is None or rcoll._graph is not graph or \
            not set(new[8:].tolist()) <= have or set(hgone.tolist()) & have:
        raise AssertionError("9e: the replica graph did not mirror the "
                             "shipped writes")
    probe = torch.cat([xh[GRAPH_ROWS:], xh[:8]])
    want = svc.query("h", probe)
    got = rs.replicas[0].service.query("h", probe)
    if not (np.array_equal(got[0], want[0]) and
            np.array_equal(got[1], want[1])):
        raise AssertionError("9e: graph answers differ")
    if np.isin(got[0], hgone).any():
        raise AssertionError("9e: a deleted id came back")
    if not np.array_equal(got[0][8:16, 0], new[8:]):
        raise AssertionError("9e: an inserted row is not found")
    e["graph_mirrored"] = True
    e["s"] = time.perf_counter() - t_e
    out["9e"] = e
    print(f"  9e int8 + graph [{card}]: int8 leaves and answers bit-equal; "
          f"graph "
          f"mirrored 16 inserts and {len(hgone)} deletes, answers equal "
          f"(graph builds {e['graph_builds_s_host']:.1f} s host)", flush=True)
    rs.shutdown()
    del rs, svc, rcoll, graph, xh
    release()
    out["launches"] = {k: m.launches.value for k, m in kernels.items()}
    out["launches_by_variant"] = {
        k: {v: c.value for v, c in kernels[k].launches_by_variant.items()}
        for k in ("scan_scores", "scan_scores_q8", "kmeans_assign")}
    for k, cnt in out["launches"].items():
        if cnt <= 0:
            raise AssertionError(f"phase 9 never launched {k}")
    for k, by in out["launches_by_variant"].items():
        fast = next(iter(by))
        if by["generic"] or by[fast] != out["launches"][k]:
            raise AssertionError(f"phase 9 {k} launches by variant {by}: "
                                 f"not all {fast}")
    return out


# ---------------------------------------------------------------------------
# phase 10: the mesh-sharded tier (S shards on the one card)
# ---------------------------------------------------------------------------

SHARDS = 4              # 10a, 10c-10f: shards of one collection
Q8_SHARDS = 2           # 10b: the int8 store's shards
SHARD_INSERTS = 8       # 10a: 1024-row inserts under queries
SHARD_DELETES = 10_000  # 10a, 10b: corpus ids deleted
FUSED_SHARDED = 4       # 10c: sharded PAPER_100K tenants
TENANT_SHARD_ROWS = 100_000     # 10c: rows a shard of each tenant
MAINT_TOMBSTONES = 1000         # 10f: the per-shard tombstone limit


class uncounted:
    """Launches inside the block belong to a check, not to the path: their
    counts go to `excluded` (per kernel, per variant)."""

    def __init__(self, kernels, excluded):
        self.kernels, self.excluded = kernels, excluded

    def _read(self):
        return {k: (m.launches.value,
                    {v: c.value for v, c in
                     getattr(m, "launches_by_variant", {}).items()})
                for k, m in self.kernels.items()}

    def __enter__(self):
        self.before = self._read()

    def __exit__(self, *exc):
        for k, (n, by) in self._read().items():
            n0, by0 = self.before[k]
            e = self.excluded.setdefault(k, {"all": 0})
            e["all"] += n - n0
            for v, c in by.items():
                e[v] = e.get(v, 0) + c - by0[v]


def sharded_live(coll) -> torch.Tensor:
    """The live ids of a sharded collection, sorted, on shard 0's card."""
    ids = torch.cat([torch.cat([st.list_ids.reshape(-1), st.spill_ids])
                     for st in coll.snapshot()])
    return torch.sort(ids[ids >= 0]).values


def phase_sharded(seed: int, card: str) -> dict:
    """The sharded tier on the card.  10a: PAPER_1M shards, SHARDS of them
    on the one card (4,000,000 rows, f32): the build; recall@10 against an
    exact brute force over the live rows, and the merged answer equal to a
    global top-k over the shards' kernel scores; B=1 and B=64 queries (the
    sharded tier always full-scans), each query's own row first on >= 99 %;
    8 x 1024-row inserts while queries run; a 10,000-id delete whose
    per-shard hits sum to 10,000; `rebuild(shard=h)` of the most
    tombstoned shard while an inserter thread runs (zero lost rows, the
    log replayed, only shard h's version bumped beyond the inserts'), a
    quiet rebuild of another shard (siblings' versions unchanged, their
    leaves `torch.equal` to before in the same storage), and a full sweep
    (no tombstone left).  10b: the int8 store on Q8_SHARDS PAPER_1M shards
    (2,000,000 rows): build, queries, insert, delete, a shard rebuild;
    recall@10 >= 0.95 x 10a's.  10c: FUSED_SHARDED sharded PAPER_100K
    tenants (100,000 rows a shard): a window of unequal batches is one
    dispatch, every shard's scan one lane launch, each answer equal to the
    tenant's own query; a window with an unsharded tenant is two groups.
    10d: a sharded PAPER_100K tenant (100,000 rows over SHARDS shards)
    saved; loaded on the same mesh (leaves equal to the saved ones, same
    answers), on Q8_SHARDS shards with `reshard=True` (the same live set),
    and without it (ValueError).  10e: the tenant to WARM (page-locked
    per-shard host states) and back, to COLD and back by a query, every
    answer bit-equal, `memory_allocated` down by >= 0.95 x its bytes per
    demotion.  10f: `poll_once` schedules a rebuild of exactly the shard
    whose tombstones crossed the limit."""
    import threading
    from repro_torch.api import MemoryOp, MemoryService
    from repro_torch.configs.ame_paper import PAPER_100K, PAPER_1M
    from repro_torch.core import index as ivf
    from repro_torch.core import metrics, templates
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8
    from repro_torch.kernels import segsum_gemm as sg

    dev = torch.device("cuda")
    kernels = {"scan_scores": ss, "scan_scores_q8": q8, "kmeans_assign": ka,
               "segsum_gemm": sg}
    for m in kernels.values():
        for c in (m.launches, *getattr(m, "launches_by_variant", {}).values(),
                  *getattr(m, "launches_by_lanes", {}).values()):
            c.reset()
    excluded = {}
    torch.cuda.reset_peak_memory_stats()
    out = {"card": card}
    mesh = make_mesh((SHARDS,), ("shard",))
    mesh2 = make_mesh((Q8_SHARDS,), ("shard",))
    g = torch.Generator(device=dev).manual_seed(seed + 10)

    def lifecycle(cfg, m, tag) -> dict:
        """10a / 10b: one sharded PAPER_1M collection's lifecycle."""
        r = {"shards": m.size}
        n = m.size * N_ROWS
        x = make_corpus(n, cfg.dim, g)
        live = np.zeros(n + 200_000, dtype=bool)
        live[:n] = True
        next_id = n

        def check_live(coll, what):
            want = torch.from_numpy(
                np.nonzero(live)[0].astype(np.int32)).to(dev)
            got = sharded_live(coll)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{tag}: live ids after {what}: {got.numel()} in the "
                    f"index vs {want.numel()} acknowledged")

        def fresh(b):
            nonlocal next_id
            rows = torch.nn.functional.normalize(
                torch.randn(b, cfg.dim, generator=g, device=dev), dim=1)
            ids = np.arange(next_id, next_id + b, dtype=np.int32)
            next_id += b
            return rows, ids

        with MemoryService(maintenance=False) as svc:
            coll = svc.create_collection("mem", cfg, mesh=m, seed=seed)
            if coll.n_shards != m.size or \
                    coll.index_nbytes() != ivf.state_nbytes(cfg, 4096,
                                                            m.size):
                raise AssertionError(f"{tag}: shards or byte charge wrong")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = svc.build("mem", x, ids=np.arange(n, dtype=np.int32))
            r["build_s"] = time.perf_counter() - t0
            r["build_spilled"] = b["spilled"]
            check_live(coll, "build")
            st = coll.stats()
            r["index_gb"] = st["index_bytes"] / 1e9
            if st["index_bytes"] != coll.index_nbytes():
                raise AssertionError(f"{tag}: resident bytes "
                                     f"{st['index_bytes']} != the charge")

            # recall@10 of the merged answer against an exact brute force
            sel = torch.randint(0, n, (256,), generator=g, device=dev)
            rq = perturb(x[sel], g)
            truth = metrics.brute_force_topk(
                rq, x, torch.arange(n, device=dev), 10, cfg.metric,
                device=dev)
            got, got_sc = svc.query("mem", rq, k=10)
            r["recall10"] = metrics.recall_at_k(got, truth)
            del truth
            # ... and, at B=16, equal to a global top-k over the shards'
            # kernel scores
            if not cfg.quantized:
                qk = rq[:16].contiguous()
                got, got_sc = svc.query("mem", qk, k=10)
                with uncounted(kernels, excluded):
                    sc, fid = [], []
                    for local in coll.snapshot():
                        rows, i = ivf._flat_rows(local)
                        sc.append(ss.scan_scores(qk, rows, i, None,
                                                 metric=cfg.metric))
                        fid.append(i)
                        del rows
                    sc, fid = torch.cat(sc, 1), torch.cat(fid)
                pos = torch.sort(sc, dim=1, descending=True,
                                 stable=True).indices[:, :10]
                if not (np.array_equal(got, fid[pos].cpu().numpy())
                        and np.array_equal(got_sc,
                                           sc.gather(1, pos).cpu().numpy())):
                    raise AssertionError(f"{tag}: the merged answer is not "
                                         "the global top-k of the shards' "
                                         "kernel scores")
                r["merge_equals_global_topk"] = True
                del sc, fid
            del rq

            # the corpus goes; the queries' targets stay
            keep = torch.randperm(n, generator=g, device=dev)[:65_536]
            xk = x[keep].clone()
            keep = keep.cpu().numpy()
            del x, got, got_sc

            def queries(b):
                ok = np.nonzero(live[keep])[0]
                pick = ok[torch.randint(0, len(ok), (b,), generator=g,
                                        device=dev).cpu().numpy()]
                return keep[pick], perturb(
                    xk[torch.from_numpy(pick).to(dev)], g)

            def hit_rate(b, reps, what):
                hits = tot = 0
                lat = []
                for _ in range(reps):
                    t, q = queries(b)
                    t0 = time.perf_counter()
                    ids, _ = svc.query("mem", q)
                    lat.append(time.perf_counter() - t0)
                    hits += int((ids[:, 0] == t).sum())
                    tot += b
                if hits / tot < 0.99:
                    raise AssertionError(f"{tag}: {what} queries found "
                                         f"their row first on "
                                         f"{hits / tot:.4f} < 0.99")
                return hits / tot, lat

            hit_rate(1, 3, "B=1")                          # warm-up
            r["hit_b1"], lat = hit_rate(1, 30, "B=1")
            r["query_p50_ms_b1"] = 1e3 * float(np.median(lat))
            hit_rate(64, 1, "B=64")
            r["hit_b64"], lat = hit_rate(64, 6, "B=64")
            r["query_p50_ms_b64"] = 1e3 * float(np.median(lat))

            # inserts as futures while B=1 queries run
            n_ins = SHARD_INSERTS if not cfg.quantized else 1
            batches = [fresh(1024) for _ in range(n_ins)]
            t0 = time.perf_counter()
            futs = [svc.submit(MemoryOp("insert", "mem", rows, ids=ids,
                                        concurrent=True))
                    for rows, ids in batches]
            hit_rate(1, 5, "B=1 (during inserts)")
            for f in futs:
                f.result(timeout=600)
            r["insert_rows_per_s"] = n_ins * 1024 / (time.perf_counter() - t0)
            for _, ids in batches:
                live[ids] = True
            check_live(coll, "inserts")

            # a delete of corpus ids, its hits counted per shard
            gone = np.random.default_rng(seed).choice(n, SHARD_DELETES,
                                                      replace=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_hit = svc.delete("mem", gone.astype(np.int32))
            r["delete_ms"] = 1e3 * (time.perf_counter() - t0)
            per_shard = [p["tombstones"]
                         for p in coll.maintenance_pressure()["shards"]]
            if n_hit != SHARD_DELETES or sum(per_shard) != SHARD_DELETES:
                raise AssertionError(f"{tag}: delete hit {n_hit}, per "
                                     f"shard {per_shard}")
            r["delete_hits_by_shard"] = per_shard
            live[gone] = False
            check_live(coll, "delete")

            # the most tombstoned shard rebuilt while an inserter runs
            h = int(np.argmax(per_shard))
            v0 = coll.shard_versions()
            landed = []
            done = threading.Event()
            errors = []

            def inserter():
                try:
                    while not done.is_set() and len(landed) < 400:
                        rows, ids = fresh(256)
                        svc.insert("mem", rows, ids=ids)
                        landed.append(ids)
                except BaseException as e:     # noqa: BLE001
                    errors.append(e)

            th = threading.Thread(target=inserter)
            th.start()
            while not landed and th.is_alive():
                time.sleep(0.001)              # the first insert has landed
            t0 = time.perf_counter()
            rb = svc.rebuild("mem", shard=h)
            r["shard_rebuild_s"] = time.perf_counter() - t0
            done.set()
            th.join()
            if errors:
                raise errors[0]
            for ids in landed:
                live[ids] = True
            v1 = coll.shard_versions()
            r.update(rebuilt_shard=h, replayed_rows=rb["replayed"],
                     inserts_during_rebuild=len(landed),
                     rebalanced_rows=rb.get("rebalanced", 0))
            bumps = [b - a for a, b in zip(v0, v1)]
            moved = rb.get("rebalance_to")
            want = [len(landed) + (s == h or s == moved) for s in range(m.size)]
            if rb["aborted"] or rb["replayed"] == 0 or bumps != want:
                raise AssertionError(f"{tag}: shard rebuild {rb}, version "
                                     f"bumps {bumps} != {want}")
            check_live(coll, "shard rebuild under inserts")
            if cfg.quantized:
                r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                return r

            # a quiet rebuild of another shard: siblings untouched
            h2 = (h + 1) % m.size
            before = coll.snapshot()
            v0 = coll.shard_versions()
            rb2 = svc.rebuild("mem", shard=h2)
            after = coll.snapshot()
            v1 = coll.shard_versions()
            for s in range(m.size):
                if s == h2 or s == rb2.get("rebalance_to"):
                    continue
                same = v1[s] == v0[s] and all(
                    a.data_ptr() == b.data_ptr() and torch.equal(a, b)
                    for a, b in zip(before[s], after[s]) if a is not None)
                if not same:
                    raise AssertionError(f"{tag}: rebuilding shard {h2} "
                                         f"touched shard {s}")
            del before, after
            r["siblings_untouched"] = True

            # a full sweep reclaims every tombstone
            t0 = time.perf_counter()
            rb3 = svc.rebuild("mem")
            r["sweep_s"] = time.perf_counter() - t0
            if rb3["aborted"] or coll.stats()["deleted"] != 0:
                raise AssertionError(f"{tag}: sweep left tombstones: {rb3}")
            check_live(coll, "sweep")
            r["hit_b1_after"], _ = hit_rate(1, 10, "B=1 (after rebuilds)")
            r["live"] = coll.stats()["live"]
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return r

    t_a = time.perf_counter()
    out["10a"] = a = lifecycle(dataclasses.replace(PAPER_1M, shard_db=True),
                               mesh, "10a")
    a["s"] = time.perf_counter() - t_a
    release()
    print(f"  10a f32 {SHARDS} x PAPER_1M [{card}]: build "
          f"{a['build_s']:.3f} s, query p50 {a['query_p50_ms_b1']:.3f} ms "
          f"(B=1) / {a['query_p50_ms_b64']:.3f} ms (B=64), recall@10 "
          f"{a['recall10']:.4f}, insert {a['insert_rows_per_s']:.0f} rows/s, "
          f"delete {a['delete_ms']:.3f} ms, shard rebuild "
          f"{a['shard_rebuild_s']:.3f} s ({a['replayed_rows']} rows of "
          f"{a['inserts_during_rebuild']} inserts replayed), peak "
          f"{a['peak_gib']:.1f} GiB", flush=True)

    torch.cuda.reset_peak_memory_stats()
    t_b = time.perf_counter()
    out["10b"] = b = lifecycle(
        dataclasses.replace(PAPER_1M, shard_db=True, store_dtype="int8"),
        mesh2, "10b")
    b["s"] = time.perf_counter() - t_b
    release()
    if b["recall10"] < 0.95 * a["recall10"]:
        raise AssertionError(f"10b recall@10 {b['recall10']:.4f} < 0.95 x "
                             f"10a's {a['recall10']:.4f}")
    print(f"  10b int8 {Q8_SHARDS} x PAPER_1M [{card}]: build "
          f"{b['build_s']:.3f} s, query p50 {b['query_p50_ms_b1']:.3f} / "
          f"{b['query_p50_ms_b64']:.3f} ms, recall@10 {b['recall10']:.4f}, "
          f"shard rebuild {b['shard_rebuild_s']:.3f} s, peak "
          f"{b['peak_gib']:.1f} GiB", flush=True)

    # 10c: fused windows over sharded tenants
    t_c = time.perf_counter()
    scfg = dataclasses.replace(PAPER_100K, shard_db=True)
    c = {}
    with MemoryService(maintenance=False) as svc:
        names = [f"s{i}" for i in range(FUSED_SHARDED)]
        rows = {}
        for i, name in enumerate(names):
            xt = make_corpus(SHARDS * TENANT_SHARD_ROWS, scfg.dim, g)
            svc.create_collection(name, scfg, mesh=mesh, seed=i)
            svc.build(name, xt, ids=np.arange(xt.shape[0], dtype=np.int32)
                      + 1_000_000 * i)
            rows[name] = xt[:64].clone()
            del xt
        xu = make_corpus(TENANT_SHARD_ROWS, scfg.dim, g)
        svc.create_collection("u", PAPER_100K)
        svc.build("u", xu, ids=np.arange(TENANT_SHARD_ROWS, dtype=np.int32)
                  + 9_000_000)
        rows["u"] = xu[:64].clone()
        del xu
        reqs = [(nm, perturb(rows[nm][:bsz], g))
                for nm, bsz in zip(names, (1, 3, 8, 21))]

        def fused(reqs):
            before = {k: (m.launches.value, m.launches_by_lanes["G>1"].value)
                      for k, m in (("ss", ss),)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            futs = [svc.submit(MemoryOp("query", nm, q, batch=True))
                    for nm, q in reqs]
            n_disp = svc.flush()
            res = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            lanes = (ss.launches.value - before["ss"][0],
                     ss.launches_by_lanes["G>1"].value - before["ss"][1])
            return n_disp, res, wall, lanes

        def same(got, want, what):
            for (gi, gs), (wi, ws) in zip(got, want):
                if not np.array_equal(gi, wi) or \
                        not np.allclose(gs, ws, rtol=1e-5, atol=1e-5):
                    raise AssertionError(f"10c {what}: a fused answer "
                                         "differs from the tenant's query")

        want = [svc.query(nm, q) for nm, q in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [svc.query(nm, q) for nm, q in reqs]
        c["per_tenant_s"] = time.perf_counter() - t0
        fused(reqs)                                    # warm-up
        n_disp, got, c["window_s"], lanes = fused(reqs)
        if n_disp != 1 or lanes != (SHARDS, SHARDS):
            raise AssertionError(f"10c: {n_disp} dispatches, scan launches "
                                 f"(all, lane) {lanes}; want 1 and "
                                 f"({SHARDS}, {SHARDS})")
        same(got, want, "sharded window")
        c["stack_cache"] = svc.stats()["stack_cache"]
        mixed = reqs[:2] + [("u", perturb(rows["u"][:4], g))]
        want = [svc.query(nm, q) for nm, q in mixed]
        n_disp, got, _, _ = fused(mixed)
        if n_disp != 2:
            raise AssertionError(f"10c: the mixed window took {n_disp} "
                                 "dispatches, not 2")
        same(got, want, "mixed window")
        c["mixed_dispatches"] = n_disp
        c["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    c["s"] = time.perf_counter() - t_c
    out["10c"] = c
    release()
    print(f"  10c fused [{card}]: {FUSED_SHARDED} sharded PAPER_100K "
          f"tenants, 1 dispatch ({SHARDS} lane launches) in "
          f"{1e3 * c['window_s']:.3f} ms vs {1e3 * c['per_tenant_s']:.3f} "
          f"ms per tenant; mixed window 2 dispatches", flush=True)

    # 10d-10f: one sharded PAPER_100K tenant saved, reloaded, resharded,
    # demoted and promoted, and maintained by the controller
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        d, e, f = {}, {}, {}
        th = dataclasses.replace(
            templates.TemplateThresholds.from_profile(scfg),
            maintenance_tombstone_frac=0.0,
            maintenance_min_pending=MAINT_TOMBSTONES,
            maintenance_shard_min_pending=MAINT_TOMBSTONES)
        svc = MemoryService(maintenance_poll_interval_s=3600.0,
                            residency_dir=os.path.join(tmp, "cold"))
        try:
            t_d = time.perf_counter()
            xp = make_corpus(TENANT_SHARD_ROWS, scfg.dim, g)
            coll = svc.create_collection("p", scfg, mesh=mesh, seed=seed,
                                         thresholds=th)
            svc.build("p", xp, ids=np.arange(TENANT_SHARD_ROWS,
                                             dtype=np.int32))
            q = perturb(xp[:32], g)
            del xp
            want = svc.query("p", q)
            want_live = sharded_live(coll)
            t0 = time.perf_counter()
            svc.save(os.path.join(tmp, "svc"))
            d["save_s"] = time.perf_counter() - t0
            saved = coll.snapshot()
            with MemoryService.load(os.path.join(tmp, "svc"), mesh=mesh,
                                    maintenance=False) as back:
                got = back.query("p", q)
                bstate = back.collection("p").snapshot()
                equal = all(torch.equal(a, bb) for s0, s1 in zip(saved, bstate)
                            for a, bb in zip(s0, s1) if a is not None)
                if not equal or not (np.array_equal(got[0], want[0]) and
                                     np.array_equal(got[1], want[1])):
                    raise AssertionError("10d: the reloaded tenant differs")
                del bstate
            del saved
            with MemoryService.load(os.path.join(tmp, "svc"), mesh=mesh2,
                                    reshard=True, maintenance=False) as back:
                rc = back.collection("p")
                if rc.n_shards != Q8_SHARDS or \
                        not torch.equal(sharded_live(rc), want_live):
                    raise AssertionError("10d: the resharded live set "
                                         "differs")
                d["resharded_spill"] = rc.stats()["spill"]
            try:
                MemoryService.load(os.path.join(tmp, "svc"), mesh=mesh2,
                                   maintenance=False)
                raise AssertionError("10d: a mesh mismatch loaded")
            except ValueError as err:
                if "reshard=True" not in str(err):
                    raise
            d["s"] = time.perf_counter() - t_d
            release()

            # 10e: WARM and back, COLD and back by a query
            t_e = time.perf_counter()
            for tier in ("warm", "cold"):        # each from HOT
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                svc.demote("p", tier)
                e[f"demote_{tier}_s"] = time.perf_counter() - t0
                freed = before - torch.cuda.memory_allocated()
                if coll.residency != tier or \
                        freed < 0.95 * coll.index_nbytes():
                    raise AssertionError(
                        f"10e: demote to {tier} freed {freed} of "
                        f"{coll.index_nbytes()} bytes")
                if tier == "warm" and not all(
                        t.is_pinned() for st in coll._host_state
                        for t in st if t is not None):
                    raise AssertionError("10e: a WARM leaf is not pinned")
                t0 = time.perf_counter()
                got = svc.query("p", q)
                e[f"promote_{tier}_query_s"] = time.perf_counter() - t0
                if coll.residency != "hot" or not (
                        np.array_equal(got[0], want[0])
                        and np.array_equal(got[1], want[1])):
                    raise AssertionError(f"10e: the answer after {tier} "
                                         "differs")
            e["s"] = time.perf_counter() - t_e

            # 10f: tombstones on one shard only; poll_once rebuilds it alone
            t_f = time.perf_counter()
            hot = SHARDS - 2
            ids = coll.snapshot()[hot].list_ids.reshape(-1)
            ids = ids[ids >= 0][:MAINT_TOMBSTONES + 200].cpu().numpy()
            svc.delete("p", ids)
            due = coll.maintenance_due_shards()
            v0 = coll.shard_versions()
            maint = svc.maintenance
            scheduled = maint.poll_once()
            inflight = maint.stats()["inflight"]
            deadline = time.time() + 300
            while maint.stats()["inflight"] and time.time() < deadline:
                time.sleep(0.01)
            bumps = [b1 - b0 for b0, b1 in zip(v0, coll.shard_versions())]
            want_bumps = [int(s == hot) for s in range(SHARDS)]
            if due != [hot] or scheduled != 1 or \
                    inflight not in ([], [f"p[shard {hot}]"]) or \
                    bumps != want_bumps or coll.stats()["deleted"] != 0:
                raise AssertionError(
                    f"10f: due {due}, scheduled {scheduled}, inflight "
                    f"{inflight}, version bumps {bumps}")
            f.update(due=due, scheduled=scheduled, version_bumps=bumps,
                     s=time.perf_counter() - t_f)
        finally:
            svc.shutdown()
        out["10d"], out["10e"], out["10f"] = d, e, f
        del svc, coll
        release()
    print(f"  10d-10f [{card}]: save {d['save_s']:.3f} s, same-mesh reload "
          f"equal, resharded to {Q8_SHARDS} shards with the same live set, "
          f"mismatch refused; WARM/COLD round trips bit-equal; poll_once "
          f"rebuilt shard {SHARDS - 2} alone", flush=True)

    out["launches"] = {k: m.launches.value - excluded.get(k, {}).get("all", 0)
                       for k, m in kernels.items()}
    out["launches_by_variant"] = {
        k: {v: c.value - excluded.get(k, {}).get(v, 0)
            for v, c in kernels[k].launches_by_variant.items()}
        for k in ("scan_scores", "scan_scores_q8", "kmeans_assign")}
    for k, cnt in out["launches"].items():
        if cnt <= 0:
            raise AssertionError(f"phase 10 never launched {k}")
    for k, by in out["launches_by_variant"].items():
        fast = next(iter(by))
        if by["generic"] or by[fast] != out["launches"][k]:
            raise AssertionError(f"phase 10 {k} launches by variant {by}: "
                                 f"not all {fast}")
    return out


# ---------------------------------------------------------------------------
# phases 11 and 12: the RAG serving path (an LM at full width beside the
# memory)
# ---------------------------------------------------------------------------

SERVE_ARCH = "granite-3-2b"   # the serve entry points' default arch
SERVE_PROMPT = 512      # 11a, 12: prompt tokens a request
SERVE_DECODE = 32       # 11a, 12: greedy tokens a request
SERVE_TURNS = 3
SERVE_INSERTS = 256     # 11a, 12a: rows inserted in 32-row concurrent ops
SERVE_MEM_K = 4         # retrieved memories a request
PROJ_ROWS = 100_000     # 11c, 12b: PAPER_100K's corpus (dim 1024 != d_model)
SERVE_TOL = 2e-3        # 11b, 12c: the reference's decode-vs-forward rtol/atol
FAMILY_ARCH = "olmoe-1b-7b"     # 12a: the sparse model beside PAPER_1M
FAMILY_ARCHS = ("deepseek-moe-16b", "qwen2-vl-7b", "rwkv6-1.6b",
                "zamba2-2.7b")  # 12b: the other families, one at a time
# 12c: decode == forward at full width.  rwkv6 in float64: its per-head
# GroupNorm (eps 1e-6) divides nearly constant early heads by ~1e-3, which
# turns float32 rounding into differences past SERVE_TOL on some draws
# (measured beside it, not held; ROADMAP.md section 3)
FAMILY_DECODE = (("olmoe-1b-7b", "float32"), ("rwkv6-1.6b", "float64"),
                 ("zamba2-2.7b", "float32"))
FAMILY_INSERTS = 64     # 12b: rows inserted a model, 32-row ops


def live_ids(coll) -> torch.Tensor:
    st = coll.snapshot()
    ids = torch.cat([st.list_ids.reshape(-1), st.spill_ids])
    return torch.sort(ids[ids >= 0]).values


def serving_kernels() -> dict:
    """The kernel modules the serving path launches, counts set to 0."""
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8
    from repro_torch.kernels import segsum_gemm as sg
    kernels = {"scan_scores": ss, "scan_scores_q8": q8, "kmeans_assign": ka,
               "segsum_gemm": sg}
    for m in kernels.values():
        for c in (m.launches, *getattr(m, "launches_by_variant", {}).values(),
                  *getattr(m, "launches_by_lanes", {}).values()):
            c.reset()
    return kernels


def assign_variants(kernels, excluded) -> dict:
    return {v: c.value - excluded.get("kmeans_assign", {}).get(v, 0)
            for v, c in kernels["kmeans_assign"].launches_by_variant.items()}


def path_launches(kernels, excluded) -> dict:
    """A serving phase's launches, the checks' left out."""
    out = {"launches": {k: m.launches.value
                        - excluded.get(k, {}).get("all", 0)
                        for k, m in kernels.items()}}
    out["launches_by_variant"] = {
        k: {v: cnt.value - excluded.get(k, {}).get(v, 0)
            for v, cnt in kernels[k].launches_by_variant.items()}
        for k in ("scan_scores", "scan_scores_q8", "kmeans_assign")}
    return out


def check_retrieval(tag, snap, q, ids, ecfg, margins, kernels, excluded):
    """The served ids against the plain version's on the same snapshot,
    the kernel's scores against the plain version's."""
    from repro_torch.core import index as ivf
    from repro_torch.serving import rag
    with uncounted(kernels, excluded):
        kid, ksc, _ = rag.retrieve(snap, q, ecfg, SERVE_MEM_K)
    pid, psc, _ = ivf.query_full_scan_rows(
        snap, q, dataclasses.replace(ecfg, use_kernel=False),
        SERVE_MEM_K + 1)
    if not (torch.equal(ids, pid[:, :SERVE_MEM_K]) and torch.equal(kid, ids)):
        raise AssertionError(f"{tag}: served ids {ids.tolist()} != plain "
                             f"{pid[:, :SERVE_MEM_K].tolist()}")
    err = float((ksc - psc[:, :SERVE_MEM_K]).abs().max())
    if err > 1e-5:
        raise AssertionError(f"{tag}: scores off the plain version's by {err}")
    margins.append(float((psc[:, SERVE_MEM_K - 1]
                          - psc[:, SERVE_MEM_K]).min()))
    return err


def made_model(tag, cfg, seed: int):
    """The model from `seed` on the card: matrices in ``cfg.dtype`` (but
    rwkv6's f32 bonus), vectors f32, and as many parameters as the
    analytic count (`accounting.param_count`) says.  Returns (params,
    record)."""
    from repro_torch.models import accounting, layers, lm
    t0 = time.perf_counter()
    params = lm.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    rec = {"init_s": time.perf_counter() - t0}
    dt = layers.torch_dtype(cfg.dtype)
    for name, p in params.named_parameters():
        want = (torch.float32 if p.dim() == 1 or name.endswith(".u")
                else dt)
        if p.dtype != want:
            raise AssertionError(f"{tag}: {name} is {p.dtype}, not {want}")
    if accounting.counted_params(params) != cfg.param_count():
        raise AssertionError(f"{tag}: parameter count != the config's")
    rec["params"] = cfg.param_count()
    rec["weight_GB"] = sum(p.numel() * p.element_size()
                           for p in params.parameters()) / 1e9
    return params, rec


def served_numbers(served) -> dict:
    """What a served run prints: time to first token, ms/token, tok/s,
    insert rows/s."""
    dec = served["decode_ms"]
    out = dict(prefill_ms=served["prefill_ms"],
               prefill_p50_ms=float(np.percentile(served["prefill_ms"], 50)),
               decode_p50_ms=float(np.percentile(dec, 50)),
               decode_p95_ms=float(np.percentile(dec, 95)),
               decode_steps_timed=len(dec), tok_per_s=served["tok_per_s"],
               insert_rows=served["insert_rows"])
    if "insert_rows_per_s" in served:
        out["insert_rows_per_s"] = served["insert_rows_per_s"]
        out["insert_p50_ms"] = float(np.percentile(served["insert_ms"], 50))
    return out


def check_tokens(tag, served, cfg) -> None:
    for t in served["turns"]:
        if not np.all((t["tokens"] >= 0) & (t["tokens"] < cfg.vocab_size)):
            raise AssertionError(f"{tag}: a token outside the vocabulary")


def serve_beside_paper_1m(tag, cfg, params, seed, g, kernels, excluded):
    """`repro_torch.launch.serve`'s body with `params` beside a
    1,000,000-row memory at dim d_model in PAPER_1M's layout (C 1024, L
    1464, spill 4096), built through `MemoryService`: SERVE_TURNS turns of
    SERVE_REQUESTS requests (SERVE_PROMPT-token prompts, SERVE_DECODE
    greedy tokens) while SERVE_INSERTS rows go in as 32-row concurrent
    inserts and each turn's query embeddings after it; every turn's
    retrieved ids equal the plain version's on the same snapshot (scores
    within 1e-5), every acknowledged insert is live."""
    from repro_torch.configs.ame_paper import PAPER_1M
    from repro_torch.launch import serve as srv
    from repro_torch.serving import rag

    dev = torch.device("cuda")
    a = {}
    ecfg = dataclasses.replace(PAPER_1M, dim=cfg.d_model, k=SERVE_MEM_K)
    x = make_corpus(N_ROWS, ecfg.dim, g)
    a["corpus_GB"] = x.numel() * 4 / 1e9
    svc, coll, stats = srv.build_memory(ecfg, x, device=dev)
    del x
    gc.collect()
    a["build_s"] = stats["build_s"]
    a["state_GB"] = sum(t.numel() * t.element_size()
                        for t in coll.snapshot() if t is not None) / 1e9
    a["build_assign_variants"] = assign_variants(kernels, excluded)
    margins, errs = [], []
    try:
        inserts = torch.nn.functional.normalize(
            torch.randn(SERVE_INSERTS, ecfg.dim, generator=g, device=dev),
            dim=1)

        def on_turn(turn, snap, batch, ids):
            q = rag.embed_query(params, cfg, batch["tokens"])
            errs.append(check_retrieval(f"{tag} turn {turn}", snap, q, ids,
                                        ecfg, margins, kernels, excluded))

        served = srv.serve(cfg, ecfg, params, svc, coll,
                           requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                           decode_steps=SERVE_DECODE, turns=SERVE_TURNS,
                           inserts=inserts,
                           insert_queries=True, seed=seed, on_turn=on_turn)
        n_ins = SERVE_INSERTS + SERVE_TURNS * SERVE_REQUESTS
        want = torch.arange(N_ROWS + n_ins, dtype=torch.int32, device=dev)
        if not torch.equal(live_ids(coll), want):
            raise AssertionError(f"{tag}: acknowledged inserts are not all "
                                 "live")
        if served["insert_rows"] != n_ins:
            raise AssertionError(f"{tag}: {served['insert_rows']} rows "
                                 "inserted")
        check_tokens(tag, served, cfg)
        # the retrieval alone, at the served shape (a timing, not the path)
        q = rag.embed_query(params, cfg, torch.randint(
            0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT), generator=g,
            device=dev, dtype=torch.int32))
        snap = coll.snapshot()
        with uncounted(kernels, excluded):
            a["retrieval_ms"] = cuda_ms(
                lambda: rag.retrieve(snap, q, ecfg, SERVE_MEM_K), reps=10)
        del snap, q
    finally:
        srv.close(svc)
    del svc, coll
    a.update(requests=SERVE_REQUESTS, prompt=SERVE_PROMPT,
             decode=SERVE_DECODE, turns=SERVE_TURNS,
             retrieval_score_err=max(errs), min_topk_margin=min(margins),
             assign_variants=assign_variants(kernels, excluded),
             **served_numbers(served))
    want_v = kernels["kmeans_assign"].variant_for(N_ROWS, ecfg.n_clusters,
                                                  ecfg.dim, 0, 0)
    if set(k for k, v in a["assign_variants"].items() if v) != {want_v}:
        raise AssertionError(f"{tag} kmeans_assign variants "
                             f"{a['assign_variants']}, expected {want_v}")
    a["assign_variant_expected"] = want_v
    a["dim"] = ecfg.dim
    return a


def print_served(tag, card, cfg, r, memory: str) -> None:
    ins = (f"inserts {r['insert_rows_per_s']:.0f} rows/s under serving "
           f"(p50 {r['insert_p50_ms']:.3f} ms an op), "
           if "insert_rows_per_s" in r else "")
    print(f"  {tag} [{card}]: {cfg.name} ({r['params']:,} params, "
          f"{r['weight_GB']:.2f} GB {cfg.dtype}) {memory}: prefill (time to "
          f"first token) {[round(t, 3) for t in r['prefill_ms']]} ms, decode "
          f"p50/p95 {r['decode_p50_ms']:.3f}/{r['decode_p95_ms']:.3f} "
          f"ms/token, {r['tok_per_s']:.1f} tok/s, {ins}peak "
          f"{r['peak_GiB']:.1f} GiB", flush=True)


def decode_pairs(cfg, params, tokens, src=None):
    """`forward_train` over `tokens` [2, 8] (the enc-dec family also over
    source frames `src`), then prefill of the first 4 and 4 decode steps
    on the rest: (the forward's logits, [(step logits, the forward's at
    that position)])."""
    from repro_torch.models import lm
    extra = {} if src is None else {"src_emb": src}
    with torch.no_grad():
        full, _ = lm.forward_train(params, cfg, {"tokens": tokens, **extra})
    last, caches, _ = lm.prefill(params, cfg,
                                 {"tokens": tokens[:, :4], **extra}, 16)
    pairs = [(last, full[:, 3])]
    for t in range(4, 8):
        logits, caches = lm.decode_step(
            params, cfg, tokens[:, t: t + 1], caches,
            torch.full((2,), t, dtype=torch.int32, device=tokens.device))
        pairs.append((logits, full[:, t]))
    return full, pairs


def decode_vs_forward(tag, cfg, seed, g, dtype="float32"):
    """The model in `dtype` at full width from `seed`: prefill 4 teacher
    tokens, decode 4; every step's logits equal `forward_train`'s within
    rtol = atol = SERVE_TOL.  Returns (record, tokens, the forward's
    logits)."""
    from repro_torch.models import layers
    cfgx = cfg.replace(dtype=dtype)
    params, b = made_model(tag, cfgx, seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=g,
                           device=g.device, dtype=torch.int32)
    src = (torch.randn(2, 8, cfg.d_model, generator=g, device=g.device)
           if cfg.family == "encdec" else None)
    full, pairs = decode_pairs(cfgx, params, tokens, src)
    b.update(arch=cfg.name, dtype=dtype, positions=len(pairs),
             tol=SERVE_TOL,
             max_abs_err=max(float((x - y).abs().max()) for x, y in pairs),
             logit_scale=float(full.abs().max()))
    for got, want in pairs:
        if got.dtype != layers.torch_dtype(dtype):
            raise AssertionError(f"{tag}: logits in {got.dtype}")
        torch.testing.assert_close(got, want, rtol=SERVE_TOL, atol=SERVE_TOL)
    del params, pairs
    release()
    return b, tokens, full


def float32_reading(tag, cfg, seed, tokens, full64) -> dict:
    """The same model and tokens in float32, measured against the float64
    run: the decode's distance from the float32 forward, and the float32
    forward's own distance from the float64 one."""
    cfg32 = cfg.replace(dtype="float32")
    params, _ = made_model(tag, cfg32, seed)
    full, pairs = decode_pairs(cfg32, params, tokens)
    out = {"float32_decode_err": max(float((x - y).abs().max())
                                     for x, y in pairs),
           "float32_forward_vs_float64": float(
               (full.double() - full64).abs().max())}
    del params, pairs, full
    release()
    return out


def phase_serving(seed: int, card: str) -> dict:
    """The RAG serving path on the card, through
    `repro_torch.launch.serve`.  11a: granite-3-2b at full width (40
    layers, d_model 2048, bf16 weights from `seed`) served beside the
    PAPER_1M-layout memory (`serve_beside_paper_1m`).  11c: the projection
    branch (a PAPER_100K memory, dim 1024): one RAG prefill and 8 decode
    steps, ids equal the plain version's.  11b: the same model in
    float32: decode logits equal `forward_train`'s at every position
    within SERVE_TOL."""
    from repro_torch.configs import registry
    from repro_torch.configs.ame_paper import PAPER_100K
    from repro_torch.launch import serve as srv
    from repro_torch.serving import rag

    dev = torch.device("cuda")
    kernels = serving_kernels()
    excluded = {}
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_arch(SERVE_ARCH)
    if cfg.d_model != SERVE_DIM:
        raise AssertionError(f"{SERVE_ARCH} d_model {cfg.d_model}")
    out = {"card": card, "arch": cfg.name, "tf32": bool(
        torch.backends.cuda.matmul.allow_tf32),
        "bf16_reduced_precision_reduction": bool(
            torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction)}
    g = torch.Generator(device=dev).manual_seed(seed + 11)

    # -- 11a: the model and the memory ----------------------------------
    params, a = made_model("11a", cfg, seed)
    a.update(serve_beside_paper_1m("11a", cfg, params, seed, g, kernels,
                                   excluded))
    a["peak_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    release()
    print(f"  11a [{card}]: {cfg.name} over {N_ROWS:,} rows at dim "
          f"{a['dim']} (state {a['state_GB']:.2f} GB): build "
          f"{a['build_s']:.3f} s, retrieval {a['retrieval_ms']:.3f} ms; "
          f"kmeans_assign {a['assign_variant_expected']} at D={a['dim']}",
          flush=True)
    print_served("11a", card, cfg, a, f"beside {N_ROWS:,} rows")

    # -- 11c: the projection branch (dim 1024 != d_model 2048) ----------
    c = {}
    ecfg_c = dataclasses.replace(PAPER_100K, k=SERVE_MEM_K)
    x = make_corpus(PROJ_ROWS, ecfg_c.dim, g)
    before = assign_variants(kernels, excluded)
    svc, coll, stats = srv.build_memory(ecfg_c, x, device=dev, name="proj")
    del x
    c["build_s"] = stats["build_s"]
    c["assign_variants"] = {v: n - before[v] for v, n in
                            assign_variants(kernels, excluded).items()}
    try:
        # the served step's projections: both come from the same seeds
        step = rag.make_rag_prefill(cfg, ecfg_c, SERVE_PROMPT + 10,
                                    k=SERVE_MEM_K, device=dev)
        margins_c = []

        def on_turn_c(turn, snap, batch, ids):
            c["score_err"] = check_retrieval(
                "11c", snap, step.query(params, batch["tokens"]), ids,
                ecfg_c, margins_c, kernels, excluded)

        served = srv.serve(cfg, ecfg_c, params, svc, coll,
                           requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                           decode_steps=9, turns=1, seed=seed + 1,
                           on_turn=on_turn_c)
        c.update(prefill_ms=served["prefill_ms"][0],
                 decode_steps=len(served["decode_ms"]),
                 min_topk_margin=min(margins_c))
    finally:
        srv.close(svc)
    del svc, coll, params, step
    release()
    if c["decode_steps"] != 8 or "score_err" not in c:
        raise AssertionError(f"11c: {c}")
    print(f"  11c [{card}]: projected RAG prefill over PAPER_100K (dim "
          f"{ecfg_c.dim}): ids equal the plain version's, prefill "
          f"{c['prefill_ms']:.3f} ms, 8 decode steps", flush=True)

    # -- 11b: decode matches forward at full width, float32 -------------
    b, _, _ = decode_vs_forward("11b", cfg, seed, g)
    print(f"  11b [{card}]: float32 ({b['weight_GB']:.2f} GB) decode logits "
          f"== forward_train's at {b['positions']} positions, max err "
          f"{b['max_abs_err']:.3g} (tol {SERVE_TOL}; logits up to "
          f"{b['logit_scale']:.1f})", flush=True)

    out["11a"], out["11b"], out["11c"] = a, b, c
    out.update(path_launches(kernels, excluded))
    for k in ("scan_scores", "kmeans_assign", "segsum_gemm"):
        if out["launches"][k] <= 0:
            raise AssertionError(f"phase 11 never launched {k}")
    by = out["launches_by_variant"]["scan_scores"]
    if by["generic"] or by["stream"] != out["launches"]["scan_scores"]:
        raise AssertionError(f"phase 11 scan_scores by variant {by}")
    if c["assign_variants"]["generic"] or not c["assign_variants"]["wgmma"]:
        raise AssertionError(f"11c kmeans_assign {c['assign_variants']}")
    return out


def phase_families(seed: int, card: str) -> dict:
    """The MoE, VLM, SSM and hybrid families on the RAG serving path, each
    at full width with weights from `seed`.  12a: olmoe-1b-7b (16 layers,
    64 experts top-8, 13.8 GB bf16) served beside the PAPER_1M-layout
    memory at dim 2048 as 11a serves granite (`serve_beside_paper_1m`);
    its MoE layer gives the same bits twice at the prefill's shape and a
    finite aux loss.  12b: deepseek-moe-16b, qwen2-vl-7b (M-RoPE at the
    default positions), rwkv6-1.6b and zamba2-2.7b one at a time, each
    freed before the next: one turn of SERVE_REQUESTS x (SERVE_PROMPT +
    SERVE_DECODE) tokens through the projection branch over one
    PAPER_100K memory (dim 1024) while FAMILY_INSERTS rows go in; ids
    equal the plain version's, tokens inside the vocabulary, every insert
    live.  12c: olmoe-1b-7b and zamba2-2.7b in float32, rwkv6-1.6b in
    float64 (`FAMILY_DECODE`), at full width and depth: decode logits
    equal `forward_train`'s within SERVE_TOL; rwkv6's float32 decode and
    forward are measured beside it."""
    from repro_torch.configs import registry
    from repro_torch.configs.ame_paper import PAPER_100K
    from repro_torch.launch import serve as srv
    from repro_torch.models import lm, moe
    from repro_torch.serving import rag

    dev = torch.device("cuda")
    kernels = serving_kernels()
    excluded = {}
    out = {"card": card}
    g = torch.Generator(device=dev).manual_seed(seed + 12)

    # -- 12a: olmoe-1b-7b beside the 1,000,000-row memory ---------------
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_arch(FAMILY_ARCH)
    params, a = made_model("12a", cfg, seed)
    a.update(serve_beside_paper_1m("12a", cfg, params, seed, g, kernels,
                                   excluded))
    a["peak_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    h = torch.randn(SERVE_REQUESTS, SERVE_PROMPT, cfg.d_model, generator=g,
                    device=dev).to(torch.bfloat16)
    y1, aux = moe.moe_apply(params.blocks[0].mlp, h, cfg)
    y2, _ = moe.moe_apply(params.blocks[0].mlp, h, cfg)
    if not torch.equal(y1, y2):
        raise AssertionError("12a: the MoE combine changed its bits")
    a["moe_aux"] = float(aux)
    with torch.no_grad():
        _, aux = lm.forward_train(params, cfg, {"tokens": torch.randint(
            0, cfg.vocab_size, (2, 64), generator=g, device=dev,
            dtype=torch.int32)})
    a["forward_aux"] = float(aux)
    if not (math.isfinite(a["moe_aux"]) and math.isfinite(a["forward_aux"])):
        raise AssertionError(f"12a: aux loss {a['moe_aux']}, "
                             f"{a['forward_aux']}")
    del params, h, y1, y2
    release()
    print_served("12a", card, cfg, a, f"beside {N_ROWS:,} rows at dim "
                 f"{a['dim']} (build {a['build_s']:.3f} s, retrieval "
                 f"{a['retrieval_ms']:.3f} ms)")
    out["12a"] = a

    # -- 12b: the other families over a PAPER_100K memory ---------------
    ecfg = dataclasses.replace(PAPER_100K, k=SERVE_MEM_K)
    x = make_corpus(PROJ_ROWS, ecfg.dim, g)
    svc, coll, stats = srv.build_memory(ecfg, x, device=dev, name="fam")
    del x
    out["12b"] = {"build_s": stats["build_s"]}
    n_live = PROJ_ROWS
    try:
        for i, arch in enumerate(FAMILY_ARCHS):
            torch.cuda.reset_peak_memory_stats()
            cfg = registry.get_arch(arch)
            params, r = made_model(f"12b {arch}", cfg, seed)
            step = rag.make_rag_prefill(cfg, ecfg, SERVE_PROMPT + 10,
                                        k=SERVE_MEM_K, device=dev)
            margins = []

            def on_turn(turn, snap, batch, ids, step=step, params=params,
                        arch=arch, r=r):
                r["score_err"] = check_retrieval(
                    f"12b {arch}", snap, step.query(params, batch["tokens"]),
                    ids, ecfg, margins, kernels, excluded)

            inserts = torch.nn.functional.normalize(
                torch.randn(FAMILY_INSERTS, ecfg.dim, generator=g,
                            device=dev), dim=1)
            served = srv.serve(cfg, ecfg, params, svc, coll,
                               requests=SERVE_REQUESTS,
                               prompt_len=SERVE_PROMPT,
                               decode_steps=SERVE_DECODE, turns=1,
                               inserts=inserts, seed=seed + 2 + i,
                               on_turn=on_turn)
            n_live += FAMILY_INSERTS
            if not torch.equal(live_ids(coll), torch.arange(
                    n_live, dtype=torch.int32, device=dev)):
                raise AssertionError(f"12b {arch}: acknowledged inserts are "
                                     "not all live")
            check_tokens(f"12b {arch}", served, cfg)
            if "score_err" not in r:
                raise AssertionError(f"12b {arch}: no retrieval checked")
            r.update(served_numbers(served), min_topk_margin=min(margins),
                     peak_GiB=torch.cuda.max_memory_allocated() / 2 ** 30)
            del params, step, on_turn
            release()
            print_served("12b", card, cfg, r, f"over PAPER_100K (dim "
                         f"{ecfg.dim}, projected)")
            out["12b"][arch] = r
    finally:
        srv.close(svc)
    del svc, coll
    release()

    # -- 12c: decode matches forward at full width -----------------------
    out["12c"] = {}
    for arch, dtype in FAMILY_DECODE:
        cfg = registry.get_arch(arch)
        b, tokens, full = decode_vs_forward(f"12c {arch}", cfg, seed, g,
                                            dtype)
        note = ""
        if dtype == "float64":
            b.update(float32_reading(f"12c {arch}", cfg, seed, tokens, full))
            note = (f"; in float32 (not held) decode is "
                    f"{b['float32_decode_err']:.3g} from the forward, the "
                    f"forward {b['float32_forward_vs_float64']:.3g} from "
                    f"float64's")
        del full
        print(f"  12c [{card}]: {arch} {dtype} ({b['weight_GB']:.2f} GB) "
              f"decode logits == forward_train's at {b['positions']} "
              f"positions, max err {b['max_abs_err']:.3g} (tol "
              f"{SERVE_TOL}; logits up to {b['logit_scale']:.1f}){note}",
              flush=True)
        out["12c"][arch] = b

    out.update(path_launches(kernels, excluded))
    for k in ("scan_scores", "kmeans_assign", "segsum_gemm"):
        if out["launches"][k] <= 0:
            raise AssertionError(f"phase 12 never launched {k}")
    by = out["launches_by_variant"]["scan_scores"]
    if by["generic"] or by["stream"] != out["launches"]["scan_scores"]:
        raise AssertionError(f"phase 12 scan_scores by variant {by}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the enc-dec family at full width; phase 14: training at full
# width on f32 master weights
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_REQUESTS = 8     # 13a: 8 requests of 256 source frames + 256 tokens
ENCDEC_SEQ = 512        # 13a: synth_batch's window (split in halves)
ENCDEC_DECODE = 32      # 13a: greedy tokens a request
TRAIN_ARCH = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512   # 14a: 4,096 tokens a step
TRAIN_STEPS = 10        # 14a: steps on one repeated batch
TRAIN_LR = 3e-3         # 14a-14c: the reference test's lr, warmup 2
TRAIN_FAMILIES = ("olmoe-1b-7b", "qwen2-vl-7b", "rwkv6-1.6b", "zamba2-2.7b",
                  "seamless-m4t-large-v2")   # 14e: one step each


def synced_ms(fn) -> tuple:
    """(fn(), its wall time in ms with the card synchronized after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_encdec(seed: int, card: str) -> dict:
    """The enc-dec family at full width (seamless-m4t-large-v2: 24 encoder
    and 24 decoder layers, d_model 1024, vocab 256,206 padded to 258,048;
    weights from `seed`).  13a: two rounds of ENCDEC_REQUESTS requests of
    256 source frames and 256 tokens through `serve_step`: a prefill (time
    to first token), then ENCDEC_DECODE greedy steps against the cached
    self and cross K/V; tokens inside the vocabulary.  13b: the model in
    float32, decode logits equal `forward_train`'s within SERVE_TOL (2 x 8
    teacher tokens over 8 source frames)."""
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.serving import serve_step

    dev = torch.device("cuda")
    kernels = serving_kernels()
    cfg = registry.get_arch(ENCDEC_ARCH)
    out = {"card": card, "arch": cfg.name}
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    torch.cuda.reset_peak_memory_stats()
    params, a = made_model("13a", cfg, seed)
    batch = api.synth_batch(g, cfg, "prefill", ENCDEC_REQUESTS, ENCDEC_SEQ)
    s_max = batch["tokens"].shape[1] + ENCDEC_DECODE
    prefill = serve_step.make_prefill(cfg, s_max)
    decode = serve_step.make_decode(cfg)
    a.update(src_frames=batch["src_emb"].shape[1],
             prompt_tokens=batch["tokens"].shape[1], prefill_ms=[])
    for _ in range(2):              # the first round warms the libraries
        (tok, caches, pos), ms = synced_ms(lambda: prefill(params, batch))
        a["prefill_ms"].append(ms)
        toks, dec_ms = [tok], []
        for _ in range(ENCDEC_DECODE - 1):
            pos = pos + 1
            (tok, caches), ms = synced_ms(
                lambda: decode(params, tok, caches, pos))
            toks.append(tok)
            dec_ms.append(ms)
        toks = torch.cat(toks, dim=1)
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError("13a: a token outside the vocabulary")
        if tuple(toks.shape) != (ENCDEC_REQUESTS, ENCDEC_DECODE):
            raise AssertionError(f"13a: tokens {tuple(toks.shape)}")
    del caches
    a.update(decode_p50_ms=float(np.percentile(dec_ms, 50)),
             decode_p95_ms=float(np.percentile(dec_ms, 95)),
             tok_per_s=ENCDEC_REQUESTS * ENCDEC_DECODE
             / ((a["prefill_ms"][-1] + sum(dec_ms)) / 1e3),
             peak_GiB=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, prefill, decode
    release()
    print(f"  13a [{card}]: {cfg.name} ({a['params']:,} params, "
          f"{a['weight_GB']:.2f} GB {cfg.dtype}), {ENCDEC_REQUESTS} requests "
          f"x ({a['src_frames']} frames + {a['prompt_tokens']} tokens): "
          f"prefill (time to first token) "
          f"{[round(t, 3) for t in a['prefill_ms']]} ms, decode p50/p95 "
          f"{a['decode_p50_ms']:.3f}/{a['decode_p95_ms']:.3f} ms/token, "
          f"{a['tok_per_s']:.1f} tok/s, peak {a['peak_GiB']:.1f} GiB",
          flush=True)
    b, _, _ = decode_vs_forward("13b", cfg, seed, g)
    print(f"  13b [{card}]: float32 ({b['weight_GB']:.2f} GB) decode logits "
          f"== forward_train's at {b['positions']} positions, max err "
          f"{b['max_abs_err']:.3g} (tol {SERVE_TOL}; logits up to "
          f"{b['logit_scale']:.1f})", flush=True)
    out["13a"], out["13b"] = a, b
    out.update(path_launches(kernels, {}))
    return out


def _finite(tag, hist) -> None:
    for h in hist:
        for k in ("loss", "grad_norm", "aux"):
            if not math.isfinite(h[k]):
                raise AssertionError(f"{tag}: {k} {h[k]} at step {h['step']}")


def _host_batch(batch) -> dict:
    """A batch on the card as the numpy arrays `Trainer.train` takes
    (floats in f32, which holds a bf16 value exactly)."""
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
            for k, v in batch.items()}


def phase_train(seed: int, card: str) -> dict:
    """Training at full width on f32 master weights.  14a: granite-3-2b
    (2,537,553,920 parameters) through `Trainer` with remat, TRAIN_BATCH x
    TRAIN_SEQ tokens a step, TRAIN_STEPS steps on one repeated batch at lr
    TRAIN_LR (warmup 2): every loss and grad norm finite, the last loss
    below the first.  14b: the same width at 2 layers in float32, grad
    accumulation 2 against 1 (the reference's test: loss to rtol 1e-4, the
    first leaf to rtol 1e-3, atol 1e-5).  14c: bf16 and int8 gradient
    compression, 5 steps each at 4 layers, the loss falls.  14d: 4 layers,
    a checkpoint every 5 steps, a preemption, a fresh `Trainer` restores
    the step and every param and moment leaf `torch.equal`.  14e: one step
    of each other family at full width (2 layers; zamba2 one group of 6,
    seamless 2 + 2), without weight decay: loss, grads and the MoE aux
    finite, every leaf changed (so each had a nonzero gradient)."""
    import itertools
    import shutil
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import api, lm
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    kernels = serving_kernels()
    out = {"card": card}
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    cfg = registry.get_arch(TRAIN_ARCH)
    if not cfg.remat:
        raise AssertionError(f"14a: {cfg.name} without remat")
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                     total_steps=TRAIN_STEPS, seed=seed)

    # -- 14a: granite-3-2b at full width, f32 master weights -------------
    torch.cuda.reset_peak_memory_stats()
    tr, init_ms = synced_ms(lambda: Trainer(cfg, tc, device=dev))
    if {p.dtype for p in tr.params.parameters()} != {torch.float32}:
        raise AssertionError("14a: master weights not all f32")
    batch = _host_batch(api.synth_batch(g, cfg, "train", TRAIN_BATCH,
                                        TRAIN_SEQ))
    hist = tr.train(itertools.repeat(batch), TRAIN_STEPS, log_every=1)
    _finite("14a", hist)
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"14a: loss {hist[0]['loss']} -> "
                             f"{hist[-1]['loss']}")
    step_s = [h["step_s"] for h in hist]
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    p50 = float(np.percentile(step_s[1:], 50))
    a = {"arch": cfg.name, "params": cfg.param_count(),
         "state_GB": 4 * 4 * cfg.param_count() / 1e9, "init_ms": init_ms,
         "tokens_a_step": n_tok, "losses": [h["loss"] for h in hist],
         "grad_norms": [h["grad_norm"] for h in hist], "step_s": step_s,
         "step_p50_s": p50, "tokens_per_s": n_tok / p50,
         "bf16_peak_share": 6 * cfg.param_count() * n_tok / p50 / PEAK_BF16,
         "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}
    del tr, hist
    release()
    if a["peak_GiB"] >= 80:
        raise AssertionError(f"14a: peak {a['peak_GiB']:.1f} GiB")
    print(f"  14a [{card}]: {cfg.name} trained at full width "
          f"({a['params']:,} params; f32 weights, grads and both moments "
          f"{a['state_GB']:.1f} GB), remat, {n_tok} tokens a step: loss "
          f"{a['losses'][0]:.3f} -> {a['losses'][-1]:.3f}, step "
          f"{a['step_s'][0]:.3f} s first, p50 {p50:.3f} s after, "
          f"{a['tokens_per_s']:.0f} tokens/s, "
          f"{100 * a['bf16_peak_share']:.1f} % of the bf16 peak "
          f"(6 N tokens / step), peak {a['peak_GiB']:.1f} GiB", flush=True)
    out["14a"] = a

    # -- 14b: grad accumulation 2 == 1, f32, 2 layers --------------------
    cfg2 = cfg.replace(num_layers=2, dtype="float32")
    b_batch = _host_batch(api.synth_batch(g, cfg2, "train", 4, 64))
    res = {}
    for accum in (1, 2):
        tr = Trainer(cfg2, TrainConfig(grad_accum=accum, learning_rate=1e-3,
                                       seed=seed), device=dev)
        hist = tr.train(itertools.repeat(b_batch), 1, log_every=1)
        _finite(f"14b accum {accum}", hist)
        res[accum] = (hist[0]["loss"], next(tr.params.parameters()).detach())
        del tr
    b = {"loss_1": res[1][0], "loss_2": res[2][0],
         "leaf_max_abs_diff": float((res[1][1] - res[2][1]).abs().max())}
    np.testing.assert_allclose(res[1][0], res[2][0], rtol=1e-4)
    torch.testing.assert_close(res[1][1], res[2][1], rtol=1e-3, atol=1e-5)
    del res
    release()
    print(f"  14b [{card}]: f32, 2 layers: accumulation 2 loss "
          f"{b['loss_2']:.6f} == 1's {b['loss_1']:.6f}, first leaf max diff "
          f"{b['leaf_max_abs_diff']:.3g}", flush=True)
    out["14b"] = b

    # -- 14c: bf16 and int8 gradient compression train -------------------
    cfg4 = cfg.replace(num_layers=4)
    c_batch = _host_batch(api.synth_batch(g, cfg4, "train", TRAIN_BATCH, 128))
    out["14c"] = {}
    for scheme in ("bf16", "int8"):
        tr = Trainer(cfg4, TrainConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                                       grad_compression=scheme, seed=seed),
                     device=dev)
        hist = tr.train(itertools.repeat(c_batch), 5, log_every=1)
        del tr
        _finite(f"14c {scheme}", hist)
        ls = [h["loss"] for h in hist]
        if not ls[-1] < ls[0]:
            raise AssertionError(f"14c {scheme}: loss {ls}")
        out["14c"][scheme] = ls
        print(f"  14c [{card}]: {scheme} compression, 4 layers: loss "
              f"{ls[0]:.3f} -> {ls[-1]:.3f} in 5 steps", flush=True)
    release()

    # -- 14d: checkpoint, preemption, restore in a fresh Trainer ---------
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        d_tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, seed=seed)
        d_batch = _host_batch(api.synth_batch(g, cfg4, "train", 4, 128))
        tr = Trainer(cfg4, d_tc, checkpoint_dir=ck_dir, checkpoint_every=5,
                     device=dev)
        t0 = time.perf_counter()
        tr.train(itertools.repeat(d_batch), 6, log_every=2)
        if tr.step_num != 6 or tr.ckpt.latest_step() != 5:
            raise AssertionError(f"14d: step {tr.step_num}, checkpoint "
                                 f"{tr.ckpt.latest_step()}")
        tr.guard.request()
        tr.train(itertools.repeat(d_batch), 10, log_every=2)
        if tr.step_num != 7 or tr.ckpt.latest_step() != 7:
            raise AssertionError(f"14d: preempted at {tr.step_num}")
        train_s = time.perf_counter() - t0
        tr2, restore_ms = synced_ms(lambda: Trainer(
            cfg4, d_tc, checkpoint_dir=ck_dir, device=dev))
        t0 = time.perf_counter()
        if not tr2.maybe_restore() or tr2.step_num != 7 or not (
                int(tr2.opt_state.step) == int(tr.opt_state.step) == 7):
            raise AssertionError("14d: the restore lost the step")
        restore_s = time.perf_counter() - t0
        n = 0
        for (name, p), (_, q) in zip(tr.params.named_parameters(),
                                     tr2.params.named_parameters()):
            for x, y in ((p, q), (tr.opt_state.mu[name],
                                  tr2.opt_state.mu[name]),
                         (tr.opt_state.nu[name], tr2.opt_state.nu[name])):
                if not torch.equal(x, y):
                    raise AssertionError(f"14d: {name} differs after restore")
                n += 1
        ck_GB = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                    os.walk(ck_dir) for f in fs) / 1e9
        out["14d"] = {"train_s": train_s, "restore_s": restore_s,
                      "leaves_equal": n, "checkpoints_GB": ck_GB}
        del tr, tr2
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    release()
    print(f"  14d [{card}]: 4 layers, checkpoint every 5 steps, preempted at "
          f"step 7; a fresh Trainer restored step 7 and {n} param/moment "
          f"leaves torch.equal ({ck_GB:.2f} GB on disk; 7 steps with saves "
          f"{train_s:.1f} s, restore {restore_s:.1f} s)", flush=True)

    # -- 14e: one step of each other family at full width ----------------
    out["14e"] = {}
    for arch in TRAIN_FAMILIES:
        full = registry.get_arch(arch)
        kw = {"num_layers": 2}
        if full.family == "hybrid":
            kw = {"num_layers": full.shared_block_period}
        elif full.family == "encdec":
            kw = {"num_layers": 4, "num_enc_layers": 2, "num_dec_layers": 2}
        cfg_e = full.replace(**kw)
        e_batch = _host_batch(api.synth_batch(g, cfg_e, "train", 4, 256))
        # no weight decay: a leaf moves only where its gradient is nonzero
        tr = Trainer(cfg_e, TrainConfig(learning_rate=TRAIN_LR,
                                        warmup_steps=2, weight_decay=0.0,
                                        seed=seed), device=dev)
        hist = tr.train(itertools.repeat(e_batch), 1, log_every=1)
        _finite(f"14e {arch}", hist)
        m, params = hist[0], tr.params
        # the same seed draws the model as it was before the step
        before = lm.init_params(torch.Generator(device=dev).manual_seed(seed),
                                cfg_e, master=True)
        same = [k for (k, p), (_, q) in zip(params.named_parameters(),
                                            before.named_parameters())
                if torch.equal(p.detach(), q)]
        if same:
            raise AssertionError(f"14e {arch}: leaves unchanged {same[:5]}")
        if (m["aux"] > 0) != (full.family == "moe"):
            raise AssertionError(f"14e {arch}: aux {m['aux']}")
        out["14e"][arch] = {**m, "layers": kw, "params": sum(
            p.numel() for p in params.parameters())}
        print(f"  14e [{card}]: {arch} ({kw}), one step without weight "
              f"decay: loss {m['loss']:.3f}, aux {m['aux']:.3f}, grad norm "
              f"{m['grad_norm']:.3f}, every leaf changed, "
              f"{1e3 * m['step_s']:.0f} ms", flush=True)
        del tr, params, before
        release()
    out.update(path_launches(kernels, {}))
    return out


# ---------------------------------------------------------------------------
# phase 15: the dry run of the grid, and three cells against it on the card
# ---------------------------------------------------------------------------

DRY_BUDGET_S = 120      # 15a: host seconds for the 40-cell grid
DRY_ARCH = "granite-3-2b"
DRY_SEQ = 4096          # 15b train: train_4k's sequence
DRY_PREFILL = (1, 32_768)       # 15b prefill: (batch, prompt tokens)
DRY_DECODE = (8, 32_768)        # 15b decode: (batch, cache slots)
# 15b train: the predicted peak at most this share of the card, leaving room
# for the top of DRY_PEAK_BAND and the allocator's fragmentation
DRY_FIT = 0.75
DRY_PEAK_BAND = (0.8, 1.25)     # 15b: measured / predicted temp bytes
DRY_WARM = 5            # 15b: timed steps after the counted one


class _GlobalScope:
    """A stand-in for FlopCounterMode's module tracker, which puts gradient
    hooks on every module's inputs and outputs: on a train step with remat
    they hold each recomputed layer's activations in reference cycles until
    the collector runs (the counted granite step ran out of memory at B = 2
    and 4).  The count needs no module breakdown: every op counts in the
    global scope."""
    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def phase_dryrun(seed: int, card: str) -> dict:
    """15a (`dry_grid`), then 15b (`dry_cells`), the kernels' launch counts
    set to 0 just before: none may launch."""
    kernels = serving_kernels()
    out = {"card": card}
    out["15a"], out["15a_s"] = dry_grid(card)
    out["15b"] = dry_cells(seed, card)
    out.update(path_launches(kernels, {}))
    if any(out["launches"].values()):
        raise AssertionError(f"15: kernel launches {out['launches']}")
    return out


def dry_grid(card: str):
    """15a: `repro_torch.launch.dryrun` over the 40-cell grid at full width
    on the meta device (10 archs x train_4k, prefill_32k, decode_32k,
    long_500k; 8 cells skipped for the reference's reason): each record's
    parameter count equals `accounting.param_count`, its H100 roofline
    terms printed; at most DRY_BUDGET_S host seconds in all.  Returns
    ({cell: terms}, seconds)."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import accounting

    cells = {}
    t0 = time.perf_counter()
    skipped = 0
    for arch in registry.list_archs():
        for shape in dryrun.SHAPES:
            rec = dryrun.run_cell(arch, shape)
            if rec["status"] == "skipped":
                skipped += 1
                print(f"  15a [{card}]: {arch} x {shape}: skipped "
                      f"({rec['reason']})", flush=True)
                continue
            if rec["status"] != "ok":
                raise AssertionError(f"15a: {arch} x {shape} {rec['status']}:"
                                     f" {rec.get('error')}")
            if rec["params"] != accounting.param_count(
                    registry.get_arch(arch)):
                raise AssertionError(f"15a: {arch} params {rec['params']}")
            t = roofline.terms(rec)
            cells[f"{arch}/{shape}"] = {
                k: t[k] for k in ("compute_s", "memory_s", "collective_s",
                                  "dominant", "useful_ratio", "fits_hbm",
                                  "hbm_resident_gib")} | {
                "trace_s": rec["trace_s"], "traces": rec["traces"]}
            print(f"  15a [{card}]: {arch} x {shape}: compute "
                  f"{t['compute_s']:.4g} s, memory {t['memory_s']:.4g} s, "
                  f"collective {t['collective_s']:.4g} s, dominant "
                  f"{t['dominant']}, useful {t['useful_ratio']:.3f}, fits_hbm "
                  f"{t['fits_hbm']} ({t['hbm_resident_gib']:.1f} GiB), "
                  f"{rec['trace_s']:.2f} s ({rec['traces']} traces)",
                  flush=True)
    secs = time.perf_counter() - t0
    if skipped != 8 or len(cells) != 32:
        raise AssertionError(f"15a: {len(cells)} cells, {skipped} skipped "
                             "(32 and 8)")
    if secs > DRY_BUDGET_S:
        raise AssertionError(f"15a: {secs:.1f} s > {DRY_BUDGET_S} s")
    print(f"  15a [{card}]: 32 cells dry-run, 8 skipped, in {secs:.1f} s "
          f"(limit {DRY_BUDGET_S} s)", flush=True)
    return cells, secs


def dry_cells(seed: int, card: str) -> dict:
    """15b: granite-3-2b at full width in three cells cut only in batch
    (train at S = 4096 on f32 master weights with remat, at the largest
    batch whose dry-run peak takes at most DRY_FIT of the card; prefill of
    32,768 tokens at B = 1; decode over a 32,768-slot cache at B = 8), each
    dry-run and then run with tensors from `seed`: the dot FLOPs
    ``FlopCounterMode`` counts on the card equal the dry run's, the
    arguments' bytes equal the dry run's, the peak allocated above them
    lies within DRY_PEAK_BAND of the dry run's temp bytes, and the median
    of DRY_WARM timed steps stands beside the roofline bound max(compute,
    memory): the step's share of the H100 roofline."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, op_analysis, roofline
    from repro_torch.models import api, lm
    from repro_torch.train import optimizer, train_step

    dev = torch.device("cuda")
    out = {}
    cfg = registry.get_arch(DRY_ARCH)
    capacity = torch.cuda.get_device_properties(0).total_memory
    for b in (8, 4, 2, 1):
        train = ShapeConfig(f"train_{DRY_SEQ}_b{b}", "train", DRY_SEQ, b)
        rec = dryrun.analyze(dryrun.trace_cell(cfg, train)[0], cfg, train)
        if rec["memory_analysis"]["peak_memory_in_bytes"] \
                <= DRY_FIT * capacity:
            break
    else:
        raise AssertionError("15b: no train batch fits the card")
    cells = [(train, rec)]
    for kind, (b, s) in (("prefill", DRY_PREFILL), ("decode", DRY_DECODE)):
        shape = ShapeConfig(f"{kind}_{s}_b{b}", kind, s, b)
        cells.append((shape, dryrun.analyze(
            dryrun.trace_cell(cfg, shape)[0], cfg, shape)))
    full = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}
    print(f"  15b [{card}]: {cfg.name} at full width, cut only in batch: "
          + ", ".join(f"{full[sh.kind]} B={registry.get_shape(full[sh.kind]).global_batch}"
                      f" -> {sh.global_batch}" for sh, _ in cells),
          flush=True)
    for shape, rec in cells:
        g = torch.Generator(device=dev).manual_seed(seed + 15)
        if shape.kind == "train":
            params = train_step.trainable(
                lm.init_params(g, cfg, master=True))
            args = (params, optimizer.init(params),
                    api.synth_batch(g, cfg, "train", shape.global_batch,
                                    shape.seq_len))
        elif shape.kind == "prefill":
            args = (lm.init_params(g, cfg),
                    api.synth_batch(g, cfg, "prefill", shape.global_batch,
                                    shape.seq_len))
        else:
            b, s = shape.global_batch, shape.seq_len
            args = (lm.init_params(g, cfg),
                    torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                                  device=dev, dtype=torch.int32),
                    lm.init_caches(cfg, b, s, device=dev),
                    torch.full((b,), s - 1, dtype=torch.int32, device=dev))
        fn = dryrun.step_fn(cfg, shape)
        mem = rec["memory_analysis"]
        arg_b = op_analysis.storage_bytes(args)[0]
        if arg_b != mem["argument_size_in_bytes"]:
            raise AssertionError(f"15b {shape.name}: argument bytes {arg_b} "
                                 f"!= {mem['argument_size_in_bytes']:.0f}")
        fc = FlopCounterMode(display=False)
        fc.mod_tracker = _GlobalScope()
        with fc:                                      # also warms up
            res = fn(*args)
        del res
        torch.cuda.synchronize()
        flops = fc.get_total_flops()
        dry = rec["hlo_rollup_per_device"]["dot_flops"]
        if flops != dry:
            raise AssertionError(f"15b {shape.name}: FlopCounterMode "
                                 f"{flops} != the dry run's {dry:.0f}")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(DRY_WARM):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = fn(*args)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
            if i == 0:
                peak = torch.cuda.max_memory_allocated() - base
            del res
        ratio = peak / mem["temp_size_in_bytes"]
        t = roofline.terms(rec)
        bound_s = max(t["compute_s"], t["memory_s"])
        med = float(np.median(ms))
        row = {"batch": shape.global_batch, "seq": shape.seq_len,
               "dot_flops": flops, "argument_bytes": arg_b,
               "temp_predicted": mem["temp_size_in_bytes"],
               "temp_measured": peak, "peak_ratio": ratio,
               "hbm_bytes_est": rec["hlo_rollup_per_device"]["hbm_bytes_est"],
               "step_ms": ms, "median_ms": med,
               "compute_ms": 1e3 * t["compute_s"],
               "memory_ms": 1e3 * t["memory_s"],
               "bound_ms": 1e3 * bound_s, "roofline_share": 1e3 * bound_s / med,
               "dot_flops_by_dtype": rec["dot_flops_by_dtype"]}
        out[shape.kind] = row
        print(f"  15b [{card}]: {shape.kind} B={shape.global_batch} "
              f"S={shape.seq_len}: dot FLOPs {flops:.6e} (FlopCounterMode on "
              f"the card) == the dry run's; arguments {arg_b / 2**30:.3f} GiB "
              f"== the dry run's; peak above them {peak / 2**30:.3f} GiB vs "
              f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB predicted "
              f"({ratio:.3f}x); median step {med:.3f} ms over {DRY_WARM} "
              f"({[round(x, 3) for x in ms]}), bound {1e3 * bound_s:.3f} ms "
              f"({'compute' if t['compute_s'] >= t['memory_s'] else 'memory'}"
              f"; compute {1e3 * t['compute_s']:.3f}, memory "
              f"{1e3 * t['memory_s']:.3f}): {row['roofline_share']:.4f} of "
              "the H100 roofline", flush=True)
        if not DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1]:
            raise AssertionError(f"15b {shape.name}: measured / predicted "
                                 f"temp {ratio:.3f} outside {DRY_PEAK_BAND}")
        del args, fn
        release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.ame_paper import PAPER_1M
    from repro_torch.kernels import build

    # 1. device
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    secs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()), flush=True)
    for k, log in build.build_log.items():
        for line in log.splitlines():
            if "Compiling entry" in line:           # the kernel (variant)
                fn = line.split("'")[1]
                print(f"  ptxas {k}: {fn}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {k}: {line.strip()}")

    # 3. kernels vs plain versions (and the scans' lane launches)
    t0 = time.perf_counter()
    kernels = phase_kernels(args.seed, PAPER_1M)
    for k, lanes in phase_lanes(args.seed).items():
        kernels[k]["lanes"] = lanes
    print(f"kernels checked in {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. main path, f32; 5. main path, int8 (after phase 4's memory is
    # freed), each with the launch counts set to 0 just before it
    paths = {}
    for phase, cfg in ((4, PAPER_1M),
                       (5, dataclasses.replace(PAPER_1M, store_dtype="int8"))):
        t0 = time.perf_counter()
        paths[cfg.store_dtype] = out = phase_main(args.seed, cfg)
        print(f"phase {phase}: main path PAPER_1M {cfg.store_dtype} in "
              f"{time.perf_counter() - t0:.1f} s [{card}]: "
              + json.dumps(out), flush=True)
        release()
    # 6. fused multi-tenant windows (after phase 5's memory is freed), the
    # scans' counts set to 0 just before
    t0 = time.perf_counter()
    paths["fused"] = fused = phase_fused(args.seed, card)
    print(f"phase 6: fused windows in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(fused), flush=True)
    release()
    # 7. residency tiers (after phase 6's memory is freed), the counts set
    # to 0 just before
    t0 = time.perf_counter()
    paths["residency"] = res = phase_residency(args.seed, card)
    print(f"phase 7: residency in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(res), flush=True)
    release()
    # 8. recall-adaptive routing (after phase 7's memory is freed), the
    # counts set to 0 just before
    t0 = time.perf_counter()
    paths["routing"] = rt = phase_routing(args.seed, card)
    print(f"phase 8: routing in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(rt), flush=True)
    release()
    # 9. replication (after phase 8's memory is freed), the counts set to 0
    # just before
    t0 = time.perf_counter()
    paths["replication"] = rp = phase_replication(
        args.seed, card, paths["float32"]["build_s"])
    print(f"phase 9: replication in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(rp), flush=True)
    release()
    # 10. the mesh-sharded tier (after phase 9's memory is freed), the
    # counts set to 0 just before
    t0 = time.perf_counter()
    paths["sharded"] = sh = phase_sharded(args.seed, card)
    print(f"phase 10: sharded tier in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(sh), flush=True)
    release()
    # 11. the RAG serving path (after phase 10's memory is freed), the
    # counts set to 0 just before
    t0 = time.perf_counter()
    paths["serving"] = sv = phase_serving(args.seed, card)
    print(f"phase 11: serving in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(sv), flush=True)
    release()
    # 12. the MoE, VLM, SSM and hybrid families on the serving path (after
    # phase 11's memory is freed), the counts set to 0 just before
    t0 = time.perf_counter()
    paths["families"] = fam = phase_families(args.seed, card)
    print(f"phase 12: families in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(fam), flush=True)
    release()
    # 13. the enc-dec family at full width (after phase 12's memory is
    # freed), the counts set to 0 just before (it launches none of them)
    t0 = time.perf_counter()
    paths["encdec"] = ed = phase_encdec(args.seed, card)
    print(f"phase 13: enc-dec in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(ed), flush=True)
    release()
    # 14. training at full width (after phase 13's memory is freed), the
    # counts set to 0 just before (it launches none of them)
    t0 = time.perf_counter()
    paths["train"] = trn = phase_train(args.seed, card)
    print(f"phase 14: training in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(trn), flush=True)
    release()
    # 15. the dry run of the grid and three granite-3-2b cells against it
    # (after phase 14's memory is freed), the counts set to 0 just before
    # (it launches none of them)
    t0 = time.perf_counter()
    paths["dryrun"] = dry = phase_dryrun(args.seed, card)
    print(f"phase 15: dry run in {time.perf_counter() - t0:.1f} s "
          f"[{card}]: " + json.dumps(dry), flush=True)
    release()
    f32, q8 = paths["float32"], paths["int8"]
    for path in ("full_scan", "probed"):
        key = f"recall10_{path}"
        if q8[key] < 0.95 * f32[key]:
            raise AssertionError(f"int8 {key} {q8[key]:.4f} < 0.95 x f32's "
                                 f"{f32[key]:.4f}")
    for kernel, entry in kernels.items():
        by_path = {dtype: p["launches"].get(kernel, 0)
                   for dtype, p in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if kernel in f32["launches_by_variant"]:
            entry["launches_by_variant"] = {
                v: sum(p["launches_by_variant"].get(kernel, {}).get(v, 0)
                       for p in paths.values())
                for v in f32["launches_by_variant"][kernel]}
        if "lanes" in entry:
            entry["lanes"]["launches_fused"] = fused["launches"][kernel]
            entry["lanes"]["launches_by_lanes_fused"] = \
                fused["launches_by_lanes"][kernel]

    print(card)                  # nvidia-smi name, power.limit
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
