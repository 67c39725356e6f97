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
   centroid tiles and slices.
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

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports only torch, numpy
and the port (never jax, never the JAX package).
"""
from __future__ import annotations

import argparse
import dataclasses
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


class tf32_on:
    """TF32 tensor-core products inside the block, f32 outside (the script
    runs with TF32 off)."""

    def __enter__(self):
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = False


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

    def race(fns, reps):
        """Device ms of each named call (`queued_ms`), in turns a, b, b, a."""
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(queued_ms(fns[k], reps))
        return {k: sum(v) / len(v) for k, v in ms.items()}

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
    for label, b, n in (("probed", 1, n_probe), ("full", 64, n_full)):
        q, db, ids = randn(b, d), randn(n, d), ids_with_holes(n)
        if ss.variant_for(b, n, d, q.data_ptr(), db.data_ptr()) != "stream":
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
        del q, db, ids
        torch.cuda.empty_cache()
    full, probed = scan_times["full"], scan_times["probed"]
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
            f32_ms = cuda_ms(lambda: ka.kmeans_assign(
                x, cent, fused_conversion=False), reps=3)
        del x, cent, xb, cb
        torch.cuda.empty_cache()
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
        "f32_variant": {"max_abs_err": err_f32, "ms": f32_ms,
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
    x = randn(m_build, d)
    a = torch.randint(0, c, (m_build,), generator=g, device=dev,
                      dtype=torch.int32)
    got = sg.segsum_gemm(x, a, n_clusters=c)
    err = max(err, check_segsum(got, sg.segsum_gemm_plain(x, a,
                                                          n_clusters=c)))
    ms = cuda_ms(lambda: sg.segsum_gemm(x, a, n_clusters=c), reps=10)
    plain = cuda_ms(lambda: sg.segsum_gemm_plain(x, a, n_clusters=c), reps=3)
    acc = torch.zeros(c, d, device=dev)
    a64 = a.long()
    lib = cuda_ms(lambda: acc.index_add_(0, a64, x), reps=10)
    sb, sby = bound_ms(4 * (m_build * d + m_build + c * d + c),
                       m_build * d, PEAK_F32)
    out["segsum_gemm"] = {
        "name": "segsum_gemm", "route": "cuda",
        "source": "src/repro_torch/csrc/segsum_gemm.cu",
        "replaces": "src/repro/kernels/segsum_gemm.py:69",
        "shape": f"M={m_build} C={c} D={d}", "max_abs_err": err, "ms": ms,
        "plain_ms": plain, "bound_ms": sb, "bound_by": sby,
        "library_ms": lib,
        "library_call": "Tensor.index_add_ (f32 rows, atomics)",
    }
    del x, a, a64, acc, got
    torch.cuda.empty_cache()
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
        torch.cuda.empty_cache()
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

    # 3. kernels vs plain versions
    t0 = time.perf_counter()
    kernels = phase_kernels(args.seed, PAPER_1M)
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
        torch.cuda.empty_cache()
    f32, q8 = paths["float32"], paths["int8"]
    for path in ("full_scan", "probed"):
        key = f"recall10_{path}"
        if q8[key] < 0.95 * f32[key]:
            raise AssertionError(f"int8 {key} {q8[key]:.4f} < 0.95 x f32's "
                                 f"{f32[key]:.4f}")
    for kernel, entry in kernels.items():
        by_path = {dtype: p["launches"][kernel] for dtype, p in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if kernel in f32["launches_by_variant"]:
            entry["launches_by_variant"] = {
                v: sum(p["launches_by_variant"][kernel][v]
                       for p in paths.values())
                for v in f32["launches_by_variant"][kernel]}

    print(card)                  # nvidia-smi name, power.limit
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
