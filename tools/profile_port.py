#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one NVIDIA card.

    python3 tools/profile_port.py [--seed N] [--out FILE]

    python3 tools/profile_port.py --scan-sweep [--out FILE]

    python3 tools/profile_port.py --assign-sweep [--out FILE]

    python3 tools/profile_port.py --fused [--out FILE]

    python3 tools/profile_port.py --host-copy [--out FILE]

    python3 tools/profile_port.py --serving [--arch ARCH] [--mesh DxM] [--out FILE]

    python3 tools/profile_port.py --train [--mesh DxM] [--out FILE]

    python3 tools/profile_port.py --ab-decode TREE [TREE ...] [--out FILE]

For each store policy (f32, then int8), builds the PAPER_1M collection that
``chip_smoke.py`` builds (same synthetic corpus, same seed), warms every op
kind once, then runs each op once more under ``torch.profiler`` (CPU + CUDA
activities) and reports per op: wall time, device busy time (sum of kernel
times — one stream, so kernels do not overlap), device idle share, and
device time by kernel name.  Prints one JSON object (``ops`` keyed by
policy, then by op); with ``--out`` also writes it to FILE.

``--scan-sweep`` instead times both scan kernels' variants over every row
of a PAPER_1M full scan at B = 1, 8, 16, 32 and 64 (CUDA events, f32 rows
and int8 codes from ``--seed``) beside their one-call yardsticks
(``torch.mm`` with TF32, ``torch._int_mm``) and their byte bounds.

``--assign-sweep`` times ``kmeans_assign`` at C = 1024 (PAPER_1M) over D =
1024, 1280, 1408, 1536, 2048 and 4096 and M = 32 (the serving insert),
1024 (an insert batch), 65,536 and 1,000,000 (a build): the ``wgmma``
variant in the mode ``wgmma_mode`` picks and in each mode that can take
the depth (resident up to D = 1536, streamed at every D: the crossover),
and ``generic``, with launches queued behind a spin kernel and timed with
CUDA events in turns, beside the bf16 ``torch.mm`` of the same operands
converted beforehand (the product alone: a lower yardstick) and the least
time the card could take (operations at large M, bytes at small M).

``--fused`` profiles one cross-collection fused window per store policy at
``chip_smoke.py`` phase 6a's size: eight f32 PAPER_100K tenants, then four
int8 ones, each window one ``batch=True`` query per tenant of the phase's
unequal batch sizes (full scans, then the probed template), the stack
cache warmed first; beside each the same queries run per collection.
Reports the same per-op breakdown.

``--host-copy`` times the three ways a residency tier can hold a PAPER_1M
state (f32, then int8) in host memory, each leaf copied on the current
stream and the stream synchronised: (a) pageable — ``Tensor.cpu()`` down,
``Tensor.to("cuda")`` up; (b) page-locked, allocated per demotion
(``torch.empty(..., pin_memory=True)``: the first allocation pins fresh
pages, later ones are served from PyTorch's caching host allocator; the
run also times a fresh pin after ``torch._C._host_emptyCache()``, where
that exists); (c) one page-locked buffer per collection, allocated once
and reused (copies only).  Three demote/promote round trips each, the
first apart; reports seconds, GB/s and host bytes (pinned allocations
rounded up by the caching host allocator).

``--serving`` profiles ``chip_smoke.py`` phase 11a's serving path (12a's
with ``--arch olmoe-1b-7b``): the model of ``--arch`` (default
granite-3-2b) at full width (bf16, from ``--seed``) beside the
1,000,000-row memory at dim d_model in PAPER_1M's layout, each op warmed
first, then one each under the profiler: the retrieval alone (the full
scan at B = 8), the RAG prefill of 8 x 512 tokens, 8 decode steps, and
one 32-row insert; with the same breakdown plus the number of kernels
each op launched (and, for the decode, a step's).  ``--mesh 1x4`` places
the model on a (data, model) mesh of that shape on the one card first
(``chip_smoke.py`` phase 16b's layout for granite-3-2b, 16c's for
olmoe-1b-7b).

``--train`` profiles ``chip_smoke.py`` phase 14a's train step (granite-3-2b
at full width on f32 master weights, remat, 8 x 512 tokens, lr 3e-3 with
warmup 2), warmed by one step first, then one step under the profiler;
then the optimizer's update alone on the same state (random grads); then
one warm decode step of phase 13a's seamless-m4t-large-v2 (8 requests of
256 source frames and 256 tokens, prefilled first).  Same breakdown, with
the peak device memory of the train step.  With ``--mesh 2x4`` the same
train step then runs placed on a (data, model) mesh of that shape on the
one card (``chip_smoke.py`` phase 17b: ``Trainer(mesh=)``'s step, every
shard one after another), warmed and profiled the same way, and its
optimizer update alone on the placed state, in place of the seamless
decode step.

``--ab-decode`` times the one-device decode path of several checkouts in
turn (each TREE the root of one, e.g. the parent commit unpacked with
``git archive`` into a gitignored directory, and ``.``; each in its own
process, in the order given, so ``parent . . parent`` compares two
versions on one card): granite-3-2b at full width (bf16, no memory), a
prefill of 8 x 512 tokens and 32 greedy decode steps, four rounds, the
first left out; the prefill ms of each round and the decode step's p50
and p95 ms.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (repo root on the path above)


def profiled(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] += evt.device_time_total / 1e3  # us -> ms
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    launches = sum(1 for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA)
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "device_kernels": launches,
            "device_idle_share": max(0.0, 1.0 - busy / (1e3 * wall)),
            "kernels_ms": {k[:90]: v for k, v in top}}


def scan_sweep(seed: int) -> dict:
    """ms of each scan variant and its yardstick over the full-scan rows."""
    from repro_torch.configs.ame_paper import PAPER_1M
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan_scores as ss
    from repro_torch.kernels import scan_scores_q8 as q8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    d = PAPER_1M.dim
    n = PAPER_1M.n_clusters * PAPER_1M.list_capacity + 4096
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    out = {"shape": f"N={n} D={d} ip", "f32": {}, "int8": {}}
    db = torch.randn(n, d, generator=g, device=dev)
    for b in (1, 8, 16, 32, 64):
        q = torch.randn(b, d, generator=g, device=dev)
        row = {v: chip_smoke.cuda_ms(
            lambda v=v: ss.scan_scores(q, db, ids, _variant=v), reps=10)
            for v in ("stream", "generic")}
        with chip_smoke.tf32_on():
            row["torch.mm_tf32"] = chip_smoke.cuda_ms(
                lambda: torch.mm(q, db.T), reps=10)
        row["bound"] = 4 * (n * d + n + b * d + b * n) / chip_smoke.PEAK_BYTES * 1e3
        out["f32"][b] = row
    del db
    torch.cuda.empty_cache()
    codes = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                          dtype=torch.int8)
    scales = torch.rand(n, generator=g, device=dev)
    zeros = torch.rand(n, generator=g, device=dev)
    codes_t = codes.t()
    for b in (1, 8, 16, 32, 64):
        qc = torch.randint(-127, 128, (b, d), generator=g, device=dev,
                           dtype=torch.int8)
        sq = torch.rand(b, generator=g, device=dev)
        corr = ref.query_corr(qc, sq)
        row = {v: chip_smoke.cuda_ms(
            lambda v=v: q8.scan_scores_q8(qc, codes, ids, scales, zeros, sq,
                                          corr, _variant=v), reps=20)
            for v in ("stream", "generic")}
        qq = qc if b > 16 else torch.zeros((32, d), dtype=torch.int8,
                                           device=dev)
        row["torch._int_mm"] = chip_smoke.cuda_ms(
            lambda: torch._int_mm(qq, codes_t), reps=20)
        row["bound"] = (n * d + 12 * n + b * d + 8 * b + 4 * b * n) \
            / chip_smoke.PEAK_BYTES * 1e3
        out["int8"][b] = row
    return out


def assign_sweep(seed: int) -> dict:
    """ms of kmeans_assign in each variant and wgmma mode, and of the bf16
    product, over D and M."""
    from repro_torch.configs.ame_paper import PAPER_1M
    from repro_torch.kernels import kmeans_assign as ka

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    c = PAPER_1M.n_clusters
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"C": c, "depths": {}}
    for d in (1024, 1280, 1408, 1536, 2048, 4096):
        cent = torch.randn(c, d, generator=g, device=dev)
        cb = cent.to(torch.bfloat16)
        modes = [m for m in ka.MODES
                 if m == "streamed" or ka.ring_stages(d) >= ka.MIN_STAGES]
        rows = {}
        for m in (32, 1024, 65_536, 1_000_000):
            x = torch.randn(m, d, generator=g, device=dev)
            xb = x.to(torch.bfloat16)
            reps = 50 if m <= 65_536 else 5
            calls = {f"wgmma_{mode}": (lambda mode=mode: ka.kmeans_assign(
                x, cent, _variant="wgmma", _mode=mode)) for mode in modes}
            calls["generic"] = lambda: ka.kmeans_assign(x, cent,
                                                        _variant="generic")
            calls["torch.mm_bf16"] = lambda: torch.mm(xb, cb.t())
            row = chip_smoke.race(calls, reps)
            row["wgmma"] = row[f"wgmma_{ka.wgmma_mode(d)}"]
            row["bound"], row["bound_by"] = chip_smoke.bound_ms(
                4 * (m * d + c * d + 2 * m), 2 * m * c * d,
                chip_smoke.PEAK_BF16)
            row["c_split"] = {mode: ka.c_split(m, c, sms, mode)
                              for mode in modes}
            rows[m] = row
            del x, xb
            torch.cuda.empty_cache()
        out["depths"][d] = {"mode": ka.wgmma_mode(d), "rows": rows}
        del cent, cb
    return out


def fused(seed: int) -> dict:
    """Profiled fused windows (stack cache warm) and per-collection loops."""
    from repro_torch.api import MemoryOp, MemoryService
    from repro_torch.configs.ame_paper import PAPER_100K

    dev = torch.device("cuda")
    out = {}
    for cfg, sizes in ((PAPER_100K, (1, 2, 3, 5, 8, 13, 16, 21)),
                       (dataclasses.replace(PAPER_100K, store_dtype="int8"),
                        (2, 5, 13, 21))):
        with MemoryService(batch_window=64, maintenance=False) as svc:
            reqs = []
            for i, b in enumerate(sizes):
                g = torch.Generator(device=dev).manual_seed(seed + 100 + i)
                x = chip_smoke.make_corpus(100_000, cfg.dim, g)
                svc.create_collection(f"t{i}", cfg, seed=seed + i)
                svc.build(f"t{i}", x, ids=np.arange(100_000) + 1_000_000 * i)
                pick = torch.randint(0, 100_000, (b,), generator=g,
                                     device=dev)
                reqs.append((f"t{i}", chip_smoke.perturb(x[pick], g)))
                del x

            def window(path=None):
                futs = [svc.submit(MemoryOp("query", n, q, path=path,
                                            batch=True)) for n, q in reqs]
                svc.flush()
                for f in futs:
                    f.result(timeout=600)

            def per_collection(path=None):
                for n, q in reqs:
                    svc.query(n, q, path=path)

            window()
            per_collection()
            window("probed")
            per_collection("probed")
            torch.cuda.synchronize()
            out[cfg.store_dtype] = {
                "lanes": len(sizes), "batches": sizes,
                f"fused window ({len(sizes)} lanes)": profiled(window),
                "per-collection loop": profiled(per_collection),
                "fused probed window": profiled(lambda: window("probed")),
                "per-collection probed loop": profiled(
                    lambda: per_collection("probed")),
                "stack_cache": svc.stats()["stack_cache"]}
        del svc
        torch.cuda.empty_cache()
    return out


def host_copy(seed: int) -> dict:
    from repro_torch.configs.ame_paper import PAPER_1M
    from repro_torch.core import index as ivf

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    sync = torch.cuda.synchronize

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    def pinned_like(state):
        return [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in state]

    def down_into(bufs, state):
        return [b.copy_(t, non_blocking=True) for b, t in zip(bufs, state)]

    def up(host):
        return [torch.empty(h.shape, dtype=h.dtype, device=dev).copy_(
            h, non_blocking=True) for h in host]

    empty_host_cache = getattr(torch._C, "_host_emptyCache", None)
    out = {}
    for cfg in (PAPER_1M, dataclasses.replace(PAPER_1M, store_dtype="int8")):
        if empty_host_cache is not None:    # the first pin is a fresh one
            empty_host_cache()
        state = [t for t in ivf.empty_state(cfg, 4096, device=dev)
                 if t is not None]
        for t in state:            # random bits, not zero pages
            if t.dtype.is_floating_point:
                t.normal_(generator=g)
            else:
                t.random_(-100, 100, generator=g)
        nb = sum(t.numel() * t.element_size() for t in state)
        res = {"state_bytes": nb,
               # the caching host allocator's power-of-two blocks
               "pinned_host_bytes_pow2": sum(
                   1 << max(0, (t.numel() * t.element_size() - 1).bit_length())
                   for t in state)}
        reused = pinned_like(state)
        modes = {
            "pageable": lambda: [t.cpu() for t in state],
            "pinned_per_demote": lambda: down_into(pinned_like(state), state),
            "pinned_reused": lambda: down_into(reused, state),
        }
        for mode, down in modes.items():
            runs = []
            for _ in range(3):
                dem, host = timed(down)
                pro, back = timed(lambda: up(host))
                if not all(torch.equal(a, b) for a, b in zip(back, state)):
                    raise AssertionError(f"{mode}: the round trip differs")
                runs.append({"demote_s": dem, "demote_gbps": nb / dem / 1e9,
                             "promote_s": pro,
                             "promote_gbps": nb / pro / 1e9})
                del host, back
            res[mode] = runs
        if empty_host_cache is not None:
            empty_host_cache()
            dem, host = timed(lambda: down_into(pinned_like(state), state))
            res["pinned_fresh_after_empty_cache_s"] = dem
            del host
        if hasattr(torch.cuda, "host_memory_stats"):
            res["host_allocator"] = {
                k: v for k, v in torch.cuda.host_memory_stats().items()
                if k.endswith(".current") or k.endswith(".peak")}
        out[cfg.store_dtype] = res
        del state, reused
        torch.cuda.empty_cache()
    return out


def serving(seed: int, arch: str, mesh_shape=None) -> dict:
    """Profiled ops of phase 11a's serving path with `arch`'s model, on a
    (data, model) mesh of `mesh_shape` on the card if given (see the
    module doc)."""
    from repro_torch.api import MemoryOp
    from repro_torch.configs import registry
    from repro_torch.configs.ame_paper import PAPER_1M
    from repro_torch.launch import serve as srv
    from repro_torch.launch.mesh import model_mesh
    from repro_torch.models import api, lm, specs
    from repro_torch.serving import rag, serve_step

    dev = torch.device("cuda")
    cfg = registry.get_arch(arch)
    ecfg = dataclasses.replace(PAPER_1M, dim=cfg.d_model,
                               k=chip_smoke.SERVE_MEM_K)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    if mesh_shape is not None:
        params = specs.place_params(params, cfg, model_mesh(
            mesh_shape, ("data", "model"), "cuda"))
        chip_smoke.release()
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    x = chip_smoke.make_corpus(chip_smoke.N_ROWS, ecfg.dim, g)
    svc, coll, _ = srv.build_memory(ecfg, x, device=dev)
    del x
    b, s = chip_smoke.SERVE_REQUESTS, chip_smoke.SERVE_PROMPT
    prefill = rag.make_rag_prefill(cfg, ecfg, s + 10, k=ecfg.k, device=dev)
    decode = serve_step.make_decode(cfg)
    batch = api.synth_batch(g, cfg, "prefill", b, s)
    q = rag.embed_query(params, cfg, batch["tokens"])
    rows = torch.nn.functional.normalize(
        torch.randn(32, ecfg.dim, generator=g, device=dev), dim=1)
    state = {}

    def run_prefill():
        logits, caches, pos, _ = prefill(params, coll.snapshot(), batch)
        state.update(tok=serve_step.greedy(logits, cfg.vocab_size)[:, None],
                     caches=caches, pos=pos)

    def run_decode(steps=8):
        tok, caches, pos = state["tok"], state["caches"], state["pos"]
        for _ in range(steps):
            pos = pos + 1
            tok, caches = decode(params, tok, caches, pos)

    def insert():
        svc.submit(MemoryOp("insert", coll.name, rows,
                            concurrent=True)).result(timeout=600)

    ops = {"retrieval B=8": lambda: rag.retrieve(coll.snapshot(), q, ecfg,
                                                 ecfg.k),
           f"RAG prefill {b}x{s}": run_prefill,
           "decode 8 steps": run_decode,
           "insert 32 rows": insert}
    try:
        for fn in ops.values():                 # warm every path once
            fn()
        torch.cuda.synchronize()
        out = {name: profiled(fn) for name, fn in ops.items()}
    finally:
        srv.close(svc)
    out["decode 8 steps"]["kernels_per_step"] = \
        out["decode 8 steps"]["device_kernels"] / 8
    out["model"] = {"arch": cfg.name, "params": cfg.param_count(),
                    "requests": b, "prompt": s, "mesh": mesh_shape}
    return out


def train(seed: int, mesh_shape=None) -> dict:
    """Profiled train step of phase 14a, its optimizer update alone, and
    one decode step of phase 13a, or with `mesh_shape` the train step and
    the update placed on that mesh (see the module doc)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import api, lm
    from repro_torch.serving import serve_step
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import make_train_step, trainable

    dev = torch.device("cuda")
    out = {}
    cfg = registry.get_arch(chip_smoke.TRAIN_ARCH)
    tc = TrainConfig(learning_rate=chip_smoke.TRAIN_LR, warmup_steps=2,
                     total_steps=chip_smoke.TRAIN_STEPS, seed=seed)
    params = trainable(lm.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg, master=True))
    state = {"opt": optimizer.init(params)}
    step = make_train_step(cfg, tc)
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    batch = api.synth_batch(g, cfg, "train", chip_smoke.TRAIN_BATCH,
                            chip_smoke.TRAIN_SEQ)

    def one():
        _, state["opt"], m = step(params, state["opt"], batch)
        state["loss"] = float(m["loss"])

    one()                                       # warm
    torch.cuda.reset_peak_memory_stats()
    out["train step"] = profiled(one)
    out["train step"]["peak_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["train step"]["loss"] = state["loss"]
    grads = {k: torch.randn(p.shape, generator=g, device=dev) * 1e-3
             for k, p in params.named_parameters()}
    out["optimizer update"] = profiled(
        lambda: optimizer.apply_updates(params, grads, state["opt"], tc))
    out["train model"] = {"arch": cfg.name, "params": cfg.param_count(),
                          "tokens": chip_smoke.TRAIN_BATCH
                          * chip_smoke.TRAIN_SEQ, "remat": cfg.remat}
    del params, state, grads
    chip_smoke.release()
    if mesh_shape is not None:
        out.update(mesh_train(seed, cfg, tc, batch, mesh_shape))
        return out

    cfg = registry.get_arch(chip_smoke.ENCDEC_ARCH)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg)
    batch = api.synth_batch(g, cfg, "prefill", chip_smoke.ENCDEC_REQUESTS,
                            chip_smoke.ENCDEC_SEQ)
    s_max = batch["tokens"].shape[1] + chip_smoke.ENCDEC_DECODE
    tok, caches, pos = serve_step.make_prefill(cfg, s_max)(params, batch)
    decode = serve_step.make_decode(cfg)
    cur = {"tok": tok, "pos": pos}

    def dec():
        cur["pos"] = cur["pos"] + 1
        cur["tok"], _ = decode(params, cur["tok"], caches, cur["pos"])

    dec()                                       # warm
    out["seamless decode step"] = profiled(dec)
    out["seamless model"] = {"arch": cfg.name, "params": cfg.param_count(),
                             "requests": chip_smoke.ENCDEC_REQUESTS}
    return out


def mesh_train(seed: int, cfg, tc, batch, mesh_shape) -> dict:
    """`train`'s step and update on a (data, model) mesh of `mesh_shape`
    on the card (the placed params drawn as unsharded, the batch placed
    over the data axes)."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import lm, sharding, specs
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import make_train_step, trainable

    dev = torch.device("cuda")
    mesh = lmesh.model_mesh(mesh_shape, ("data", "model"), "cuda")
    params = trainable(specs.place_params(lm.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg, master=True),
        cfg.replace(dtype="float32"), mesh))
    chip_smoke.release()
    state = {"opt": optimizer.init(params)}
    step = make_train_step(cfg, tc)
    sizes = sharding.axis_sizes(mesh)
    placed = {k: sharding.place(v, specs.batch_spec(sizes, v.shape), mesh)
              for k, v in batch.items()}
    out = {}

    def one():
        with sharding.use_mesh(mesh):
            _, state["opt"], m = step(params, state["opt"], placed)
        state["loss"] = float(m["loss"])

    one()                                       # warm
    torch.cuda.reset_peak_memory_stats()
    key = f"mesh {lmesh.describe(mesh)} train step"
    out[key] = profiled(one)
    out[key]["peak_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out[key]["loss"] = state["loss"]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    grads = {k: torch.randn(p.shape, generator=g, device=dev) * 1e-3
             for k, p in params.named_pieces().items()}
    out[f"mesh {lmesh.describe(mesh)} optimizer update"] = profiled(
        lambda: optimizer.apply_updates(params, grads, state["opt"], tc))
    return out


AB_DECODE = r"""
import json, time, numpy as np, torch
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.serving import serve_step
torch.backends.cuda.matmul.allow_tf32 = False
cfg = registry.get_arch("granite-3-2b")
params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
g = torch.Generator(device="cuda").manual_seed(1)
toks = torch.randint(0, cfg.vocab_size, (8, 512), generator=g, device="cuda",
                     dtype=torch.int32)
pre, dec = [], []
for r in range(4):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    logits, caches, pos = lm.prefill(params, cfg, {"tokens": toks}, 512 + 33)
    tok = serve_step.greedy(logits, cfg.vocab_size)[:, None]
    torch.cuda.synchronize(); pre.append(1e3 * (time.perf_counter() - t0))
    for _ in range(32):
        pos = pos + 1
        t0 = time.perf_counter()
        logits, caches = lm.decode_step(params, cfg, tok, caches, pos)
        tok = serve_step.greedy(logits, cfg.vocab_size)[:, None]
        torch.cuda.synchronize(); dec.append(1e3 * (time.perf_counter() - t0))
print(json.dumps({"prefill_ms": pre[1:],
                  "decode_p50_ms": float(np.median(dec[32:])),
                  "decode_p95_ms": float(np.percentile(dec[32:], 95))}))
"""


def ab_decode(trees) -> list:
    """`AB_DECODE` from each checkout in turn (see the module doc)."""
    out = []
    for tree in trees:
        root = os.path.realpath(tree)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root, os.path.join(root, "src")]))
        run = subprocess.run([sys.executable, "-c", AB_DECODE], cwd=root,
                             env=env, capture_output=True, text=True,
                             check=True)
        out.append({"tree": tree, **json.loads(run.stdout.splitlines()[-1])})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--scan-sweep", action="store_true")
    ap.add_argument("--assign-sweep", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--host-copy", action="store_true")
    ap.add_argument("--serving", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--arch", default=chip_smoke.SERVE_ARCH,
                    help="--serving: the model served (default "
                    f"{chip_smoke.SERVE_ARCH})")
    ap.add_argument("--ab-decode", nargs="+", metavar="TREE", default=None)
    ap.add_argument("--mesh", default=None,
                    help="--serving, --train: DxM, the model on a (data, "
                    "model) mesh of that shape on the card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    if args.ab_decode:
        return _emit({"card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__,
                      "ab_decode": ab_decode(args.ab_decode)}, args.out)
    if args.scan_sweep:
        torch.backends.cuda.matmul.allow_tf32 = False
        return _emit({"card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__,
                      "scan_sweep": scan_sweep(args.seed)}, args.out)
    if args.assign_sweep:
        torch.backends.cuda.matmul.allow_tf32 = False
        return _emit({"card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__,
                      "assign_sweep": assign_sweep(args.seed)}, args.out)
    if args.host_copy:
        return _emit({"card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__,
                      "host_copy": host_copy(args.seed)}, args.out)
    if args.serving:
        torch.backends.cuda.matmul.allow_tf32 = False
        return _emit({"card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__,
                      "serving": serving(args.seed, args.arch, None if
                                         args.mesh is None else tuple(
                                             int(n) for n in
                                             args.mesh.split("x")))},
                     args.out)
    if args.train:
        torch.backends.cuda.matmul.allow_tf32 = False
        return _emit({"card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__,
                      "train": train(args.seed, None if args.mesh is None
                                     else tuple(int(n) for n in
                                                args.mesh.split("x")))},
                     args.out)
    if args.fused:
        torch.backends.cuda.matmul.allow_tf32 = False
        return _emit({"card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__,
                      "fused": fused(args.seed)}, args.out)
    from repro_torch.api import MemoryService
    from repro_torch.configs.ame_paper import PAPER_1M

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    n = 1_000_000
    x = chip_smoke.make_corpus(n, PAPER_1M.dim, g)
    ids = np.arange(n, dtype=np.int32)
    q1 = chip_smoke.perturb(x[:1], g)
    q64 = chip_smoke.perturb(x[1:65], g)
    rows = torch.nn.functional.normalize(
        torch.randn(1024, PAPER_1M.dim, generator=g, device=dev), dim=1)
    next_id = [n]

    def insert():
        svc.insert("mem", rows, ids=np.arange(next_id[0], next_id[0] + 1024,
                                              dtype=np.int32))
        next_id[0] += 1024

    ops = {
        "build 1M rows": lambda: svc.build("mem", x, ids=ids),
        "probed query B=1": lambda: svc.query("mem", q1),
        "full scan B=64": lambda: svc.query("mem", q64),
        "insert 1024 rows": insert,
        "delete 10000 ids": lambda: svc.delete(
            "mem", np.arange(next_id[0] - 10_000, next_id[0])),
        "rebuild": lambda: svc.rebuild("mem"),
    }
    out = {"card": chip_smoke.nvidia_smi(),
           "torch": torch.__version__, "ops": {}}
    for cfg in (PAPER_1M, dataclasses.replace(PAPER_1M, store_dtype="int8")):
        out["ops"][cfg.store_dtype] = timed = {}
        with MemoryService(maintenance=False) as svc:
            svc.create_collection("mem", cfg, seed=args.seed)
            for name, fn in ops.items():        # warm every path once
                fn()
            torch.cuda.synchronize()
            for name, fn in ops.items():
                timed[name] = profiled(fn)
        del svc                 # free this policy's state before the next
        torch.cuda.empty_cache()
    return _emit(out, args.out)


def _emit(out: dict, path) -> int:
    line = json.dumps(out)
    print(line)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
