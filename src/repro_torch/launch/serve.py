"""Serving entry point of the port: batched RAG generation with the agentic memory.

    python -m repro_torch.launch.serve --arch granite-3-2b --requests 8 \\
        [--device cpu] [--production-mesh]

The counterpart of ``src/repro/launch/serve.py``, with its flags and
defaults: build an IVF memory over a synthetic corpus, accept a batch of
token "requests", embed each, retrieve the top-k memories (the engine's
fused full scan), splice them into the prompt as a soft-prefix embedding,
prefill, then decode N tokens from the KV cache, while concurrent inserts
run through the windowed scheduler (the paper's query-update hybrid
template).  On the card the Hopper kernels run; with ``--device cpu`` their
plain versions do.  ``--production-mesh`` serves the model placed on the
reference's 16 x 16 (data, model) mesh (`repro_torch.launch.mesh`): 256
cards, or with ``--device`` all 256 shards on that one device; the memory
stays one collection on its own device.

Every decoder-only family serves (dense, MoE, VLM, SSM, hybrid), on one
device or placed on the mesh; the enc-dec arch is refused, as the
reference refuses it (``repro_torch.serving.serve_step.generate`` serves
it without the memory, placed or not).  `build_memory` and `serve` are
the body of `main`, callable at any width (``chip_smoke.py`` phases 11
and 12 serve granite-3-2b, olmoe-1b-7b, deepseek-moe-16b, qwen2-vl-7b,
rwkv6-1.6b and zamba2-2.7b at full width through them, and phase 16
granite-3-2b, olmoe-1b-7b, qwen2-vl-7b, rwkv6-1.6b and zamba2-2.7b placed
on a (data, model) mesh of the one card).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api import MemoryOp, MemoryService
from repro_torch.configs import registry
from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.core.scheduler import WindowedScheduler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.models import api, lm, specs
from repro_torch.serving import rag, serve_step

INSERT_CHUNK = 32        # rows a concurrent insert op carries


def build_memory(ecfg: EngineConfig, corpus, *, device: DeviceLike = None,
                 name: str = "serve", mesh: Optional[ShardMesh] = None):
    """A `MemoryService` on its own windowed scheduler, one collection
    `name` built over `corpus`, on `device` (with a model `mesh` and no
    device: its shard 0's).  Returns (service, collection, build stats);
    shut the service and its scheduler down with `close`."""
    if device is None and mesh is not None:
        device = mesh.devices[0]
    sched = WindowedScheduler(window=ecfg.window)
    svc = MemoryService(scheduler=sched, device=device)
    memory = svc.create_collection(name, ecfg)
    stats = svc.build(name, corpus)
    return svc, memory, stats


def close(svc: MemoryService) -> None:
    sched = svc.scheduler
    svc.shutdown()
    sched.shutdown()


def _sync(*devs: torch.device) -> None:
    for dev in set(devs):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, ecfg: EngineConfig, params: lm.LM,
          svc: MemoryService, memory, *, requests: int = 8,
          prompt_len: int = 64, decode_steps: int = 16, turns: int = 1,
          inserts=None, insert_queries: bool = False, seed: int = 0,
          on_turn: Optional[Callable] = None,
          mesh: Optional[ShardMesh] = None) -> dict:
    """`turns` batches of `requests` prompts of `prompt_len` tokens through
    the RAG prefill (the top ``ecfg.k`` memories) and `decode_steps`
    greedy tokens each, on the service's device.  `inserts` (rows) go in
    as concurrent inserts of INSERT_CHUNK rows, submitted before the first
    turn; with
    `insert_queries` each turn's query embeddings go in after it (the
    agent's memory of the turn).  `on_turn(turn, snapshot, batch, ids)`
    sees each turn's memory snapshot and retrieved ids.  Every insert is
    acknowledged before this returns.

    Returns per-turn ids, tokens and times (prefill ms = time to first
    token, decode ms per step), tok/s, each insert's ms on its worker, and
    `inserts`' rows/s from their submission to the last acknowledgement
    (they run while the first turn is served).

    With a `mesh` (or `params` already placed, a `specs.ShardedLM`) the
    model runs over the mesh; the memory stays on the service's device."""
    dev = svc.device
    if mesh is not None and not isinstance(params, specs.ShardedLM):
        params = specs.place_params(params, cfg, mesh)
    devs = (dev, *(params.mesh.devices
                   if isinstance(params, specs.ShardedLM) else ()))
    s_max = prompt_len + decode_steps + 1
    prefill = rag.make_rag_prefill(cfg, ecfg, s_max, k=ecfg.k, device=dev)
    decode = serve_step.make_decode(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    name = memory.name
    futs, rows = [], 0
    t_first_submit = time.perf_counter()
    if inserts is not None:
        for i in range(0, len(inserts), INSERT_CHUNK):
            chunk = inserts[i: i + INSERT_CHUNK]
            futs.append(svc.submit(MemoryOp("insert", name, chunk,
                                            concurrent=True)))
            rows += len(chunk)
    n_bulk = len(futs)
    out = {"turns": [], "prefill_ms": [], "decode_ms": []}
    t_serve = 0.0
    for turn in range(turns):
        batch = api.synth_batch(gen, cfg, "prefill", requests, prompt_len)
        snap = memory.snapshot()
        _sync(*devs)
        t0 = time.perf_counter()
        logits, caches, pos, mem_ids = prefill(params, snap, batch)
        tok = serve_step.greedy(logits, cfg.vocab_size)[:, None]
        _sync(*devs)
        t1 = time.perf_counter()
        toks = [tok]
        for _ in range(decode_steps - 1):
            pos = pos + 1
            ts = time.perf_counter()
            tok, caches = decode(params, tok, caches, pos)
            _sync(*devs)
            out["decode_ms"].append(1e3 * (time.perf_counter() - ts))
            toks.append(tok)
        seq = torch.cat(toks, dim=1)
        _sync(*devs)
        t_serve += time.perf_counter() - t0
        out["prefill_ms"].append(1e3 * (t1 - t0))
        out["turns"].append({"ids": mem_ids.cpu().numpy(),
                             "tokens": seq.cpu().numpy()})
        if on_turn is not None:
            on_turn(turn, snap, batch, mem_ids)
        del snap, caches
        if insert_queries:
            q = rag.embed_query(params, cfg, batch["tokens"])
            futs.append(svc.submit(MemoryOp("insert", name, q,
                                            concurrent=True)))
            rows += q.shape[0]
    for f in futs:
        f.result(timeout=600)
    out["insert_rows"] = rows
    if n_bulk:
        # the rows submitted before the first turn, over the time from
        # their submission to the last one's acknowledgement
        bulk_rows = sum(f.op.batch_size for f in futs[:n_bulk])
        t_ack = max(f.task.end_t for f in futs[:n_bulk])
        out["insert_rows_per_s"] = bulk_rows / (t_ack - t_first_submit)
    out["insert_ms"] = [1e3 * (f.task.end_t - f.task.start_t) for f in futs]
    n_tok = turns * requests * decode_steps
    out["tokens_generated"] = n_tok
    out["tok_per_s"] = n_tok / t_serve
    return out


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "the CPU (plain versions)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=registry.list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--corpus", type=int, default=4096)
    ap.add_argument("--mem-k", type=int, default=4)
    ap.add_argument("--concurrent-inserts", type=int, default=256)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the model on the 16 x 16 (data, model) mesh: 256 "
                    "cards, or every shard on --device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = registry.reduced_arch(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("the server splices memories into decoder-only LMs; "
                         "repro_torch.serving.serve_step.generate serves the "
                         "enc-dec family without the memory")
    ecfg = EngineConfig(dim=cfg.d_model, n_clusters=128, list_capacity=64,
                        nprobe=16, k=args.mem_k)
    mesh = (make_production_mesh(devices=args.device)
            if args.production_mesh else None)
    dev = mesh.devices[0] if mesh is not None else resolve_device(args.device)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                            cfg)
    if mesh is not None:
        params = specs.place_params(params, cfg, mesh)
        print(f"model placed on the mesh {describe(mesh)}")

    # ---- agentic memory: build + concurrent inserts via the scheduler ----
    corpus = np.random.default_rng(args.seed).standard_normal(
        (args.corpus, ecfg.dim), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    svc, memory, stats = build_memory(ecfg, corpus, device=dev)
    try:
        print(f"memory built: {args.corpus} vectors in "
              f"{stats['build_s']:.2f}s")
        ins = np.random.default_rng(args.seed + 1).standard_normal(
            (args.concurrent_inserts, ecfg.dim), dtype=np.float32)
        out = serve(cfg, ecfg, params, svc, memory, requests=args.requests,
                    prompt_len=args.prompt_len,
                    decode_steps=args.decode_steps, inserts=ins,
                    seed=args.seed)
        print(f"retrieved memory ids (req 0): "
              f"{out['turns'][0]['ids'][0].tolist()}")
        print(f"generated {out['tokens_generated']} tokens at "
              f"{out['tok_per_s']:.1f} tok/s on {device_name(dev)} "
              f"(time to first token {out['prefill_ms'][0]:.1f} ms)")
        print(f"memory stats: {memory.stats()}")
        print(f"scheduler: {svc.scheduler.stats()}")
    finally:
        close(svc)
    return out


if __name__ == "__main__":
    main()
