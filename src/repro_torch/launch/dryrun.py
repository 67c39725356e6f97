"""Dry run of one step of every (arch x shape) cell on the ``meta`` device,
at full width: dot FLOPs, HBM bytes and peak live bytes for the roofline
(``python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--out D]``).

The counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each cell for a 512-device TPU mesh without running it.  Here
the step (train, prefill or decode, built as the reference builds them)
runs on tensors with shapes and no storage, so nothing is allocated on any
device, under `op_analysis.OpCounter`; the layer stacks and the model
code's loops are traced cut short and extended to their trip counts
(`op_analysis.extend`).  By default the record is one H100's (``mesh``
``"h100x1"``, ``n_devices`` 1); over a mesh (``--production-mesh``: the
reference's 16 x 16, or 2 x 16 x 16 with ``--multi-pod``;
`run_cell(mesh=)`) the step runs on a model placed on a `ShardMesh` of
meta devices (`specs.place_params`, the mesh paths of `lm` and the train
step), its counts are one device's (the busiest shard's, `op_analysis`),
and the collectives it runs fill ``collective_bytes`` (wire bytes one
device moves, by kind, the reference's ring formulas),
``collective_bytes_total`` and ``collective_raw_bytes``.  The record holds
the reference's keys, so that either package's ``roofline`` reads the
other's records.

- train: the port's `make_train_step` on f32 master weights (the port's
  `Trainer`), AdamW moments in f32, remat per layer with
  ``--remat block`` or ``full`` (``ModelConfig.remat`` on), none with
  ``--remat none``;
- prefill: `lm.prefill` to a cache of ``seq_len`` (the enc-dec family's
  ``seq_len // 2``);
- decode: `lm.decode_step` on caches of ``seq_len`` and a greedy argmax
  over the real vocabulary.

Without a mesh, ``--multi-pod`` and ``--both-meshes`` report the
per-device argument bytes the reference's ``pod2`` / ``pod1`` meshes would
hold (`models.specs`), by formula; a traced mesh's own per-device argument
bytes equal them but for a decode cache that the port holds whole over
'model' where the reference cuts its sequence.  The reference's
``cost_analysis_xla`` (XLA's own count) has no counterpart.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.distributed import ShardMesh
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import describe
from repro_torch.models import api, lm, loops, sharding, specs
from repro_torch.serving import serve_step
from repro_torch.train import optimizer, train_step

MESH = "h100x1"
# a mesh trace's loops are cut to 1 and 2 trips: it costs about shards x
# the one-card trace, and extension from there is exact
# (tests/test_torch_collective_extend*.py: every arch's decode and each
# family's train step against its unrolled trace)
MESH_LO = 1
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
TOP_OPS = 8


# ---------------------------------------------------------------------------
# input_specs: meta tensors for every step input
# ---------------------------------------------------------------------------

def meta_mesh(sizes: Dict[str, int]) -> ShardMesh:
    """A `ShardMesh` of axis `sizes` (``{"data": 16, "model": 16}``) whose
    shards are all on the meta device: what a dry run traces over."""
    shape = tuple(sizes.values())
    return ShardMesh(shape, tuple(sizes),
                     (torch.device("meta"),) * math.prod(shape))


def _placed_batch(batch: Dict[str, torch.Tensor],
                  mesh: ShardMesh) -> Dict[str, sharding.Placed]:
    """Batch tensors placed over the data axes (`specs.batch_spec`, as the
    trainer places its batches), each shard's piece its own."""
    sizes = sharding.axis_sizes(mesh)
    return {k: sharding.place(t, specs.batch_spec(sizes, t.shape), mesh,
                              copy=True) for k, t in batch.items()}


def _mesh_caches(sp: specs.ShardedLM, cfg: ModelConfig,
                 shape: ShapeConfig):
    """The placed caches a decode step of `shape` reads: a prefill of one
    token to a cache of ``seq_len`` (the enc-dec family's cross K/V over
    ``seq_len // 2`` source frames), on the meta device, uncounted."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((b, 1), dtype=torch.int32, device="meta")}
    if cfg.is_encdec:
        batch["src_emb"] = torch.empty((b, s // 2, cfg.d_model),
                                       device="meta")
    return lm.prefill(sp, cfg, batch, s)[1]


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh: Optional[ShardMesh] = None) -> Dict[str, Any]:
    """All step inputs on the meta device (no allocation); with `mesh`
    (of meta devices) the model placed on it (`specs.place_params`), the
    batch placed over its data axes, a decode step's caches placed as its
    prefill places them.

    train  -> {params, opt_state, batch} (f32 master weights requiring
              grad; the optimizer's step counter is the host tensor the
              optimizer reads, the one real tensor)
    prefill-> {params, batch}
    decode -> {params, token, caches, pos}

    The reference's train step also takes a PRNG key (for the int8 codec's
    noise); the port's takes a ``torch.Generator``, none here.
    """
    if mesh is not None:
        return _mesh_inputs(cfg, shape, mesh)
    if shape.kind == "train":
        params = train_step.trainable(
            lm.LM(cfg.replace(dtype="float32"), device="meta"))
        return {"params": params, "opt_state": optimizer.init(params),
                "batch": api.train_batch_specs(cfg, shape)}
    params = lm.LM(cfg, device="meta")
    if shape.kind == "prefill":
        return {"params": params, "batch": api.prefill_batch_specs(cfg, shape)}
    token, caches, pos = api.decode_inputs_specs(cfg, shape)
    return {"params": params, "token": token, "caches": caches, "pos": pos}


def _mesh_inputs(cfg: ModelConfig, shape: ShapeConfig,
                 mesh: ShardMesh) -> Dict[str, Any]:
    if shape.kind == "train":
        c32 = cfg.replace(dtype="float32")
        sp = train_step.trainable(specs.place_params(
            lm.LM(c32, device="meta"), c32, mesh))
        return {"params": sp, "opt_state": optimizer.init(sp),
                "batch": _placed_batch(api.train_batch_specs(cfg, shape),
                                       mesh)}
    sp = specs.place_params(lm.LM(cfg, device="meta"), cfg, mesh)
    if shape.kind == "prefill":
        return {"params": sp, "batch": _placed_batch(
            api.prefill_batch_specs(cfg, shape), mesh)}
    token, _, pos = api.decode_inputs_specs(cfg, shape)
    placed = _placed_batch({"token": token, "pos": pos}, mesh)
    # under a counter each shard's cache is a tensor of its own
    # (`sharding._own`), as a count by shard needs
    with sharding.use_mesh(mesh), sharding.CollectiveCounter():
        caches = _mesh_caches(sp, cfg, shape)
    return {"params": sp, "token": placed["token"], "caches": caches,
            "pos": placed["pos"]}


def step_fn(cfg: ModelConfig, shape: ShapeConfig,
            tc: Optional[TrainConfig] = None, mesh: Optional[ShardMesh] = None):
    """The step of a cell as a function of `input_specs`'s values, in
    their order (over `mesh`, a decode step's greedy token is the serving
    path's argmax across the vocab shards)."""
    if shape.kind == "train":
        step = train_step.make_train_step(cfg, tc or TrainConfig())
        return lambda params, opt_state, batch: step(params, opt_state, batch)
    if shape.kind == "prefill":
        s_max = shape.seq_len // 2 if cfg.is_encdec else shape.seq_len
        return lambda params, batch: lm.prefill(params, cfg, batch, s_max)

    def mesh_decode(params, token, caches, pos):
        logits, caches = lm.decode_step(params, cfg, token, caches, pos)
        return serve_step.greedy(logits, cfg.vocab_size)[:, None], caches

    if mesh is not None:
        return mesh_decode

    def decode(params, token, caches, pos):
        logits, caches = lm.decode_step(params, cfg, token, caches, pos)
        real = torch.arange(logits.shape[-1], device=logits.device) \
            < cfg.vocab_size
        nxt = torch.argmax(torch.where(real, logits, -torch.inf), -1)
        return nxt.to(torch.int32)[:, None], caches
    return decode


# ---------------------------------------------------------------------------
# tracing a cell
# ---------------------------------------------------------------------------

def layer_axes(cfg: ModelConfig) -> Dict[str, Tuple[int, str, int]]:
    """{axis: (trip count, config field, layers a trip)}: the repeated
    layers of a cell.  A trip is one layer, gemma2's local/global pair or
    zamba2's group of mamba layers with the shared block after it; the
    enc-dec stacks are two axes."""
    if cfg.is_encdec:
        return {"enc_layers": (cfg.num_enc_layers, "num_enc_layers", 1),
                "dec_layers": (cfg.num_dec_layers, "num_dec_layers", 1)}
    unit = 1
    if cfg.family == "hybrid":
        unit = cfg.shared_block_period
    elif cfg.alt_local_global and cfg.sliding_window:
        unit = 2
    if cfg.num_layers % unit:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers in trips of "
                         f"{unit}")
    return {"layers": (cfg.num_layers // unit, "num_layers", unit)}


def cut(cfg: ModelConfig, trips: Dict[str, int]) -> ModelConfig:
    """`cfg` with each layer stack cut to ``trips[axis]`` trips."""
    return cfg.replace(**{field: trips[a] * unit for a, (_, field, unit)
                          in layer_axes(cfg).items()})


def trace_cell(cfg: ModelConfig, shape: ShapeConfig,
               tc: Optional[TrainConfig] = None, *, lo: Optional[int] = None,
               unrolled: bool = False, mesh: Optional[ShardMesh] = None
               ) -> Tuple[op_analysis.Counts, int]:
    """The counterpart of the reference's ``lower_cell``: one step of the
    cell traced on meta tensors, over `mesh` (of meta devices: `meta_mesh`)
    when one is given.  Returns (counts, traces run); with `unrolled`, one
    trace of the whole step (every layer, every loop iteration), which
    `extend` must equal.  Loops are cut to `lo` and ``lo + 1`` trips:
    2 and 3 on one card, `MESH_LO` and one more over a mesh.  A mesh whose
    placements change when the layer stacks are cut (a stacked MLP's layer
    axis cut over 'model' only where the depth divides it) is traced
    unrolled."""
    if lo is None:
        lo = 2 if mesh is None else MESH_LO
    def run(ccfg, trips=None):
        inputs = input_specs(ccfg, shape, mesh)
        counter = op_analysis.OpCounter(mesh)
        cut_loops = loops.truncated(trips) if trips else \
            contextlib.nullcontext({})
        with cut_loops as seen, sharding.use_mesh(mesh):
            counter.run(step_fn(ccfg, shape, tc, mesh), *inputs.values())
        return counter.counts, dict(seen)

    if unrolled or (mesh is not None and not _cut_keeps_placements(
            cfg, mesh, lo)):
        counts, n = run(cfg)[0], 1
    else:
        axes = {a: n for a, (n, _, _) in layer_axes(cfg).items()}
        counts, n = op_analysis.extend(
            lambda trips: run(cut(cfg, trips), trips), axes, lo=lo)
    return (counts if mesh is None else op_analysis.busiest(counts)), n


def _cut_keeps_placements(cfg: ModelConfig, mesh: ShardMesh,
                          lo: int) -> bool:
    """Whether the layer stacks cut to `lo` and ``lo + 1`` trips place
    every leaf as the real depth does."""
    sizes = sharding.axis_sizes(mesh)
    real = specs.param_specs(cfg, sizes)
    for k in (lo, lo + 1):
        trips = {a: min(n, k) for a, (n, _, _) in layer_axes(cfg).items()}
        got = specs.param_specs(cut(cfg, trips), sizes)
        if any(real.get(name, p) != p for name, p in got.items()):
            return False
    return True


def tokens_per_step(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return shape.global_batch * (
        1 if shape.is_decode else
        (shape.seq_len // 2 if cfg.is_encdec else shape.seq_len))


def argument_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                              multi_pod) -> int:
    """Bytes of the step's arguments one device of the reference's mesh
    (`multi_pod`: pod2 or pod1, or a mapping of axis sizes) would hold
    under its placements (`models.specs`), by formula; the optimizer's
    moments follow their parameters."""
    sizes = multi_pod if isinstance(multi_pod, dict) else \
        specs.mesh_sizes(multi_pod)
    si = input_specs(cfg, shape)
    params = dict(si["params"].named_parameters())
    place = specs.param_specs(cfg, sizes, params, stacked=True)
    total = sum(specs.shard_bytes(op_analysis.nbytes(p), place[k], sizes)
                for k, p in params.items())
    if shape.kind == "train":
        st = si["opt_state"]
        total += op_analysis.nbytes(st.step) + sum(
            specs.shard_bytes(op_analysis.nbytes(m[k]), place[k], sizes)
            for m in (st.mu, st.nu) for k in m)
    small = {k: v for k, v in si.items() if isinstance(v, torch.Tensor)}
    small.update(si.get("batch", {}))
    total += sum(specs.shard_bytes(op_analysis.nbytes(t),
                                   specs.batch_spec(sizes, t.shape), sizes)
                 for t in small.values())
    if shape.kind == "decode":
        place = specs.cache_specs(cfg, sizes, si["caches"])
        total += sum(specs.shard_bytes(op_analysis.nbytes(t), place[k],
                                       sizes)
                     for k, t in specs.cache_leaves(si["caches"]))
    return total


def analyze(counts: op_analysis.Counts, cfg: ModelConfig,
            shape: ShapeConfig, mesh: Optional[ShardMesh] = None
            ) -> Dict[str, Any]:
    """The record, with the reference's keys.  ``hlo_rollup_per_device``
    keeps the reference's name for interchange (there is no HLO: its
    numbers are `op_analysis`'s; ``collective_bytes`` is empty on one
    card); ``memory_analysis`` holds what the step's arguments, outputs
    (those updated in place as ``alias``) and allocations take, its
    ``temp`` the peak of the step's own live bytes (its fresh outputs
    included, as the card's allocator counts them).  Over a mesh every
    count is one device's: the busiest shard's (``per_device``), and the
    rollup adds ``collective_raw_bytes`` and ``collective_ops`` by kind
    and ``collective_by_module`` (wire bytes by scope path)."""
    tokens = tokens_per_step(cfg, shape)
    mult = 6 if shape.kind == "train" else 2
    args_b, temp_b = counts.argument_bytes, counts.temp_bytes
    wire = {k: float(v) for k, v in sorted(counts.collective_wire.items())}
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": MESH if mesh is None else describe(mesh),
        "n_devices": 1 if mesh is None else mesh.size,
        "tokens_per_step": tokens,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops_total": float(mult * cfg.active_param_count() * tokens),
        "memory_analysis": {
            "argument_size_in_bytes": float(args_b),
            "output_size_in_bytes": float(counts.output_bytes),
            "alias_size_in_bytes": float(counts.alias_bytes),
            "temp_size_in_bytes": float(temp_b),
            "peak_memory_in_bytes": float(args_b + temp_b),
        },
        "hlo_rollup_per_device": {
            "dot_flops": float(counts.dot_flops),
            "collective_bytes": wire,
            "collective_bytes_total": float(sum(
                counts.collective_wire.values())),
            "hbm_bytes_est": float(counts.hbm_bytes_est),
            "hbm_bytes_lower": float(counts.hbm_bytes_lower),
            "hbm_by_op": {k: float(v) for k, v in sorted(
                counts.hbm_by_op.items(), key=lambda kv: -kv[1])[:TOP_OPS]},
        },
        "dot_flops_by_dtype": dict(counts.dot_flops_by_dtype),
        "by_module": counts.by_module,
        "n_ops": counts.n_ops,
    }
    if mesh is None:
        return rec
    roll = rec["hlo_rollup_per_device"]
    roll["collective_raw_bytes"] = {
        k: float(v) for k, v in sorted(counts.collective_raw.items())}
    roll["collective_ops"] = dict(sorted(counts.collective_ops.items()))
    rec["collective_by_module"] = {
        path: {k: float(v) for k, v in d.items()}
        for path, d in counts.collective_by_module.items()}
    per = counts.by_shard
    flops = [d["dot_flops"] for d in per.values()]
    hbm = [d["hbm_bytes"] for d in per.values()]
    rec["per_device"] = {
        "shard": counts.device_shard,
        "shards_differ": len(set(flops)) > 1 or len(set(hbm)) > 1,
        "dot_flops_min_max": [min(flops), max(flops)] if flops else [],
        "hbm_bytes_min_max": [min(hbm), max(hbm)] if hbm else [],
        "note": "every count is one device's: the busiest shard's (by dot "
                "FLOPs, then bytes), with the work on whole values that "
                "every device does"}
    return rec


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def mesh_tag(sizes: Dict[str, int]) -> str:
    """A traced mesh's tag in a record's file name: the reference's
    ``pod1`` / ``pod2``, else `describe`'s ``data=2xmodel=4``."""
    for mp in (False, True):
        if dict(sizes) == specs.mesh_sizes(mp):
            return specs.mesh_tag(mp)
    return "x".join(f"{a}={n}" for a, n in sizes.items())


def run_cell(arch: str, shape_name: str, *, out_dir: Optional[str] = None,
             tc: Optional[TrainConfig] = None, remat: str = "block",
             meshes: Tuple[bool, ...] = (False,), mesh=None
             ) -> Dict[str, Any]:
    """Dry-run one cell; `meshes` lists the reference meshes (False: pod1,
    True: pod2) whose per-device argument bytes the record reports.  With
    `mesh` (a `ShardMesh` or axis sizes: ``specs.mesh_sizes(False)`` is the
    reference's pod1) the step is traced over it, and the record's
    ``argument_bytes_per_device`` is that mesh's formula's."""
    cfg = registry.get_arch(arch).replace(remat=remat != "none")
    shape = registry.get_shape(shape_name)
    if mesh is not None and not isinstance(mesh, ShardMesh):
        mesh = meta_mesh(dict(mesh))
    tag = MESH if mesh is None else mesh_tag(sharding.axis_sizes(mesh))
    ok, why = registry.cell_enabled(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": tag,
               "status": "skipped", "reason": why}
        _dump(rec, out_dir, arch, shape_name, tag)
        return rec
    t0 = time.perf_counter()
    try:
        counts, n_traces = trace_cell(
            cfg, shape, tc or TrainConfig(remat_policy=remat), mesh=mesh)
        rec = analyze(counts, cfg, shape, mesh)
        rec["argument_bytes_per_device"] = {
            specs.mesh_tag(mp): argument_bytes_per_device(cfg, shape, mp)
            for mp in meshes} if mesh is None else {
            tag: argument_bytes_per_device(cfg, shape,
                                           sharding.axis_sizes(mesh))}
        rec.update(status="ok", traces=n_traces,
                   trace_s=round(time.perf_counter() - t0, 3))
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec = {"arch": arch, "shape": shape_name, "mesh": tag,
               "status": "FAILED", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    _dump(rec, out_dir, arch, shape_name, tag)
    return rec


def _dump(rec, out_dir, arch, shape_name, tag=MESH):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all 4)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 mesh instead of its "
                         "16x16 (traced with --production-mesh; else its "
                         "per-device argument bytes only)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="trace the step over the reference's production "
                         "mesh (16x16; 2x16x16 with --multi-pod)")
    ap.add_argument("--out", default="experiments/dryrun_h100")
    ap.add_argument("--remat", default="block",
                    choices=("none", "block", "full"))
    ap.add_argument("--print-memory", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else registry.list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    mesh = specs.mesh_sizes(args.multi_pod) if args.production_mesh \
        else None
    n_fail = 0
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, out_dir=args.out, remat=args.remat,
                           meshes=meshes, mesh=mesh)
            st = rec["status"]
            line = f"[{rec['mesh']}] {a} x {s}: {st}"
            if st == "ok":
                mem = rec["memory_analysis"]
                roll = rec["hlo_rollup_per_device"]
                per_dev = " ".join(
                    f"args/{k}={v / 2**30:.2f}GiB"
                    for k, v in rec["argument_bytes_per_device"].items())
                line += (f"  trace={rec['trace_s']}s ({rec['traces']} traces)"
                         f" args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB"
                         f" peak={mem['peak_memory_in_bytes'] / 2**30:.2f}GiB"
                         f" dotF={roll['dot_flops']:.3e}"
                         f" hbmB={roll['hbm_bytes_est']:.3e}"
                         f" collB={roll['collective_bytes_total']:.3e}"
                         f" {per_dev}")
            elif st == "FAILED":
                n_fail += 1
                line += "  " + rec["error"]
            else:
                line += f"  ({rec['reason']})"
            print(line, flush=True)
            if args.print_memory and st == "ok":
                print("  " + json.dumps(rec["memory_analysis"]), flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells FAILED")


if __name__ == "__main__":
    main()
