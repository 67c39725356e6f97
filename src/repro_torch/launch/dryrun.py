"""Dry run of one step of every (arch x shape) cell on the ``meta`` device,
at full width: dot FLOPs, HBM bytes and peak live bytes for the roofline
(``python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--out D]``).

The counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each cell for a 512-device TPU mesh without running it.  Here
the step (train, prefill or decode, built as the reference builds them)
runs on tensors with shapes and no storage, so nothing is allocated on any
device, under `op_analysis.OpCounter`; the layer stacks and the model
code's loops are traced cut short and extended to their trip counts
(`op_analysis.extend`).  The port runs on one card, so the record is one
H100's (``mesh`` ``"h100x1"``, ``n_devices`` 1) and holds the
reference's keys, so that either package's ``roofline`` reads the other's
records.

- train: the port's `make_train_step` on f32 master weights (the port's
  `Trainer`), AdamW moments in f32, remat per layer with
  ``--remat block`` or ``full`` (``ModelConfig.remat`` on), none with
  ``--remat none``;
- prefill: `lm.prefill` to a cache of ``seq_len`` (the enc-dec family's
  ``seq_len // 2``);
- decode: `lm.decode_step` on caches of ``seq_len`` and a greedy argmax
  over the real vocabulary.

``--multi-pod`` and ``--both-meshes`` keep only the per-device argument
bytes the reference's ``pod2`` / ``pod1`` meshes would hold
(`models.specs`): the port shards nothing.  The reference's
``cost_analysis_xla`` (XLA's own count) has no counterpart.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import op_analysis
from repro_torch.models import api, lm, loops, specs
from repro_torch.train import optimizer, train_step

MESH = "h100x1"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
TOP_OPS = 8


# ---------------------------------------------------------------------------
# input_specs: meta tensors for every step input
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All step inputs on the meta device (no allocation).

    train  -> {params, opt_state, batch} (f32 master weights requiring
              grad; the optimizer's step counter is the host tensor the
              optimizer reads, the one real tensor)
    prefill-> {params, batch}
    decode -> {params, token, caches, pos}

    The reference's train step also takes a PRNG key (for the int8 codec's
    noise); the port's takes a ``torch.Generator``, none here.
    """
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


def step_fn(cfg: ModelConfig, shape: ShapeConfig,
            tc: Optional[TrainConfig] = None):
    """The step of a cell as a function of `input_specs`'s values, in
    their order."""
    if shape.kind == "train":
        step = train_step.make_train_step(cfg, tc or TrainConfig())
        return lambda params, opt_state, batch: step(params, opt_state, batch)
    if shape.kind == "prefill":
        s_max = shape.seq_len // 2 if cfg.is_encdec else shape.seq_len
        return lambda params, batch: lm.prefill(params, cfg, batch, s_max)

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
               tc: Optional[TrainConfig] = None, *, lo: int = 2,
               unrolled: bool = False) -> Tuple[op_analysis.Counts, int]:
    """The counterpart of the reference's ``lower_cell``: one step of the
    cell traced on meta tensors.  Returns (counts, traces run); with
    `unrolled`, one trace of the whole step (every layer, every loop
    iteration), which `extend` must equal."""
    def trace(trips):
        ccfg = cut(cfg, trips)
        inputs = input_specs(ccfg, shape)
        counter = op_analysis.OpCounter()
        with loops.truncated(trips) as seen:
            counter.run(step_fn(ccfg, shape, tc), *inputs.values())
        return counter.counts, dict(seen)

    if unrolled:
        counter = op_analysis.OpCounter()
        counter.run(step_fn(cfg, shape, tc), *input_specs(cfg, shape).values())
        return counter.counts, 1
    axes = {a: n for a, (n, _, _) in layer_axes(cfg).items()}
    return op_analysis.extend(trace, axes, lo=lo)


def tokens_per_step(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return shape.global_batch * (
        1 if shape.is_decode else
        (shape.seq_len // 2 if cfg.is_encdec else shape.seq_len))


def argument_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                              multi_pod: bool) -> int:
    """Bytes of the step's arguments one device of the reference's mesh
    would hold under its placements (`models.specs`); the optimizer's
    moments follow their parameters."""
    sizes = specs.mesh_sizes(multi_pod)
    si = input_specs(cfg, shape)
    params = dict(si["params"].named_parameters())
    place = specs.param_specs(cfg, sizes, params)
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
            shape: ShapeConfig) -> Dict[str, Any]:
    """The record, with the reference's keys.  ``hlo_rollup_per_device``
    keeps the reference's name for interchange (there is no HLO: its
    numbers are `op_analysis`'s, and ``collective_bytes`` is empty on one
    card); ``memory_analysis`` holds what the step's arguments, outputs
    (those updated in place as ``alias``) and allocations take, its
    ``temp`` the peak of the step's own live bytes (its fresh outputs
    included, as the card's allocator counts them)."""
    tokens = tokens_per_step(cfg, shape)
    mult = 6 if shape.kind == "train" else 2
    args_b, temp_b = counts.argument_bytes, counts.temp_bytes
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": MESH,
        "n_devices": 1,
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
            "collective_bytes": {},
            "collective_bytes_total": 0.0,
            "hbm_bytes_est": float(counts.hbm_bytes_est),
            "hbm_bytes_lower": float(counts.hbm_bytes_lower),
            "hbm_by_op": {k: float(v) for k, v in sorted(
                counts.hbm_by_op.items(), key=lambda kv: -kv[1])[:TOP_OPS]},
        },
        "dot_flops_by_dtype": dict(counts.dot_flops_by_dtype),
        "by_module": counts.by_module,
        "n_ops": counts.n_ops,
    }


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, out_dir: Optional[str] = None,
             tc: Optional[TrainConfig] = None, remat: str = "block",
             meshes: Tuple[bool, ...] = (False,)) -> Dict[str, Any]:
    """Dry-run one cell; `meshes` lists the reference meshes (False: pod1,
    True: pod2) whose per-device argument bytes the record reports."""
    cfg = registry.get_arch(arch).replace(remat=remat != "none")
    shape = registry.get_shape(shape_name)
    ok, why = registry.cell_enabled(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
               "status": "skipped", "reason": why}
        _dump(rec, out_dir, arch, shape_name)
        return rec
    t0 = time.perf_counter()
    try:
        counts, n_traces = trace_cell(
            cfg, shape, tc or TrainConfig(remat_policy=remat))
        rec = analyze(counts, cfg, shape)
        rec["argument_bytes_per_device"] = {
            specs.mesh_tag(mp): argument_bytes_per_device(cfg, shape, mp)
            for mp in meshes}
        rec.update(status="ok", traces=n_traces,
                   trace_s=round(time.perf_counter() - t0, 3))
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
               "status": "FAILED", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    _dump(rec, out_dir, arch, shape_name)
    return rec


def _dump(rec, out_dir, arch, shape_name):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{MESH}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all 4)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="report the per-device argument bytes of the "
                         "reference's 2x16x16 mesh instead of its 16x16")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_h100")
    ap.add_argument("--remat", default="block",
                    choices=("none", "block", "full"))
    ap.add_argument("--print-memory", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else registry.list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    n_fail = 0
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, out_dir=args.out, remat=args.remat,
                           meshes=meshes)
            st = rec["status"]
            line = f"[{MESH}] {a} x {s}: {st}"
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
                         f" hbmB={roll['hbm_bytes_est']:.3e} {per_dev}")
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
