"""Roofline terms of dry-run records on one H100 (``python -m
repro_torch.launch.roofline [--dir D] [--mesh h100x1|pod1|pod2|all]
[--markdown]``).

Port of ``src/repro/launch/roofline.py``, with `H100` in place of the
reference's TPU as the default hardware.  Reads the JSON records of
`repro_torch.launch.dryrun` (or of the reference's dry run: the records
share their keys) and reports, per (arch x shape x mesh) cell:

    compute term    = dot_FLOPs_per_device / peak_FLOP/s        [s]
    memory term     = HBM_bytes_per_device / HBM_bw             [s]
    collective term = wire_bytes_per_device / link_bw           [s]

(one card moves no collective bytes), the dominant term, MODEL_FLOPS =
6*N_active*D (train) or 2*N_active*D (forward-only serving), the
useful-compute ratio MODEL_FLOPS / dot FLOPs, and a projected step time =
max of the three terms (perfect overlap) alongside their sum (no overlap).
``fits_hbm`` holds the step's arguments and temporaries against one
card's 80 GB: most full-size cells do not fit, and the table says so.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.configs.base import H100, HardwareConfig


def terms(rec: Dict[str, Any], hw: HardwareConfig = H100) -> Dict[str, Any]:
    """Roofline terms for one dry-run record (seconds, per step)."""
    roll = rec["hlo_rollup_per_device"]
    n_dev = rec["n_devices"]
    compute_s = roll["dot_flops"] / hw.peak_flops_bf16
    memory_s = roll["hbm_bytes_est"] / hw.hbm_bandwidth
    coll = dict(roll["collective_bytes"])
    collective_s = sum(coll.values()) / hw.ici_bandwidth
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    model_flops_dev = rec["model_flops_total"] / n_dev
    hlo_flops = roll["dot_flops"] or 1.0
    bound = max(compute_s, memory_s, collective_s)
    out = {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_per_dev": model_flops_dev,
        "useful_ratio": model_flops_dev / hlo_flops,
        "step_s_overlap": bound,
        "step_s_serial": compute_s + memory_s + collective_s,
        # fraction of the ideal (pure model-flops compute-bound) step time
        # achievable given the dominant term:
        "roofline_fraction": (model_flops_dev / hw.peak_flops_bf16) / bound
        if bound > 0 else 0.0,
    }
    mem = rec.get("memory_analysis") or {}
    if mem:
        args_b = mem.get("argument_size_in_bytes", 0)
        temp_b = mem.get("temp_size_in_bytes", 0)
        out["hbm_resident_gib"] = (args_b + temp_b) / 2**30
        out["fits_hbm"] = (args_b + temp_b) <= hw.hbm_bytes
    return out


def load_records(d: str, mesh_tag: Optional[str] = "h100x1") -> List[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        if mesh_tag and not p.endswith(f"__{mesh_tag}.json"):
            continue
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def one_liner(t: Dict[str, Any]) -> str:
    fits = {True: "fits", False: "does not fit", None: "?"}[
        t.get("fits_hbm")]
    return (f"{t['arch']:22s} {t['shape']:12s} "
            f"C={t['compute_s']:9.3e} M={t['memory_s']:9.3e} "
            f"K={t['collective_s']:9.3e}  dom={t['dominant']:10s} "
            f"useful={t['useful_ratio']:6.3f} "
            f"roofline={t['roofline_fraction']:6.3f} "
            f"HBM={t.get('hbm_resident_gib', float('nan')):.2f}GiB ({fits})")


def table(records: Iterable[dict], hw: HardwareConfig = H100) -> List[dict]:
    rows = []
    for rec in records:
        if rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh"), "skipped": rec["reason"]})
            continue
        if rec.get("status") == "FAILED":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec.get("mesh"), "failed": rec["error"]})
            continue
        rows.append(terms(rec, hw))
    return rows


def markdown(rows: List[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| useful | roofline | HBM GiB | fits one card |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for t in rows:
        if "skipped" in t:
            lines.append(f"| {t['arch']} | {t['shape']} | — | — | — | "
                         f"skipped: {t['skipped']} | — | — | — | — |")
            continue
        if "failed" in t:
            lines.append(f"| {t['arch']} | {t['shape']} | — | — | — | "
                         f"FAILED | — | — | — | — |")
            continue
        lines.append(
            f"| {t['arch']} | {t['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"{t['dominant']} | {t['useful_ratio']:.3f} | "
            f"{t['roofline_fraction']:.3f} | "
            f"{t.get('hbm_resident_gib', float('nan')):.2f} | "
            f"{'yes' if t.get('fits_hbm') else 'no'} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="experiments/dryrun_h100")
    ap.add_argument("--mesh", default="h100x1",
                    choices=("h100x1", "pod1", "pod2", "all"))
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    recs = load_records(args.dir, None if args.mesh == "all" else args.mesh)
    rows = table(recs)
    if args.markdown:
        print(markdown(rows))
    else:
        for t in rows:
            if "skipped" in t:
                print(f"{t['arch']:22s} {t['shape']:12s} skipped: {t['skipped']}")
            elif "failed" in t:
                print(f"{t['arch']:22s} {t['shape']:12s} FAILED: {t['failed']}")
            else:
                print(one_liner(t))


if __name__ == "__main__":
    main()
