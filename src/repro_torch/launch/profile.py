"""Dry-run profiler: where do a step's FLOPs and bytes come from?
(``python -m repro_torch.launch.profile --arch A --shape S [--what
hbm|collectives] [--top 15]``).

Port of ``src/repro/launch/profile.py``, which attributes a compiled
cell's fusion HBM traffic and collective wire bytes to the jax-level op
that emitted them (``op_name`` metadata), with while-loop trip counts
applied.  Here the dry run's record already holds its counts by
``nn.Module`` path (`op_analysis`, layer indices folded to ``*``, trip
counts applied), so `attribute` sorts them.  One card moves no
collective bytes: ``--what collectives`` says so.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Tuple, Union

from repro_torch.configs import registry
from repro_torch.launch import dryrun


def attribute(record_or_cell: Union[Dict[str, Any], Tuple[str, str]],
              what: str = "collectives") -> List[Tuple[float, str, str]]:
    """[(bytes, kind, module path)], largest first.  `record_or_cell` is a
    dry-run record or an (arch, shape) pair to dry-run.  ``hbm``: each
    module path's HBM bytes (they sum to the record's
    ``hbm_bytes_est``); ``collectives``: none on one card."""
    if what not in ("collectives", "hbm"):
        raise ValueError(f"what={what!r}: 'collectives' or 'hbm'")
    rec = record_or_cell
    if not isinstance(rec, dict):
        arch, shape = rec
        rec = dryrun.run_cell(arch, shape)
        if rec["status"] != "ok":
            raise ValueError(f"{arch} x {shape}: {rec['status']} "
                             f"({rec.get('reason') or rec.get('error')})")
    if what == "collectives":
        return []
    return sorted(((float(d["hbm_bytes"]), "hbm", path)
                   for path, d in rec["by_module"].items()), reverse=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--shape", required=True, choices=dryrun.SHAPES)
    ap.add_argument("--what", default="collectives",
                    choices=("collectives", "hbm"))
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    rec = dryrun.run_cell(args.arch, args.shape)
    if rec["status"] != "ok":
        raise SystemExit(f"{args.arch} x {args.shape}: {rec['status']} "
                         f"({rec.get('reason') or rec.get('error')})")
    rows = attribute(rec, args.what)
    if args.what == "collectives":
        print(f"{args.arch} x {args.shape}: one card ({rec['mesh']}) moves "
              "no collective bytes")
        return
    print(f"{args.arch} x {args.shape} — top {args.what} by module, "
          "GB (one H100, per step), beside the module's dot TFLOP")
    for b, _, path in rows[: args.top]:
        flops = rec["by_module"][path]["dot_flops"]
        print(f"{b / 1e9:11.2f}  {flops / 1e12:11.3f}  {path}")


if __name__ == "__main__":
    main()
