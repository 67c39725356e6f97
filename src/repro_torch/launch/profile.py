"""Dry-run profiler: where do a step's FLOPs and bytes come from?
(``python -m repro_torch.launch.profile --arch A --shape S [--what
hbm|collectives] [--multi-pod] [--top 15]``).

Port of ``src/repro/launch/profile.py``, which attributes a compiled
cell's fusion HBM traffic and collective wire bytes to the jax-level op
that emitted them (``op_name`` metadata), with while-loop trip counts
applied.  Here the dry run's record already holds its counts by module
path (`op_analysis`, layer indices folded to ``*``, trip counts applied),
so `attribute` sorts them.  ``--what collectives`` traces the step over
the reference's production mesh (16 x 16, or 2 x 16 x 16 with
``--multi-pod``) and attributes each collective's
wire bytes by kind and `sharding.scope` path (``blocks.*.mlp.wi``: a
leaf's FSDP gather, ``blocks.*``: a layer's sums, ``loss``, ``grads.*``:
the replicas' gradient sums); ``--what hbm`` reads one H100's step unless
``--multi-pod`` names the 2 x 16 x 16 mesh.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Tuple, Union

from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.models import specs


def attribute(record_or_cell: Union[Dict[str, Any], Tuple[str, str]],
              what: str = "collectives",
              mesh=None) -> List[Tuple[float, str, str]]:
    """[(bytes, kind, module path)], largest first.  `record_or_cell` is a
    dry-run record or an (arch, shape) pair to dry-run (over `mesh`, axis
    sizes, when given).  ``hbm``: each module path's HBM bytes (they sum to
    the record's ``hbm_bytes_est``); ``collectives``: each (kind, path)'s
    wire bytes one device moves (they sum to ``collective_bytes_total``;
    none on one card)."""
    if what not in ("collectives", "hbm"):
        raise ValueError(f"what={what!r}: 'collectives' or 'hbm'")
    rec = record_or_cell
    if not isinstance(rec, dict):
        arch, shape = rec
        rec = dryrun.run_cell(arch, shape, mesh=mesh)
        if rec["status"] != "ok":
            raise ValueError(f"{arch} x {shape}: {rec['status']} "
                             f"({rec.get('reason') or rec.get('error')})")
    if what == "collectives":
        return sorted(((float(b), kind, path) for path, d in
                       rec.get("collective_by_module", {}).items()
                       for kind, b in d.items()), reverse=True)
    return sorted(((float(d["hbm_bytes"]), "hbm", path)
                   for path, d in rec["by_module"].items()), reverse=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--shape", required=True, choices=dryrun.SHAPES)
    ap.add_argument("--what", default="collectives",
                    choices=("collectives", "hbm"))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 mesh instead of 16x16")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    mesh = specs.mesh_sizes(args.multi_pod) \
        if args.what == "collectives" or args.multi_pod else None
    rec = dryrun.run_cell(args.arch, args.shape, mesh=mesh)
    if rec["status"] != "ok":
        raise SystemExit(f"{args.arch} x {args.shape}: {rec['status']} "
                         f"({rec.get('reason') or rec.get('error')})")
    rows = attribute(rec, args.what)
    if args.what == "collectives":
        print(f"{args.arch} x {args.shape} on {rec['mesh']} — top "
              "collectives by kind and path, GB (wire bytes per device, "
              "per step)")
        for b, kind, path in rows[: args.top]:
            print(f"{b / 1e9:9.3f}  {kind:18s} {path}")
        return
    print(f"{args.arch} x {args.shape} on {rec['mesh']} — top {args.what} "
          "by module, GB (one device, per step), beside the module's dot "
          "TFLOP")
    for b, _, path in rows[: args.top]:
        flops = rec["by_module"][path]["dot_flops"]
        print(f"{b / 1e9:11.2f}  {flops / 1e12:11.3f}  {path}")


if __name__ == "__main__":
    main()
