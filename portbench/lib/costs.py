"""The yardstick's peaks and the least time of each memory operation.

Frozen here so that no change to the program can move them.  The peaks are
those of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense rates at the
700 W limit), as `src/repro_torch/configs/base.py` (`HardwareConfig`,
`H100`) and `chip_smoke.py` (`PEAK_*`) give them.  The least time of an
operation is PERF.md's "bound" arithmetic: each input read once and each
output written once, at 3.35 TB/s, or its operations at the peak of their
operands' dtype, whichever is longer.

Each function counts the work that the operation's inputs need, whatever
implements it: it reads the engine's configuration and the operation's
sizes, never a kernel's name, so a change that renames, merges or removes
a kernel leaves these numbers as they are.  An operation of several
passes (k-means) is the sum of its passes.
"""
from __future__ import annotations

from typing import Mapping

PEAK_BYTES = 3.35e12                     # HBM3 bytes/s
PEAK_OPS = {"bfloat16": 989e12,          # dense tensor-core rates
            "int8": 1979e12,
            "float32": 67e12}            # f32 outside the tensor cores

F32, I32, I8 = 4, 4, 1


def least_s(nbytes: float, ops: Mapping[str, float]) -> float:
    """max(bytes / bandwidth, sum over dtypes of operations / peak)."""
    t_ops = sum(n / PEAK_OPS[dtype] for dtype, n in ops.items())
    return max(nbytes / PEAK_BYTES, t_ops)


def _shape(cfg: Mapping) -> tuple:
    return (int(cfg["n_clusters"]), int(cfg["list_capacity"]),
            int(cfg["dim"]))


def _scan_dtype(cfg: Mapping) -> str:
    return cfg["compute_dtype"]


def slots(cfg: Mapping, spill: int) -> int:
    c, l, _ = _shape(cfg)
    return c * l + spill


def full_scan_s(cfg: Mapping, spill: int, b: int) -> float:
    """B queries against every slot of the store, then the top k.

    f32 store: the rows (D f32 a slot) and ids, products at the compute
    dtype.  int8 store: the codes (D bytes a slot), ids, the per-list and
    per-spill-row scale and zero, then the rescore of `rescore_k` rows a
    query in f32 (elementwise products outside the tensor cores)."""
    c, _, d = _shape(cfg)
    n, k = slots(cfg, spill), int(cfg["k"])
    io = b * d * F32 + b * k * (F32 + I32)
    if cfg["store_dtype"] == "int8":
        r = max(int(cfg["rescore_k"]), k)
        nbytes = (n * d * I8 + n * I32 + 2 * (c + spill) * F32
                  + b * r * (d * F32 + I32) + io)
        return least_s(nbytes, {"int8": 2.0 * b * n * d,
                                "float32": 2.0 * b * r * d})
    return least_s(n * (d * F32 + I32) + io,
                   {_scan_dtype(cfg): 2.0 * b * n * d})


def probed_s(cfg: Mapping, spill: int, b: int) -> float:
    """B queries: the centroid scores, then each query's `nprobe` lists and
    the spill buffer.  Lists that several queries probe are read once, so
    at most every list is read; the products are per query."""
    c, l, d = _shape(cfg)
    k, nprobe = int(cfg["k"]), min(int(cfg["nprobe"]), c)
    lists_read = min(b * nprobe, c)
    rows_scanned = nprobe * l + spill
    io = b * d * F32 + b * k * (F32 + I32)
    cent = c * d * F32
    if cfg["store_dtype"] == "int8":
        r = max(int(cfg["rescore_k"]), k)
        nbytes = (cent + lists_read * l * (d * I8 + I32)
                  + lists_read * 2 * F32 + spill * (d * I8 + I32 + 2 * F32)
                  + b * r * (d * F32 + I32) + io)
        return least_s(nbytes, {_scan_dtype(cfg): 2.0 * b * c * d,
                                "int8": 2.0 * b * rows_scanned * d,
                                "float32": 2.0 * b * r * d})
    nbytes = (cent + lists_read * l * (d * F32 + I32)
              + spill * (d * F32 + I32) + io)
    return least_s(nbytes, {_scan_dtype(cfg): 2.0 * b * (c + rows_scanned) * d})


def query_s(cfg: Mapping, spill: int, b: int, path: str) -> float:
    if path == "full_scan":
        return full_scan_s(cfg, spill, b)
    if path == "probed":
        return probed_s(cfg, spill, b)
    raise ValueError(f"no cost function for query path {path!r}")


def insert_s(cfg: Mapping, spill: int, b: int) -> float:
    """B new rows: read them and the centroids, assign each (B x C
    products), write the rows and their ids (int8: and their codes)."""
    c, _, d = _shape(cfg)
    nbytes = b * d * F32 + c * d * F32 + b * (d * F32 + I32)
    if cfg["store_dtype"] == "int8":
        nbytes += b * (d * I8 + 2 * F32)
    return least_s(nbytes, {_scan_dtype(cfg): 2.0 * b * c * d})


def delete_s(cfg: Mapping, spill: int, b: int) -> float:
    """B ids tombstoned: the store keeps no id -> slot map, so every slot's
    id is read once; the B ids read and B slots written."""
    return least_s(slots(cfg, spill) * I32 + 2 * b * I32, {})


def kmeans_s(cfg: Mapping, m: int) -> float:
    """Lloyd's k-means over m rows: `kmeans_iters` passes of assignment
    (m x C products) fused with the centroid update, then the final
    assignment; each pass reads the rows and the centroids once."""
    c, _, d = _shape(cfg)
    passes = int(cfg["kmeans_iters"]) + 1
    one = least_s(m * d * F32 + c * d * F32,
                  {_scan_dtype(cfg): 2.0 * m * c * d, "float32": m * d})
    return passes * one


def pack_s(cfg: Mapping, m: int) -> float:
    """The m assigned rows written into their lists (int8: and encoded)."""
    _, _, d = _shape(cfg)
    nbytes = m * (d * F32 + I32)
    if cfg["store_dtype"] == "int8":
        nbytes += m * d * I8
    return least_s(nbytes, {})


def build_s(cfg: Mapping, spill: int, m: int) -> float:
    return kmeans_s(cfg, m) + pack_s(cfg, m)


def rebuild_s(cfg: Mapping, spill: int, m: int) -> float:
    """Drain lists and spill (every slot's id read once, the m live rows
    read by the first pass), re-cluster, re-pack."""
    return least_s(slots(cfg, spill) * I32, {}) + build_s(cfg, spill, m)
