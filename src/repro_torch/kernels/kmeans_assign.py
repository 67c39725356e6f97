"""Streaming k-means assignment: wrapper of ``csrc/kmeans_assign.cu``.

Port of ``src/repro/kernels/kmeans_assign.py::kmeans_assign`` (the Pallas
TPU kernel).  A CPU tensor takes the plain version
(`ref.kmeans_assign_ref`); a CUDA tensor launches the kernel, or raises.

The bf16 product has two variants, chosen by `variant_for` from shapes and
alignment alone, never on a failure: ``wgmma`` (centroid stages through a
TMA ring, wgmma from A fragments converted from f32 rows, the argmin folded
from the accumulator; it needs D % 4 == 0 and 16-byte-aligned x and
centroids, and takes every such D) and ``generic`` (WMMA, any shape; also
the f32 products of ``fused_conversion=False``, a register-tiled SGEMM).
``wgmma`` runs in one of two modes, `wgmma_mode(d)`: ``resident`` (a bf16
row tile held for all of D beside a ring of centroid stages in shared
memory, 2-block clusters: D <= 1024, where all four stages fit) and
``streamed`` (no resident tile: a 4-block cluster streams slabs of a
128-row tile, each block against its own centroid tiles, merged per row
through 64-bit keys: D > 1024, the measured crossover).  The sizes
mirror ``csrc/kmeans_assign.cu``'s namespace ``wg``.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.core.spans import span
from repro_torch.kernels import build, ref, scan_stream

ROWS = 64                 # resident rows of x per block (the wgmma M)
CTILE = 256               # centroids per ring stage
KSLAB = 64                # bf16 depth per centroid stage
XCHUNK = 128              # f32 depth per x stage
REG_CHUNKS = 2            # x chunks held in registers as wgmma A fragments
STAGE_BYTES = CTILE * 128
CLUSTER = 2               # blocks sharing each centroid stage
MIN_STAGES = 2
MAX_STAGES = 4
ALIGN = 1024
BAR_BYTES = 2 * MAX_STAGES * 8
MERGE_BYTES = 2 * ROWS * 8
SMEM_LIMIT = 232_448
# the streamed mode
S_CLUSTER = 4             # blocks sharing each slab of x
S_ROWS = 2 * ROWS         # rows of a cluster's row tile
HALF = CTILE // 2         # centroids of a block tile when the C is split
S_XSTAGE_BYTES = S_ROWS * 128     # a 32-deep f32 slab of the row tile
S_XSTAGES = 6             # x ring (slots freed once converted)
S_CSTAGES = 4             # centroid ring (64-deep bf16 slabs of 256)
S_FLAG_BYTES = 16
VARIANTS = ("wgmma", "generic")
MODES = ("resident", "streamed")

launches = build.LaunchCounter()
launches_by_variant = {v: build.LaunchCounter() for v in VARIANTS}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_WGMMA_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ring_stages(d: int) -> int:
    """Centroid stages that fit beside the resident bf16 row tile (its
    first `REG_CHUNKS` depth chunks are held in registers when it has
    more)."""
    chunks = -(-d // XCHUNK)
    reg = REG_CHUNKS if chunks > REG_CHUNKS else 0
    tile = ROWS * (chunks - reg) * XCHUNK * 2
    fixed = ALIGN + tile + BAR_BYTES + MERGE_BYTES
    return min(MAX_STAGES, (SMEM_LIMIT - fixed) // STAGE_BYTES)


def wgmma_mode(d: int) -> str:
    """The `wgmma` variant's mode at depth d: ``resident`` where the row
    tile leaves room for all `MAX_STAGES` ring stages (D <= 1024), else
    ``streamed``.  The resident kernel takes D up to 1536 (`MIN_STAGES`
    stages), but with fewer stages the streamed mode is the faster one on
    an H100 (``tools/profile_port.py --assign-sweep``, PERF.md §5)."""
    return "resident" if ring_stages(d) >= MAX_STAGES else "streamed"


def variant_for(m: int, c: int, d: int, *ptrs: int,
                fused_conversion: bool = True) -> str:
    """``wgmma`` or ``generic`` for M = m rows against c centroids of depth
    d, given the base addresses of x and the centroids."""
    if (not fused_conversion or d % 4 or any(p % 16 for p in ptrs)
            or m >= 2 ** 31 - CLUSTER * ROWS):
        return "generic"
    return "wgmma"


def _counted_tiles(m: int) -> int:
    """Row tiles of the grid's tile pairs (mirror of `counted_tiles`)."""
    return _round_up(-(-m // ROWS), CLUSTER)


def _streamed_tiles(m: int) -> int:
    """Row tiles of the streamed mode (mirror of `s_tiles`)."""
    return -(-m // S_ROWS)


def tile_width(m: int, sms: int) -> int:
    """Centroids of a streamed block tile: 256, or 128 when the row tiles'
    clusters leave the card idle (the C split then reaches twice the
    SMs)."""
    return CTILE if _streamed_tiles(m) * S_CLUSTER >= sms else HALF


def c_split(m: int, c: int, sms: int, mode: str = "resident") -> int:
    """Centroid slices of a `wgmma` launch: 1 when the row tiles' clusters
    fill the card, else as many slices (each the same number of centroid
    tiles: one tile a slice in the resident mode, one tile for each of the
    cluster's 4 blocks in the streamed one) as keep about `sms` blocks
    busy."""
    if mode == "resident":
        units, per_unit = _counted_tiles(m) // CLUSTER, CTILE
        blocks = CLUSTER
    else:
        units = _streamed_tiles(m)
        per_unit, blocks = S_CLUSTER * tile_width(m, sms), S_CLUSTER
    n = -(-c // per_unit)
    want = min(n, max(1, (sms // blocks) // units))
    per = -(-n // want)
    return -(-n // per)


def merge_key(dist: float, idx: int) -> int:
    """The slices' 64-bit merge key (mirror of the kernel's `merge_key`):
    unsigned order equals the order of (dist, idx), -0.0 taken as +0.0."""
    if dist == 0.0:
        dist = 0.0
    u = struct.unpack("<I", struct.pack("<f", dist))[0]
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return (u << 32) | (idx & 0xFFFFFFFF)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  fused_conversion: bool = True, _variant: str | None = None,
                  _mode: str | None = None):
    """(idx i32[M], dist f32[M]): nearest centroid of each row of x f32[M, D]
    under ||c||^2 - 2 x.c (the rank-invariant ||x||^2 dropped), lowest index
    on a tie.  The products are bf16(x) . bf16(c) with f32 accumulation;
    `fused_conversion=False` (an ablation rung) multiplies in f32.
    `_variant` forces a kernel variant and `_mode` the `wgmma` variant's
    mode (for the card tests, ``chip_smoke.py`` and the profiler's sweep;
    the main path passes neither)."""
    if x.device.type == "cpu":
        return ref.kmeans_assign_ref(x, centroids,
                                     fused_conversion=fused_conversion)
    if x.device.type != "cuda":
        raise TypeError(f"kmeans_assign runs on cpu or cuda, not {x.device}")
    m, d = x.shape
    c = centroids.shape[0]
    if centroids.shape != (c, d) or c == 0 or d == 0:
        raise ValueError(f"shapes x{tuple(x.shape)} centroids"
                         f"{tuple(centroids.shape)} do not match")
    for name, t in (("x", x), ("centroids", centroids)):
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"kmeans_assign: {name} must be a contiguous "
                             f"float32 tensor on {x.device}")
    idx = torch.empty((m,), dtype=torch.int32, device=x.device)
    dist = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return idx, dist
    variant = scan_stream.check_forced(
        "kmeans_assign", _variant,
        variant_for(m, c, d, x.data_ptr(), centroids.data_ptr(),
                    fused_conversion=fused_conversion), VARIANTS)
    mode = wgmma_mode(d) if _mode is None else _mode
    if mode not in MODES or (variant != "wgmma" and _mode is not None):
        raise ValueError(f"kmeans_assign: _mode must be one of {MODES}, "
                         "and only with the wgmma variant")
    if mode == "resident" and ring_stages(d) < MIN_STAGES:
        raise ValueError(f"kmeans_assign: the resident mode cannot take "
                         f"D = {d}")
    stream = torch.cuda.current_stream().cuda_stream
    if variant == "wgmma":
        # scratch the kernel's prepare pass fills: the centroids as bf16
        # (zero past C and D), their norms (+inf past C) and, where blocks
        # merge through keys (a split C, or the streamed mode's four blocks
        # a row tile), the rows' merge keys, then a counter per row tile
        cp, dp = _round_up(c, CTILE), _round_up(d, KSLAB)
        cb = torch.empty((cp, dp), dtype=torch.bfloat16, device=x.device)
        cnorm = torch.empty((cp,), dtype=torch.float32, device=x.device)
        sms = _sm_count(x.device)
        split = c_split(m, c, sms, mode)
        if mode == "resident":
            halves = 2
            n_keys = m + _counted_tiles(m) if split > 1 else 0
        else:
            halves = tile_width(m, sms) // HALF
            n_keys = m + _streamed_tiles(m)
        keys = (torch.empty((n_keys,), dtype=torch.int64, device=x.device)
                if n_keys else None)
        fn = build.entry("kmeans_assign", "kmeans_assign_wgmma_launch",
                         _WGMMA_ARGTYPES)
        with span("ame.kernel.kmeans_assign"), torch.cuda.device(x.device):
            err = fn(x.data_ptr(), centroids.data_ptr(), cb.data_ptr(),
                     cnorm.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                     None if keys is None else keys.data_ptr(), m, c, d, cp,
                     dp, split, int(mode == "streamed"), halves, stream)
    else:
        cnorm = (centroids ** 2).sum(1)
        vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0
                   and centroids.data_ptr() % 16 == 0)
        fn = build.entry("kmeans_assign", "kmeans_assign_launch", _ARGTYPES)
        with span("ame.kernel.kmeans_assign"), torch.cuda.device(x.device):
            err = fn(x.data_ptr(), centroids.data_ptr(), cnorm.data_ptr(),
                     idx.data_ptr(), dist.data_ptr(), m, c, d, vec4,
                     int(not fused_conversion), stream)
    build.check_launch("kmeans_assign", err)
    launches.add()
    launches_by_variant[variant].add()
    return idx, dist
