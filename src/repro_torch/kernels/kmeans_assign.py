"""Streaming k-means assignment: wrapper of ``csrc/kmeans_assign.cu``.

Port of ``src/repro/kernels/kmeans_assign.py::kmeans_assign`` (the Pallas
TPU kernel).  A CPU tensor takes the plain version
(`ref.kmeans_assign_ref`); a CUDA tensor launches the kernel, or raises.

The bf16 product has two variants, chosen by `variant_for` from shapes and
alignment alone, never on a failure: ``wgmma`` (a resident bf16 row tile,
centroid stages TMA-multicast to a 2-block cluster, wgmma, the argmin folded
from the accumulator; it needs D % 4 == 0, 16-byte-aligned x and centroids,
and room for the row tile and `MIN_STAGES` ring stages in shared memory)
and ``generic`` (WMMA, any shape; also the f32 products of
``fused_conversion=False``).  The sizes mirror ``csrc/kmeans_assign.cu``'s
namespace ``wg``.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

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
VARIANTS = ("wgmma", "generic")

launches = build.LaunchCounter()
launches_by_variant = {v: build.LaunchCounter() for v in VARIANTS}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_WGMMA_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


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


def variant_for(m: int, c: int, d: int, *ptrs: int,
                fused_conversion: bool = True) -> str:
    """``wgmma`` or ``generic`` for M = m rows against c centroids of depth
    d, given the base addresses of x and the centroids."""
    if (not fused_conversion or d % 4 or any(p % 16 for p in ptrs)
            or m >= 2 ** 31 - CLUSTER * ROWS):
        return "generic"
    return "wgmma" if ring_stages(d) >= MIN_STAGES else "generic"


def _counted_tiles(m: int) -> int:
    """Row tiles of the grid's tile pairs (mirror of `counted_tiles`)."""
    return _round_up(-(-m // ROWS), CLUSTER)


def c_split(m: int, c: int, sms: int) -> int:
    """Centroid slices of a `wgmma` launch: 1 when the row tiles' clusters
    fill the card, else as many slices (at most one per 256-centroid tile,
    each the same number of tiles) as keep about `sms` blocks busy."""
    pairs = _counted_tiles(m) // CLUSTER
    n_tiles = -(-c // CTILE)
    want = min(n_tiles, max(1, (sms // CLUSTER) // pairs))
    per = -(-n_tiles // want)
    return -(-n_tiles // per)


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
                  fused_conversion: bool = True, _variant: str | None = None):
    """(idx i32[M], dist f32[M]): nearest centroid of each row of x f32[M, D]
    under ||c||^2 - 2 x.c (the rank-invariant ||x||^2 dropped), lowest index
    on a tie.  The products are bf16(x) . bf16(c) with f32 accumulation;
    `fused_conversion=False` (an ablation rung) multiplies in f32.
    `_variant` forces a kernel variant (for the card tests and
    ``chip_smoke.py``; the main path never passes it)."""
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
    stream = torch.cuda.current_stream().cuda_stream
    if variant == "wgmma":
        # scratch the kernel's prepare pass fills: the centroids as bf16
        # (zero past C and D), their norms (+inf past C) and, when C is
        # split, the slices' merge keys and counters
        cp, dp = _round_up(c, CTILE), _round_up(d, KSLAB)
        cb = torch.empty((cp, dp), dtype=torch.bfloat16, device=x.device)
        cnorm = torch.empty((cp,), dtype=torch.float32, device=x.device)
        split = c_split(m, c, _sm_count(x.device))
        # the rows' merge keys, then a slice counter per row tile
        keys = (torch.empty((m + _counted_tiles(m),), dtype=torch.int64,
                            device=x.device)
                if split > 1 else None)
        fn = build.entry("kmeans_assign", "kmeans_assign_wgmma_launch",
                         _WGMMA_ARGTYPES)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), centroids.data_ptr(), cb.data_ptr(),
                     cnorm.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                     None if keys is None else keys.data_ptr(), m, c, d, cp,
                     dp, split, stream)
    else:
        cnorm = (centroids ** 2).sum(1)
        vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0
                   and centroids.data_ptr() % 16 == 0)
        fn = build.entry("kmeans_assign", "kmeans_assign_launch", _ARGTYPES)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), centroids.data_ptr(), cnorm.data_ptr(),
                     idx.data_ptr(), dist.data_ptr(), m, c, d, vec4,
                     int(not fused_conversion), stream)
    build.check_launch("kmeans_assign", err)
    launches.add()
    launches_by_variant[variant].add()
    return idx, dist
