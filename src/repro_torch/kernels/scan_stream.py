"""Which variant of a scan kernel a call takes: ``stream`` or ``generic``.

The two scans (``csrc/scan_scores.cu``, ``csrc/scan_scores_q8.cu``) each
hold a ``stream`` variant (persistent grid, TMA ring, resident queries; see
``csrc/scan_stream.cuh``) and the ``generic`` one for the shapes the first
does not take.  The choice depends on shapes and pointer alignment only,
never on a failure: TMA needs a 16-byte-aligned base and a row stride that
is a multiple of 16 bytes, and the resident query tile must leave room for
at least `MIN_STAGES` ring stages in shared memory.  The sizes mirror
``csrc/scan_stream.cuh``.

Both kernels also take a lane axis (blockIdx.z): one launch scans G
same-shaped collections.  A lane launch takes the variant a 2-D launch of
one lane would take; `launches_by_lanes` in each wrapper counts G = 1 and
G > 1 launches apart.
"""
from __future__ import annotations

from repro_torch.kernels import build

GROUP_WARPS = 4           # warps of a consumer group, 32 rows each
TILE_ROWS = 32 * GROUP_WARPS  # DB rows per tile
BOX_BYTES = 128           # depth bytes per TMA box (the 128-byte swizzle)
STAGE_BYTES = TILE_ROWS * BOX_BYTES
MAX_STAGES = 8
MIN_STAGES = 4
BARRIERS = 2 * MAX_STAGES + 2
QPAD = 16                 # bytes after each resident query row
ALIGN = 1024
SMEM_LIMIT = 232_448      # opt-in shared memory of a Hopper block
VARIANTS = ("stream", "generic")
LANE_KEYS = ("G=1", "G>1")
MAX_LANES = 65_535        # gridDim.z


def query_tile(b: int) -> int:
    """Queries resident per block: the product's N side."""
    return 8 if b <= 8 else 16 if b <= 16 else 32 if b <= 32 else 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ring_stages(qt: int, qrow_bytes: int, side_bytes: int) -> int:
    """Ring stages that fit beside `qt` resident query rows of
    `qrow_bytes` (+ QPAD each) and `side_bytes` of per-query scalars."""
    fixed = ALIGN + BARRIERS * 8 + qt * (qrow_bytes + QPAD) + side_bytes
    return min(MAX_STAGES, (SMEM_LIMIT - fixed) // STAGE_BYTES)


def choose(b: int, n: int, d: int, elem_bytes: int, ptrs) -> str:
    """The variant for a scan of `b` queries over `n` rows of depth `d`
    stored in `elem_bytes`-byte elements (4: f32 rows whose queries are
    kept as bf16; 1: int8 codes with int8 query codes and two f32 scalars
    each), with the operand base addresses `ptrs`."""
    if (d * elem_bytes) % 16 or any(p % 16 for p in ptrs) or n >= 2 ** 31:
        return "generic"
    qt = query_tile(b)
    dpad = _round_up(d, BOX_BYTES // elem_bytes)
    if elem_bytes == 4:
        stages = ring_stages(qt, 2 * dpad, 0)
    else:
        stages = ring_stages(qt, dpad, 8 * qt)
    return "stream" if stages >= MIN_STAGES else "generic"


def check_forced(name: str, forced: str | None, chosen: str,
                 variants: tuple = VARIANTS) -> str:
    """`forced` (the private `_variant=` of a wrapper) if given and legal,
    else `chosen`.  Forcing the fast variant (`variants[0]`) onto a shape it
    cannot take raises."""
    if forced is None:
        return chosen
    if forced not in variants:
        raise ValueError(f"{name}: _variant must be one of {variants}, "
                         f"got {forced!r}")
    if forced == variants[0] and chosen != forced:
        raise ValueError(f"{name}: this shape/alignment cannot take the "
                         f"{forced} variant")
    return forced


def lane_key(g: int) -> str:
    """The `launches_by_lanes` entry a launch of `g` lanes counts in."""
    return LANE_KEYS[0] if g == 1 else LANE_KEYS[1]


def lane_counters() -> dict:
    return {k: build.LaunchCounter() for k in LANE_KEYS}


def check_lanes(name: str, g: int) -> None:
    if not 1 <= g <= MAX_LANES:
        raise ValueError(f"{name}: {g} lanes; a launch takes 1 to "
                         f"{MAX_LANES}")
