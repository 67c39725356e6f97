"""Architecture registry: `--arch <id>` lookup, shapes, reduced smoke configs
(a copy of ``src/repro/configs/registry.py``)."""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs import archs
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES


def get_arch(name: str) -> ModelConfig:
    try:
        return archs.ALL_ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: "
            f"{sorted(archs.ALL_ARCHS)}") from None


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def list_archs() -> List[str]:
    return sorted(archs.ALL_ARCHS)


def reduced_arch(name: str) -> ModelConfig:
    return archs.reduced(get_arch(name))


def cell_enabled(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "quadratic attention at 524k context (skip noted in DESIGN.md)"
    return True, ""


def all_cells(include_skipped: bool = False):
    """Yield (arch_cfg, shape_cfg, enabled, reason) for the 40-cell grid."""
    for a in list_archs():
        cfg = get_arch(a)
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            shape = get_shape(s)
            ok, why = cell_enabled(cfg, shape)
            if ok or include_skipped:
                yield cfg, shape, ok, why
