"""Config for --arch seamless_m4t_large_v2 (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import SEAMLESS_M4T_LARGE_V2 as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
