"""Config for --arch granite_3_2b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import GRANITE_3_2B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
