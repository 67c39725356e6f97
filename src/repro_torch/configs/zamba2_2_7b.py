"""Config for --arch zamba2_2_7b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import ZAMBA2_2_7B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
