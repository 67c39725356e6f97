"""Config for --arch gemma2_27b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import GEMMA2_27B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
