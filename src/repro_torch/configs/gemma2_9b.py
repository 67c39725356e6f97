"""Config for --arch gemma2_9b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import GEMMA2_9B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
