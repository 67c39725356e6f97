"""Config for --arch stablelm_12b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import STABLELM_12B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
