"""Config for --arch olmoe_1b_7b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import OLMOE_1B_7B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
