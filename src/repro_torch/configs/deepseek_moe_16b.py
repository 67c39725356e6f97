"""Config for --arch deepseek_moe_16b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import DEEPSEEK_MOE_16B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
