"""Config for --arch qwen2_vl_7b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import QWEN2_VL_7B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
