"""Config for --arch rwkv6_1_6b (see configs/archs.py for provenance)."""
from repro_torch.configs.archs import RWKV6_1_6B as CONFIG
from repro_torch.configs.archs import reduced as _reduced

REDUCED = _reduced(CONFIG)
