"""Config module for --arch starcoder2-7b (see archs.py for the full definition and
source citation; SMOKE is the reduced per-arch smoke-test variant)."""
from repro_torch.configs.archs import STARCODER2_7B as CONFIG
from repro_torch.configs.archs import SMOKE_ARCHS

SMOKE = SMOKE_ARCHS["starcoder2-7b"]
