"""Config module for --arch gemma3-1b (see archs.py for the full definition and
source citation; SMOKE is the reduced per-arch smoke-test variant)."""
from repro_torch.configs.archs import GEMMA3_1B as CONFIG
from repro_torch.configs.archs import SMOKE_ARCHS

SMOKE = SMOKE_ARCHS["gemma3-1b"]
