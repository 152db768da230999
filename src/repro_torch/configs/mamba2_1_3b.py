"""Config module for --arch mamba2-1.3b (see archs.py for the full definition and
source citation; SMOKE is the reduced per-arch smoke-test variant)."""
from repro_torch.configs.archs import MAMBA2_1_3B as CONFIG
from repro_torch.configs.archs import SMOKE_ARCHS

SMOKE = SMOKE_ARCHS["mamba2-1.3b"]
