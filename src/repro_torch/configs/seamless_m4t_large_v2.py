"""Config module for --arch seamless-m4t-large-v2 (see archs.py for the full definition and
source citation; SMOKE is the reduced per-arch smoke-test variant)."""
from repro_torch.configs.archs import SEAMLESS_M4T_LARGE_V2 as CONFIG
from repro_torch.configs.archs import SMOKE_ARCHS

SMOKE = SMOKE_ARCHS["seamless-m4t-large-v2"]
