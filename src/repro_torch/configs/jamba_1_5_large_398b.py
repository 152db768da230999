"""Config module for --arch jamba-1.5-large-398b (see archs.py for the full definition and
source citation; SMOKE is the reduced per-arch smoke-test variant)."""
from repro_torch.configs.archs import JAMBA_1_5_LARGE as CONFIG
from repro_torch.configs.archs import SMOKE_ARCHS

SMOKE = SMOKE_ARCHS["jamba-1.5-large-398b"]
