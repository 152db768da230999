"""Config module for --arch deepseek-moe-16b (see archs.py for the full definition and
source citation; SMOKE is the reduced per-arch smoke-test variant)."""
from repro_torch.configs.archs import DEEPSEEK_MOE_16B as CONFIG
from repro_torch.configs.archs import SMOKE_ARCHS

SMOKE = SMOKE_ARCHS["deepseek-moe-16b"]
