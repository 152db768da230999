"""Config module for --arch qwen3-moe-30b-a3b (see archs.py for the full definition and
source citation; SMOKE is the reduced per-arch smoke-test variant)."""
from repro_torch.configs.archs import QWEN3_MOE_30B_A3B as CONFIG
from repro_torch.configs.archs import SMOKE_ARCHS

SMOKE = SMOKE_ARCHS["qwen3-moe-30b-a3b"]
