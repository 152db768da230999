"""Config module for --arch llava-next-mistral-7b (see archs.py for the full definition and
source citation; SMOKE is the reduced per-arch smoke-test variant)."""
from repro_torch.configs.archs import LLAVA_NEXT_MISTRAL_7B as CONFIG
from repro_torch.configs.archs import SMOKE_ARCHS

SMOKE = SMOKE_ARCHS["llava-next-mistral-7b"]
