from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoESpec,
    SSMSpec,
    SubLayer,
    layer_kinds,
)
from repro_torch.configs.archs import ARCHS, SMOKE_ARCHS, reduced  # noqa: F401


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_ARCHS if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(table)}")
    return table[name]
