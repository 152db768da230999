"""Model families: CNN backbones (HWIO weights over NHWC activations) and
the LM families behind ``registry.bind``."""
from repro_torch.models.registry import ModelAPI, bind  # noqa: F401
