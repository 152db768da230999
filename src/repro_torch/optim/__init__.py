"""Masked SGD and learning-rate schedules."""
from repro_torch.optim.sgd import (  # noqa: F401
    SGDConfig,
    apply_updates,
    init_sgd,
    masked_sgd_step,
    sgd_step,
)
from repro_torch.optim.schedules import (  # noqa: F401
    cosine_schedule,
    exp_decay,
)
