"""Learning-rate schedules."""
from __future__ import annotations

import math


def exp_decay(lr0: float, decay: float, round_idx: int) -> float:
    """Paper schedule: lr = lr0 * decay**round (0.1, 0.998)."""
    return lr0 * (decay ** round_idx)


def cosine_schedule(lr0: float, step: int, total: int, min_frac: float = 0.1) -> float:
    t = min(step, total) / max(total, 1)
    return lr0 * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * t)))
