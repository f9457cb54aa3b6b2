"""Learning-rate schedules (pure functions of the step), as in the
reference."""
from __future__ import annotations

import math


def warmup_cosine(step, *, warmup: int = 1000, total: int = 100_000,
                  min_ratio: float = 0.1) -> float:
    step = float(step)
    warm = min(step / max(warmup, 1), 1.0)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * t))
    return warm * cos


def constant(step, *, value: float = 1.0) -> float:
    del step
    return value
