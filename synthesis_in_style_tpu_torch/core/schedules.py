"""Learning-rate schedules (counterpart of
synthesis_in_style_tpu/core/schedules.py): functions of the 0-based update
count, evaluated as optax evaluates a schedule (before the update that
uses it)."""

from __future__ import annotations

import math
from typing import Callable


def clamped_cosine(base_lr: float, t_max: int, eta_min: float = 0.0) -> Callable[[int], float]:
    """Cosine anneal to eta_min over t_max steps, then hold eta_min."""

    def schedule(step: int) -> float:
        t = min(step, t_max)
        return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t / t_max))

    return schedule
