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


def cosine_warm_restarts(base_lr: float, t_0: int, t_mult: int = 1,
                         eta_min: float = 0.0) -> Callable[[int], float]:
    """SGDR warm restarts (torch CosineAnnealingWarmRestarts): cycle i has
    t_0 * t_mult**i steps, each a cosine from base_lr to eta_min."""
    if t_mult == 1:
        def schedule(step: int) -> float:
            t = step % t_0
            return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t / t_0))

        return schedule

    def schedule(step: int) -> float:
        n = math.floor(math.log(step / t_0 * (t_mult - 1) + 1) / math.log(t_mult))
        cycle_start = t_0 * (t_mult**n - 1) / (t_mult - 1)
        cycle_len = t_0 * t_mult**n
        t = (step - cycle_start) / cycle_len
        return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t))

    return schedule


def constant(base_lr: float) -> Callable[[int], float]:
    return lambda step: base_lr


def segmentation_lr_schedule(config: dict, batches_per_epoch: int) -> Callable[[int], float]:
    """The segmenter's schedule from its config: a clamped cosine (or, with
    `warm_restarts`, warm restarts) from `lr` to `end_lr` over
    `cosine_max_update_epoch` x batches per epoch, else
    `cosine_max_update_iter`, else `epochs` steps; constant if that is 0."""
    if "cosine_max_update_epoch" in config:
        cosine_end = config["cosine_max_update_epoch"] * max(1, batches_per_epoch)
    elif "cosine_max_update_iter" in config:
        cosine_end = config["cosine_max_update_iter"]
    else:
        cosine_end = config.get("epochs", 1)
    base_lr = float(config["lr"])
    end_lr = float(config.get("end_lr", 0.0))
    if config.get("warm_restarts"):
        return cosine_warm_restarts(base_lr, cosine_end, eta_min=end_lr)
    if cosine_end:
        return clamped_cosine(base_lr, cosine_end, eta_min=end_lr)
    return constant(base_lr)
