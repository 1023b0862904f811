"""Updater base: owns the training state and the per-iteration update
(counterpart of synthesis_in_style_tpu/core/updater.py)."""

from __future__ import annotations

import abc
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.core.reporter import get_current_reporter


def iteration_seed(seed: int, iteration: int) -> int:
    """A 63-bit seed that is a pure function of (seed, iteration)."""
    return int(np.random.SeedSequence([seed, iteration]).generate_state(1, np.uint64)[0] >> 1)


class Updater(abc.ABC):
    def __init__(
        self,
        iterators: Optional[Dict[str, Iterator]] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cpu",
    ):
        self.iterators = iterators or {}
        self.iteration = 0
        self.seed = seed
        self.device = torch.device(device)
        self.rng = torch.Generator(device=self.device)

    @property
    def epoch(self) -> float:
        it = self.iterators.get("images") or next(iter(self.iterators.values()), None)
        return float(getattr(it, "epoch", 0))

    def next_batch(self, name: str = "images"):
        return next(self.iterators[name])

    def update(self):
        # Re-seed the random stream from (seed, iteration) every iteration:
        # the draws are a pure function of the iteration counter, so a
        # resumed run at iteration k draws what a straight run would have.
        self.rng.manual_seed(iteration_seed(self.seed, self.iteration))
        self.update_core()
        self.iteration += 1

    @abc.abstractmethod
    def update_core(self):
        ...

    def report(self, values: Dict[str, Any], prefix: str = ""):
        get_current_reporter().add_observation(values, prefix)
