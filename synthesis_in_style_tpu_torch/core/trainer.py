"""Trigger/extension training loop (counterpart of
synthesis_in_style_tpu/core/trainer.py)."""

from __future__ import annotations

import gc
import logging
import time
from pathlib import Path
from typing import List, Optional, Tuple, Union

from synthesis_in_style_tpu_torch.core.reporter import Reporter
from synthesis_in_style_tpu_torch.core.triggers import get_trigger
from synthesis_in_style_tpu_torch.core.updater import Updater

logger = logging.getLogger(__name__)


class Extension:
    """Called when its trigger fires (every iteration without one); lower
    priority runs earlier."""

    priority: int = 100

    def __init__(self, trigger: Optional[Tuple[int, str]] = None):
        self.trigger = get_trigger(trigger)

    def initialize(self, trainer: "Trainer"):
        pass

    def finalize(self, trainer: "Trainer"):
        pass

    def run(self, trainer: "Trainer"):
        raise NotImplementedError

    def __call__(self, trainer: "Trainer"):
        self.run(trainer)


class StopTrigger:
    """Stop after N iterations or epochs."""

    def __init__(self, period: int, unit: str):
        if unit not in ("iteration", "epoch"):
            raise ValueError(f"bad stop unit {unit!r}")
        self.period = period
        self.unit = unit

    def __call__(self, trainer) -> bool:
        if self.unit == "iteration":
            return trainer.updater.iteration >= self.period
        return trainer.updater.epoch >= self.period


class Trainer:
    def __init__(
        self,
        updater: Updater,
        stop_trigger: Tuple[int, str],
        log_dir: Union[str, Path, None] = None,
    ):
        self.updater = updater
        self.stop_trigger = StopTrigger(*stop_trigger)
        self.log_dir = Path(log_dir) if log_dir else None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
        self.extensions: List[Extension] = []
        self.reporter = Reporter()
        self.start_time: Optional[float] = None
        self.seconds: Optional[float] = None  # wall time of the last train()

    def extend(self, extension: Extension) -> "Trainer":
        self.extensions.append(extension)
        self.extensions.sort(key=lambda e: e.priority)
        return self

    def train(self):
        self.start_time = time.time()
        for ext in self.extensions:
            ext.initialize(self)
        try:
            with self.reporter.scope():
                while not self.stop_trigger(self):
                    self.updater.update()
                    for ext in self.extensions:
                        if ext.trigger is None or ext.trigger(self):
                            ext(self)
                    # big host batch buffers barely move the generational
                    # GC's counters, so reference cycles can pin them for
                    # thousands of iterations: collect now and then
                    if self.updater.iteration % 200 == 0:
                        gc.collect()
        finally:
            # finalizers run on a crash or an interrupt too: the last
            # snapshot and log window must be written
            for ext in self.extensions:
                try:
                    ext.finalize(self)
                except Exception:  # noqa: BLE001 - do not mask the original error
                    logger.exception("extension %r failed to finalize", ext)
        self.seconds = time.time() - self.start_time
        logger.info("training finished after %d iterations in %.1fs",
                    self.updater.iteration, self.seconds)
