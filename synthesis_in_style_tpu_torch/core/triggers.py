"""Interval triggers for trainer extensions (counterpart of
synthesis_in_style_tpu/core/triggers.py)."""

from __future__ import annotations

from typing import Optional, Tuple


class IntervalTrigger:
    """Fires every `period` iterations or epochs."""

    def __init__(self, period: int, unit: str):
        if unit not in ("iteration", "epoch") or period <= 0:
            raise ValueError(f"bad trigger ({period}, {unit!r})")
        self.period = period
        self.unit = unit
        self._last_epoch_fire = -1

    def __call__(self, trainer) -> bool:
        updater = trainer.updater
        if self.unit == "iteration":
            return updater.iteration > 0 and updater.iteration % self.period == 0
        epoch = int(updater.epoch)
        if epoch != self._last_epoch_fire and epoch > 0 and epoch % self.period == 0:
            self._last_epoch_fire = epoch
            return True
        return False

    def __repr__(self):
        return f"IntervalTrigger({self.period}, {self.unit!r})"


def get_trigger(spec: Optional[Tuple[int, str]]) -> Optional[IntervalTrigger]:
    """(period, "iteration" or "epoch") -> its trigger; None -> None."""
    return None if spec is None else IntervalTrigger(*spec)
