"""Scalar observation aggregation (counterpart of
synthesis_in_style_tpu/core/reporter.py)."""

from __future__ import annotations

import threading
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Mapping

import torch

_local = threading.local()


def window_mean(values: list) -> float:
    """Mean of a list of Python numbers or 0-dim tensors (one copy to the
    host for the tensors)."""
    return float(torch.stack([torch.as_tensor(v).detach().float().cpu() for v in values]).mean())


class Reporter:
    """Accumulates named scalar observations; loggers drain window means.
    Values stay as (possibly device) tensors until a logger drains them, so
    reporting does not wait for the device every iteration."""

    def __init__(self):
        self._values: Dict[str, list] = defaultdict(list)

    def add_observation(self, values: Mapping[str, object], prefix: str = ""):
        for name, value in values.items():
            key = f"{prefix}/{name}" if prefix else name
            self._values[key].append(value)

    def peek(self, key: str):
        """Mean of the current window for `key` (None if empty), without
        draining it."""
        values = self._values.get(key)
        return window_mean(values) if values else None

    def flush(self) -> Dict[str, float]:
        means = {k: window_mean(v) for k, v in self._values.items() if v}
        self._values.clear()
        return means

    @contextmanager
    def scope(self):
        prev = getattr(_local, "reporter", None)
        _local.reporter = self
        try:
            yield self
        finally:
            _local.reporter = prev


def get_current_reporter() -> Reporter:
    reporter = getattr(_local, "reporter", None)
    if reporter is None:
        reporter = Reporter()
        _local.reporter = reporter
    return reporter
