"""Profiling harness (counterpart of synthesis_in_style_tpu/utils/profiling.py):
a torch.profiler trace of a region, written as a Chrome trace, and a step
timer that waits for the device."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Union[str, Path, None]) -> Iterator[None]:
    """Record the enclosed region with torch.profiler (host activity, and the
    card's kernels when CUDA is available) and write it to
    `<log_dir>/trace.json` (Chrome trace format: chrome://tracing or
    Perfetto); no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class StepTimer:
    """Wall-clock step timing that waits for the device: `stop(fetch)` reads
    `fetch` back to the host (a tensor), or synchronizes the card when CUDA
    is available, before it reads the clock."""

    def __init__(self):
        self.durations: list = []
        self._start: Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, fetch=None) -> float:
        if isinstance(fetch, torch.Tensor):
            fetch.detach().cpu()
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        assert self._start is not None, "start() first"
        duration = time.perf_counter() - self._start
        self.durations.append(duration)
        self._start = None
        return duration

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        arr = np.asarray(self.durations)
        return {
            "mean_s": float(arr.mean()),
            "median_s": float(np.median(arr)),
            "p90_s": float(np.percentile(arr, 90)),
            "total_s": float(arr.sum()),
            "steps": int(arr.size),
        }
