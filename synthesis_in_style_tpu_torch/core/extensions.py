"""Trainer extensions (counterpart of synthesis_in_style_tpu/core/extensions.py):
snapshots, the jsonl log, learning-rate reports, sample images, evaluation
and the collapse alarm."""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from synthesis_in_style_tpu_torch.core.trainer import Extension, Trainer
from synthesis_in_style_tpu_torch.utils.png import write_png

logger = logging.getLogger(__name__)


class Snapshotter(Extension):
    """Writes `<log_dir>/checkpoints/iter_<iteration:08d>.pt` through
    `save_fn(trainer, path)` on its trigger, and once more at the end of
    training unless the trigger just wrote that iteration."""

    priority = 200

    def __init__(self, save_fn: Callable[[Trainer, Path], None], log_dir, trigger):
        super().__init__(trigger)
        self.save_fn = save_fn
        self.checkpoint_dir = Path(log_dir) / "checkpoints"
        self._last_saved_iteration: Optional[int] = None

    def run(self, trainer: Trainer):
        path = self.checkpoint_dir / f"iter_{trainer.updater.iteration:08d}.pt"
        self.save_fn(trainer, path)
        self._last_saved_iteration = trainer.updater.iteration
        logger.info("snapshot saved to %s", path)

    def finalize(self, trainer: Trainer):
        if self._last_saved_iteration != trainer.updater.iteration:
            self.run(trainer)


class LogWriter(Extension):
    """Drains the reporter window and appends its means, the iteration, the
    epoch and the host's resident memory to `<log_dir>/log.jsonl`."""

    priority = 300

    def __init__(self, log_dir, trigger):
        super().__init__(trigger)
        self.log_path = Path(log_dir) / "log.jsonl"

    def run(self, trainer: Trainer):
        means = trainer.reporter.flush()
        if not means:
            return
        means["iteration"] = trainer.updater.iteration
        means["epoch"] = trainer.updater.epoch
        # host RSS in the metric stream: a host leak shows up long before
        # the OOM killer does
        rss = host_rss_gb()
        if rss is not None:
            means["host/rss_gb"] = rss
        with open(self.log_path, "a") as f:
            f.write(json.dumps(means) + "\n")

    def finalize(self, trainer: Trainer):
        self.run(trainer)


def host_rss_gb(statm: str = "/proc/self/statm"):
    """Resident set size of this process in GiB (3 decimals), from the
    resident page count of `statm` times the host's page size (4, 16 or 64
    KiB); None where there is no such file."""
    try:
        with open(statm) as f:
            pages = int(f.read().split()[1])
    except OSError:
        return None
    return round(pages * os.sysconf("SC_PAGE_SIZE") / 2**30, 3)


class LRReporter(Extension):
    """Reports each schedule's learning rate at the current iteration."""

    priority = 150

    def __init__(self, schedules: Dict[str, Callable[[int], float]], trigger):
        super().__init__(trigger)
        self.schedules = schedules

    def run(self, trainer: Trainer):
        it = trainer.updater.iteration
        trainer.reporter.add_observation(
            {name: float(sched(it)) for name, sched in self.schedules.items()}, prefix="lr"
        )


class ImagePlotter(Extension):
    """Writes `render_fn(trainer)` ((H, W, 3) uint8) as
    `<log_dir>/images/iter_<iteration:08d>.png`."""

    priority = 400

    def __init__(self, render_fn: Callable[[Trainer], np.ndarray], log_dir, trigger):
        super().__init__(trigger)
        self.render_fn = render_fn
        self.image_dir = Path(log_dir) / "images"

    def run(self, trainer: Trainer):
        image = np.asarray(self.render_fn(trainer))
        self.image_dir.mkdir(parents=True, exist_ok=True)
        write_png(self.image_dir / f"iter_{trainer.updater.iteration:08d}.png", image)


class Evaluator(Extension):
    """Runs `eval_fn(trainer) -> {name: scalar}` on its trigger and once
    more at the end of training, reports the values under `prefix`, and
    keeps them as `trainer.last_evaluation`."""

    priority = 250

    def __init__(self, eval_fn: Callable[[Trainer], Dict[str, float]], trigger,
                 prefix: str = "evaluation"):
        super().__init__(trigger)
        self.eval_fn = eval_fn
        self.prefix = prefix

    def run(self, trainer: Trainer):
        metrics = self.eval_fn(trainer)
        if metrics:
            trainer.reporter.add_observation(metrics, prefix=self.prefix)
            trainer.last_evaluation = {"iteration": trainer.updater.iteration,
                                       **{k: float(v) for k, v in metrics.items()}}

    def finalize(self, trainer: Trainer):
        self.run(trainer)


class TrainingDiverged(RuntimeError):
    """Raised by DivergenceAlarm with `abort`; the trainer still finalizes."""


class DivergenceAlarm(Extension):
    """Collapse / divergence monitor.

    * ``fid_divergence``: the relative FID of `trainer.last_evaluation` rose
      for ``fid_rising_evals`` consecutive evaluations. The port has no FID
      evaluator yet, so this branch stays inert.
    * ``d_collapse``: the mean train/discriminator_loss of the current
      reporter window stayed below ``d_loss_eps`` for ``d_loss_checks``
      consecutive checks after ``warmup_iterations``.

    On alarm: logs, writes ``alarm.json`` under `log_dir`, reports
    ``alarm/<kind>``, and raises TrainingDiverged when `abort` is True or
    lists the kind."""

    priority = 260

    def __init__(self, trigger, log_dir=None, fid_key: str = "fid_score",
                 d_loss_key: str = "train/discriminator_loss",
                 fid_rising_evals: int = 4, d_loss_eps: float = 0.008,
                 d_loss_checks: int = 6, warmup_iterations: int = 500,
                 abort: Union[bool, Sequence[str]] = False):
        super().__init__(trigger)
        self.log_dir = Path(log_dir) if log_dir else None
        self.fid_key = fid_key
        self.d_loss_key = d_loss_key
        self.fid_rising_evals = int(fid_rising_evals)
        self.d_loss_eps = float(d_loss_eps)
        self.d_loss_checks = int(d_loss_checks)
        self.warmup_iterations = int(warmup_iterations)
        self.abort = set(abort) if isinstance(abort, (list, tuple, set)) else bool(abort)
        self.fid_history: list = []
        self._low_d_streak = 0
        self._seen_eval_iteration = -1

    def _fire(self, trainer: Trainer, kind: str, detail: dict):
        it = trainer.updater.iteration
        logger.error("DIVERGENCE ALARM [%s] at iteration %d: %s", kind, it, detail)
        print(f"*** DIVERGENCE ALARM [{kind}] at iteration {it}: {detail} ***", flush=True)
        trainer.reporter.add_observation({kind: 1.0}, prefix="alarm")
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            (self.log_dir / "alarm.json").write_text(json.dumps({
                "kind": kind, "iteration": it, "detail": detail,
                "fid_history": self.fid_history,
            }))
        if kind in self.abort if isinstance(self.abort, set) else self.abort:
            raise TrainingDiverged(f"{kind} at iteration {it}: {detail}")

    def run(self, trainer: Trainer):
        last_eval = getattr(trainer, "last_evaluation", None)
        if (last_eval is not None and self.fid_key in last_eval
                and last_eval["iteration"] > self._seen_eval_iteration):
            self._seen_eval_iteration = last_eval["iteration"]
            self.fid_history.append([last_eval["iteration"], float(last_eval[self.fid_key])])
            n = self.fid_rising_evals
            if len(self.fid_history) > n:
                tail = [f for _, f in self.fid_history[-(n + 1):]]
                if all(b > a for a, b in zip(tail, tail[1:])):
                    self._fire(trainer, "fid_divergence", {"rising_evals": n, "fid_tail": tail})

        if trainer.updater.iteration >= self.warmup_iterations:
            d_mean = trainer.reporter.peek(self.d_loss_key)
            if d_mean is not None:
                self._low_d_streak = self._low_d_streak + 1 if d_mean < self.d_loss_eps else 0
                if self._low_d_streak >= self.d_loss_checks:
                    streak, self._low_d_streak = self._low_d_streak, 0
                    self._fire(trainer, "d_collapse", {
                        "window_mean_d_loss": d_mean, "eps": self.d_loss_eps,
                        "checks": streak})
