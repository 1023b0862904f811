"""Preemption resume in the port's training CLIs (`--resume-ckpt latest`),
on the CPU: snapshot discovery across a run's timestamped attempts (never a
`.tmp` file a crash left), and a run killed right after its iteration-2
snapshot and resumed from `latest` ending in the same state as a straight
4-iteration run. The bar is the JAX package's own (tests/test_resume.py):
every parameter, both optimizer states and the path-length mean within
rtol 1e-5, atol 1e-6. Both rest on the loader's per-(seed, epoch) order with
`seek`, the updater's per-iteration reseeding, and snapshots that carry the
optimizer states."""

import json
import os
import time

import numpy as np
import pytest
import torch
import yaml

from synthesis_in_style_tpu.utils.checkpoint import (
    discover_latest_snapshot as jax_discover_latest_snapshot,
)
from synthesis_in_style_tpu_torch.cli import train, train_stylegan_2
from synthesis_in_style_tpu_torch.core.extensions import Snapshotter
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    discover_latest_snapshot,
    latest_snapshot,
    snapshot_iteration,
)
from synthesis_in_style_tpu_torch.utils.png import write_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-5, 1e-6


def _touch(path, mtime=None):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"x")
    if mtime is not None:
        os.utime(path, (mtime, mtime))


def test_discover_latest_snapshot_across_attempts(tmp_path):
    root = tmp_path / "logs" / "gan" / "run"
    old = root / "2026-01-01T00:00:00" / "checkpoints"
    new = root / "2026-01-02T00:00:00" / "checkpoints"
    _touch(old / "iter_00000100.pt")
    _touch(new / "iter_00000050.pt")
    # a crash mid-write leaves a .tmp beside the snapshots: never taken
    _touch(new / "iter_00000200.pt.tmp")
    found = discover_latest_snapshot(root)
    assert found == old / "iter_00000100.pt"  # the highest iteration, whichever attempt
    assert snapshot_iteration(found) == 100
    assert latest_snapshot(new) == new / "iter_00000050.pt"
    assert latest_snapshot(tmp_path / "none") is None
    assert discover_latest_snapshot(tmp_path / "nothing") is None
    # a single run directory and a bare checkpoints directory work too
    assert discover_latest_snapshot(root / "2026-01-02T00:00:00") == new / "iter_00000050.pt"
    assert discover_latest_snapshot(new) == new / "iter_00000050.pt"


def test_discover_ties_break_toward_the_newest_attempt(tmp_path):
    """Equal iterations: the newest mtime wins, as in the JAX package (whose
    snapshots are directories: its discovery never takes a port file)."""
    now = time.time()
    a = tmp_path / "a" / "checkpoints" / "iter_00000010.pt"
    b = tmp_path / "b" / "checkpoints" / "iter_00000010.pt"
    _touch(a, now - 100)
    _touch(b, now)
    assert discover_latest_snapshot(tmp_path) == b
    _touch(a, now + 100)
    assert discover_latest_snapshot(tmp_path) == a
    assert jax_discover_latest_snapshot(tmp_path) is None


def _interrupt_after_snapshot(monkeypatch, at: int):
    """The run dies (KeyboardInterrupt) right after its snapshot at `at`."""
    original = Snapshotter.run

    def run(self, trainer):
        original(self, trainer)
        if trainer.updater.iteration == at:
            raise KeyboardInterrupt(f"killed after the iteration-{at} snapshot")

    monkeypatch.setattr(Snapshotter, "run", run)


def _assert_state_dicts_close(got, ref, what):
    assert set(got) == set(ref), what
    for key, value in ref.items():
        if isinstance(value, dict):
            _assert_state_dicts_close(got[key], value, f"{what}.{key}")
        elif isinstance(value, torch.Tensor):
            torch.testing.assert_close(got[key], value, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{what}.{key}: {m}")
        else:
            assert got[key] == value, (what, key)


# ---------------------------------------------------------------------------
# GAN


def _gan_inputs(tmp_path):
    rs = np.random.RandomState(0)
    data = tmp_path / "data"
    data.mkdir()
    names = []
    for i in range(6):
        write_png(data / f"p{i}.png", rs.randint(0, 256, (32, 32, 3)).astype(np.uint8))
        names.append(f"p{i}.png")
    (data / "train.json").write_text(json.dumps(names))
    # R1 and path length at iterations 0 and 2: the resumed run's first
    # iteration regularizes both networks
    config = {"image_save_iter": 100, "snapshot_save_iter": 2, "log_iter": 1, "max_iter": 4,
              "batch_size": 2, "lr": 0.002,
              "regularization": {"g_interval": 2, "d_interval": 2, "r1_weight": 10,
                                 "path_reg_weight": 2},
              "latent_size": 32, "n_mlp": 2, "channel_multiplier": 2, "style_mixing_prob": 0.9,
              "stylegan_variant": 2, "freeze_stochastic_noise_layers": [0, 1], "image_size": 32}
    (data / "config.json").write_text(json.dumps(config))
    return data


def _run_gan(data, log_root, *extra):
    argv = [str(data / "config.json"), "--images", str(data / "train.json"),
            "-l", str(log_root), "-ln", "run", "-d", "cpu", "--debug", *extra]
    return train_stylegan_2.main(
        train_stylegan_2.resolve_log_dir(train_stylegan_2.build_parser().parse_args(argv)))


def test_gan_killed_and_resumed_latest_equals_a_straight_run(tmp_path, monkeypatch, capsys):
    data = _gan_inputs(tmp_path)
    straight = _run_gan(data, tmp_path / "straight").updater.state

    with monkeypatch.context() as patch:
        _interrupt_after_snapshot(patch, 2)
        with pytest.raises(KeyboardInterrupt):
            _run_gan(data, tmp_path / "preempted")
    time.sleep(0.01)  # a new timestamped attempt directory
    resumed_trainer = _run_gan(data, tmp_path / "preempted", "--resume-ckpt", "latest")
    out = capsys.readouterr().out
    assert "--resume-ckpt latest: resuming" in out and "at iteration 2" in out
    assert resumed_trainer.updater.iteration == 4
    resumed = resumed_trainer.updater.state

    attempts = sorted((tmp_path / "preempted" / "run").iterdir())
    assert len(attempts) == 2
    assert [p.name for p in sorted((attempts[1] / "checkpoints").iterdir())] == \
        ["iter_00000004.pt"]
    for name in ("generator", "g_ema", "discriminator"):
        _assert_state_dicts_close(getattr(resumed, name).state_dict(),
                                  getattr(straight, name).state_dict(), name)
    for name in ("g_optimizer", "d_optimizer"):
        _assert_state_dicts_close(getattr(resumed, name).state_dict(),
                                  getattr(straight, name).state_dict(), name)
    assert resumed.g_optimizer.count == straight.g_optimizer.count == 6
    torch.testing.assert_close(resumed.mean_path_length, straight.mean_path_length,
                               rtol=RTOL, atol=ATOL)
    assert float(straight.mean_path_length) > 0


def test_latest_without_a_snapshot_starts_fresh(tmp_path, capsys):
    """Both CLIs resolve `latest` with `find_latest_resume`: with no snapshot
    beside the new attempt it starts fresh and says so; an explicit path is
    left as it is."""
    config = {"resume_ckpt": "latest"}
    assert train_stylegan_2.find_latest_resume(config, tmp_path / "run" / "attempt") == 0
    assert config["resume_ckpt"] is None
    assert "no snapshot found, starting fresh" in capsys.readouterr().out
    _touch(tmp_path / "run" / "old" / "checkpoints" / "iter_00000007.pt")
    config = {"resume_ckpt": "latest"}
    assert train_stylegan_2.find_latest_resume(config, tmp_path / "run" / "attempt") == 7
    assert config["resume_ckpt"].endswith("iter_00000007.pt")
    config = {"resume_ckpt": "x/iter_00000009.pt"}
    assert train_stylegan_2.find_latest_resume(config, tmp_path / "run" / "attempt") == 0
    assert config["resume_ckpt"] == "x/iter_00000009.pt"


# ---------------------------------------------------------------------------
# DocUFCN

SHIPPED = "configs/segmenter/stylegan2_doc_ufcn_segmenter.yaml"
COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}


def _seg_inputs(tmp_path):
    from pathlib import Path

    rs = np.random.default_rng(0)
    data = tmp_path / "seg"
    data.mkdir()
    names = []
    for i in range(5):
        img = rs.integers(0, 255, (32, 32, 3), dtype=np.uint8)
        mask = np.zeros((32, 32, 3), np.uint8)
        mask[4 + i:20, 6:24 - i] = (0, 0, 255)
        mask[22:28, 2 + i:30] = (255, 0, 0)
        write_png(data / f"s{i}.png", np.concatenate([img, mask], axis=1))
        names.append(f"s{i}.png")
    (data / "train.json").write_text(json.dumps(names))
    (data / "colors.json").write_text(json.dumps(COLORS))
    shipped = Path(__file__).resolve().parents[1] / SHIPPED
    config = {**yaml.safe_load(shipped.read_text()),
              "image_size": 32, "batch_size": 2, "max_iter": 4, "snapshot_save_iter": 2,
              "image_save_iter": 100, "log_iter": 1, "num_workers": 0, "num_augmentations": 2}
    config.pop("compute_dtype")  # float32: the comparison is at rounding level
    (data / "config.json").write_text(json.dumps(config))
    return data


def _run_seg(data, log_root, *extra):
    argv = [str(data / "config.json"), "--images", str(data / "train.json"),
            "--class-to-color-map", str(data / "colors.json"), "-l", str(log_root),
            "-ln", "docufcn", "-d", "cpu", "--debug", *extra]
    return train.main(train_stylegan_2.resolve_log_dir(train.build_parser().parse_args(argv)))


def test_docufcn_killed_and_resumed_latest_equals_a_straight_run(tmp_path, monkeypatch, capsys):
    data = _seg_inputs(tmp_path)
    straight = _run_seg(data, tmp_path / "straight")
    with monkeypatch.context() as patch:
        _interrupt_after_snapshot(patch, 2)
        with pytest.raises(KeyboardInterrupt):
            _run_seg(data, tmp_path / "preempted")
    time.sleep(0.01)
    resumed = _run_seg(data, tmp_path / "preempted", "--resume-ckpt", "latest")
    assert "at iteration 2" in capsys.readouterr().out
    assert resumed.updater.iteration == straight.updater.iteration == 4
    _assert_state_dicts_close(resumed.updater.network.state_dict(),
                              straight.updater.network.state_dict(), "network")
    _assert_state_dicts_close(resumed.updater.optimizer.state_dict(),
                              straight.updater.optimizer.state_dict(), "optimizer")


def test_cache_root_and_profile_dir(tmp_path):
    """`-c/--cache-root` copies every image it reads under the cache (same
    relative path) and reads it from there; `--profile-dir` writes a Chrome
    trace of the run."""
    data = _seg_inputs(tmp_path)
    config = json.loads((data / "config.json").read_text())
    config.update(max_iter=1, snapshot_save_iter=1)
    (data / "config.json").write_text(json.dumps(config))
    trainer = _run_seg(data, tmp_path / "run", "-c", str(tmp_path / "cache"),
                       "--profile-dir", str(tmp_path / "profile"))
    assert trainer.updater.iteration == 1
    cached = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert cached and set(cached) <= {f"s{i}.png" for i in range(5)}
    assert (tmp_path / "cache" / cached[0]).read_bytes() == (data / cached[0]).read_bytes()
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_step_timer():
    from synthesis_in_style_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer()
    assert timer.summary() == {}
    for _ in range(3):
        timer.start()
        assert timer.stop(torch.ones(2) * 2) >= 0
    summary = timer.summary()
    assert summary["steps"] == 3 and summary["total_s"] >= summary["mean_s"] >= 0
    with pytest.raises(AssertionError):
        timer.stop()
