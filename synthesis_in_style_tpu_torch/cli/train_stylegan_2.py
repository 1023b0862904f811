"""Train StyleGAN2 on unlabelled document scans (counterpart of
synthesis_in_style_tpu/cli/train_stylegan_2.py).

The same flags and config keys as the JAX CLI, plus `-d/--device` (default
cuda): regularization intervals and weights, style mixing, reg-ratio-scaled
Adam with global-norm clipping and a cosine learning rate to 1e-8,
`compute_dtype`, `freeze_stochastic_noise_layers` (true = every layer, or a
list of layer indices), snapshots in the reference `.pt` layout
(`<log_dir>/checkpoints/iter_<n>.pt`; their `g_ema` loads into the port's
dataset CLI), `log.jsonl`, sample grids and the collapse alarm.
`--resume-ckpt` takes a snapshot of the port or a reference `.pt`.

Not ported yet (each raises NotImplementedError, see ROADMAP.md):
`--resume-ckpt latest`, `--init-ckpt`, `--val-images` (FID), `--cache-root`,
wandb logging, `--profile-dir`, the swagan and StyleGAN1 variants, and more
than one process.

Usage:
  python -m synthesis_in_style_tpu_torch.cli.train_stylegan_2 <config.yaml> \\
      --images train.json -l out [-d cuda]
"""

from __future__ import annotations

import argparse
import datetime
import os
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader

from synthesis_in_style_tpu_torch.core.config import (
    load_config_file,
    merge_config_and_args,
    save_run_config,
)
from synthesis_in_style_tpu_torch.core.extensions import (
    DivergenceAlarm,
    ImagePlotter,
    LogWriter,
    LRReporter,
    Snapshotter,
)
from synthesis_in_style_tpu_torch.core.schedules import clamped_cosine
from synthesis_in_style_tpu_torch.core.trainer import Trainer
from synthesis_in_style_tpu_torch.data.json_dataset import JSONDataset, normalize_to_tensor
from synthesis_in_style_tpu_torch.data.loader import EpochStream
from synthesis_in_style_tpu_torch.models.factory import get_discriminator, get_generator
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (
    StyleGAN2Config,
    StyleGAN2Updater,
    create_gan_train_state,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import load_gan_snapshot, save_gan_snapshot
from synthesis_in_style_tpu_torch.utils.dataset_creation import make_image


class GANImageDataset(JSONDataset):
    """Images resized and normalized to [-1, 1], keyed 'images'."""

    def __init__(self, *args, image_size: int, num_channels: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.image_size = image_size
        self.num_channels = num_channels

    def __getitem__(self, index):
        image = self.loader(self.full_path(index))
        return {"images": normalize_to_tensor(image, self.image_size, self.num_channels)}


def optimizer_settings(config: dict) -> Dict[str, Tuple[Callable[[int], float], Tuple[float, float]]]:
    """{"generator"|"discriminator": (schedule, betas)}: lr * ratio on a
    cosine to 1e-8 over max_iter, betas (0 ** ratio, 0.99 ** ratio), with
    ratio = interval / (interval + 1) of that network's regularization."""
    reg = config.get("regularization", {})
    lr, max_iter = float(config["lr"]), int(config["max_iter"])
    out = {}
    for name, key, default in (("generator", "g_interval", 4), ("discriminator", "d_interval", 16)):
        interval = int(reg.get(key, default))
        ratio = interval / (interval + 1)
        out[name] = (clamped_cosine(lr * ratio, max_iter, eta_min=1e-8),
                     (0.0**ratio, 0.99**ratio))
    return out


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to synthesis_in_style_tpu_torch yet (see ROADMAP.md)"
    )


def check_supported(config: dict) -> None:
    """Raise on every option this port does not implement yet."""
    if config.get("resume_ckpt") == "latest":
        raise _not_ported("--resume-ckpt latest")
    for key, flag in (("init_ckpt", "--init-ckpt"), ("val_images", "--val-images (FID)"),
                      ("cache_root", "--cache-root"), ("wandb_project_name", "wandb logging"),
                      ("profile_dir", "--profile-dir")):
        if config.get(key):
            raise _not_ported(flag)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or config.get("local_rank") or \
            config.get("mpi_backend"):
        raise _not_ported("training in more than one process")


def frozen_noise_layers(config: dict, num_layers: int) -> Tuple[int, ...]:
    """`freeze_stochastic_noise_layers`: true = all layers, a list = those."""
    freeze = config.get("freeze_stochastic_noise_layers", False)
    if freeze is True:
        return tuple(range(num_layers))
    return tuple(int(i) for i in freeze) if freeze else ()


def main(args: argparse.Namespace) -> Trainer:
    """Train as configured; returns the finished Trainer."""
    config = merge_config_and_args(load_config_file(args.config), args)
    check_supported(config)
    device = torch.device(config["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    log_dir = Path(config["log_dir"])
    seed = int(config.get("seed", 0))

    json_path = Path(config["images"])
    dataset = GANImageDataset(json_path, root=json_path.parent,
                              image_size=config["image_size"],
                              num_channels=config.get("input_dim", 3))
    loader = DataLoader(dataset, batch_size=int(config["batch_size"]), shuffle=True,
                        drop_last=True, generator=torch.Generator().manual_seed(seed),
                        num_workers=0 if args.debug else int(config.get("num_workers", 8)),
                        pin_memory=device.type == "cuda")

    init_rng = torch.Generator().manual_seed(seed)
    gen = get_generator(config).init_weights(init_rng).to(device)
    disc = get_discriminator(config).init_weights(init_rng).to(device)
    settings = optimizer_settings(config)
    (g_schedule, g_betas), (d_schedule, d_betas) = settings["generator"], settings["discriminator"]
    state = create_gan_train_state(gen, disc, g_schedule, d_schedule, g_betas, d_betas)
    if config.get("resume_ckpt"):
        snap = load_gan_snapshot(config["resume_ckpt"])
        for key, module in (("generator", state.generator), ("discriminator", state.discriminator),
                            ("g_ema", state.g_ema)):
            if key in snap:
                module.load_state_dict(snap[key], strict=True)
        for key, opt in (("generator_optimizer", state.g_optimizer),
                         ("discriminator_optimizer", state.d_optimizer)):
            if key in snap:
                opt.load_state_dict(snap[key])
        if snap["mean_path_length"] is not None:
            state.mean_path_length.fill_(snap["mean_path_length"])

    reg = config.get("regularization", {})
    gan_cfg = StyleGAN2Config(
        r1_weight=float(reg.get("r1_weight", 10.0)),
        path_reg_weight=float(reg.get("path_reg_weight", 2.0)),
        d_reg_every=int(reg.get("d_interval", 16)),
        g_reg_every=int(reg.get("g_interval", 4)),
        mixing_prob=float(config.get("style_mixing_prob", 0.9)),
        freeze_noise_layers=frozen_noise_layers(config, gen.num_layers),
        compute_dtype=config.get("compute_dtype"),
    )
    stream = EpochStream(loader, key="images")
    updater = StyleGAN2Updater(state, {"images": stream}, batch_size=int(config["batch_size"]),
                               cfg=gan_cfg, seed=seed, device=device)
    trainer = Trainer(updater, (int(config["max_iter"]), "iteration"), log_dir=log_dir)
    save_run_config(log_dir, config, args)

    def save(t: Trainer, path: Path) -> None:
        s = t.updater.state
        save_gan_snapshot(path, s.generator, s.discriminator, s.g_ema, s.g_optimizer,
                          s.d_optimizer, float(s.mean_path_length))

    trainer.extend(Snapshotter(save, log_dir,
                               trigger=(int(config.get("snapshot_save_iter", 10000)), "iteration")))

    sample_z = torch.randn((min(16, int(config["batch_size"])), int(config["latent_size"])),
                           generator=torch.Generator().manual_seed(7)).to(device)

    @torch.no_grad()
    def render_samples(t: Trainer) -> np.ndarray:
        """Fixed-z probe grid through g_ema, four images a row."""
        images, _ = t.updater.state.g_ema([sample_z], randomize_noise=False)
        images = make_image(images)
        rows = [np.concatenate(list(images[i:i + 4]), axis=1) for i in range(0, len(images), 4)]
        width = max(r.shape[1] for r in rows)
        rows = [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0))) for r in rows]
        return np.concatenate(rows, axis=0)

    trainer.extend(ImagePlotter(render_samples, log_dir,
                                trigger=(int(config.get("image_save_iter", 1000)), "iteration")))
    log_trigger = (int(config.get("log_iter", 10)), "iteration")
    trainer.extend(LRReporter({"generator": g_schedule, "discriminator": d_schedule},
                              trigger=log_trigger))
    alarm_cfg = dict(config.get("quality_alarm") or {})
    if alarm_cfg.pop("enabled", True) and not args.debug:
        trainer.extend(DivergenceAlarm(trigger=(1, "epoch"), log_dir=log_dir, **alarm_cfg))
    trainer.extend(LogWriter(log_dir, trigger=log_trigger))
    try:
        trainer.train()
    finally:
        stream.close()
    return trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train StyleGAN2")
    parser.add_argument("config", help="path to yaml or json config")
    parser.add_argument("--images", default=None, help="Path to json file with train images")
    parser.add_argument("--val-images", dest="val_images", default=None,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("--resume-ckpt", dest="resume_ckpt", default=None,
                        help="GAN snapshot (.pt) of the port or of the reference to "
                        "resume weights, optimizer states and the path-length mean from")
    parser.add_argument("--init-ckpt", dest="init_ckpt", default=None,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("-c", "--cache-root", default=None,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("-s", "--stylegan-variant", type=str.lower,
                        choices=["1", "2", "swagan"], default=None,
                        help="which stylegan variant to use (only 2 is ported)")
    parser.add_argument("-l", "--log-dir", default="training")
    parser.add_argument("-ln", "--log-name", default="stylegan2")
    parser.add_argument("--wandb-project-name", default=None,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("--wandb-entity", default=None)
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--profile-dir", default=None,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to train on (default cuda)")
    parser.add_argument("--local_rank", type=int, default=None,
                        help="more than one process is not ported yet")
    parser.add_argument("--mpi-backend", default=None, choices=["nccl", "gloo"],
                        help="more than one process is not ported yet")
    return parser


def resolve_log_dir(args: argparse.Namespace) -> argparse.Namespace:
    """-l/-ln -> logs/<log_dir>/<log_name>/<timestamp> (an absolute -l
    replaces `logs`)."""
    args.log_dir = os.path.join("logs", args.log_dir, args.log_name,
                                datetime.datetime.now().isoformat())
    return args


if __name__ == "__main__":
    main(resolve_log_dir(build_parser().parse_args()))
