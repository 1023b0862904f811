"""Train StyleGAN2 or SWAGAN on unlabelled document scans (counterpart of
synthesis_in_style_tpu/cli/train_stylegan_2.py).

The same flags and config keys as the JAX CLI, plus `-d/--device` (default
cuda): regularization intervals and weights, style mixing, reg-ratio-scaled
Adam with global-norm clipping and a cosine learning rate to 1e-8,
`compute_dtype`, `freeze_stochastic_noise_layers` (true = every layer, or a
list of layer indices), snapshots in the reference `.pt` layout
(`<log_dir>/checkpoints/iter_<n>.pt`; their `g_ema` loads into the port's
dataset CLI), `log.jsonl`, sample grids and the divergence alarm.

* `--resume-ckpt <snapshot>` takes a snapshot of the port or a reference
  `.pt`: weights, optimizer states and the path-length mean.
  `--resume-ckpt latest` takes the newest snapshot across this run's
  timestamped attempts and restores the iteration and the data position
  too; with none found it starts fresh.
* `--init-ckpt <snapshot>`: weights-only, shape-tolerant warm start, e.g. a
  256px run from a 128px snapshot (utils/checkpoint.py
  `upscale_gan_snapshot_tree`); optimizers and iteration start fresh;
  ignored when `latest` found a snapshot.
* `--val-images`: FID of g_ema against those images every `fid_eval_iter`
  iterations (evaluation/fid.py; a relative FID unless calibrated weights
  are found), which the divergence alarm watches.
* `-c/--cache-root`: images copied to a local cache on first read.
* `--profile-dir`: a torch.profiler Chrome trace of the run.

`stylegan_variant: swagan` (or `-s swagan`) trains SWAGAN
(models/swagan.py); `-s 1` warns and trains StyleGAN2, as the JAX CLI does.

More than one process: `torchrun --nproc-per-node N -m
synthesis_in_style_tpu_torch.cli.train_stylegan_2 ...` (or
torch.distributed.launch with `--local_rank`); `batch_size` is per process,
as in the JAX CLI, and the step is that of the global batch
(parallel/distributed.py). Rank 0 writes the run's files.

Not ported yet (raises NotImplementedError, see ROADMAP.md): wandb logging.

Usage:
  python -m synthesis_in_style_tpu_torch.cli.train_stylegan_2 <config.yaml> \\
      --images train.json [--val-images val.json] -l out [-d cuda]
"""

from __future__ import annotations

import argparse
import datetime
import os
import warnings
from pathlib import Path
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.cli.compat import (
    add_torch_compat_args,
    launch,
    warn_ignored_torch_args,
)
from synthesis_in_style_tpu_torch.core.config import (
    load_config_file,
    load_config_from_checkpoint,
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
from synthesis_in_style_tpu_torch.data.json_dataset import (
    CachingLoader,
    JSONDataset,
    normalize_to_tensor,
    resilient_loader,
)
from synthesis_in_style_tpu_torch.data.loader import EpochStream, make_loader
from synthesis_in_style_tpu_torch.evaluation.fid import make_fid_extension
from synthesis_in_style_tpu_torch.models.factory import get_discriminator, get_generator
from synthesis_in_style_tpu_torch.parallel.distributed import data_parallel, is_main_process
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (
    StyleGAN2Config,
    GANTrainState,
    StyleGAN2Updater,
    create_gan_train_state,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    discover_latest_snapshot,
    load_gan_snapshot,
    merge_matching_leaves,
    save_gan_snapshot,
    snapshot_iteration,
    upscale_gan_snapshot_tree,
)
from synthesis_in_style_tpu_torch.utils.dataset_creation import make_image
from synthesis_in_style_tpu_torch.utils.profiling import trace


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
    if config.get("wandb_project_name"):
        raise _not_ported("wandb logging")
    warn_ignored_torch_args(config)


def find_latest_resume(config: dict, log_dir: Path) -> int:
    """`--resume-ckpt latest`: point `config["resume_ckpt"]` at the newest
    snapshot across the timestamped attempts beside `log_dir` (None when
    there is none) and return its iteration (0 when starting fresh). Any
    other value is left as it is; its iteration is 0."""
    if config.get("resume_ckpt") != "latest":
        return 0
    found = discover_latest_snapshot(log_dir.parent)
    if found is None:
        print("--resume-ckpt latest: no snapshot found, starting fresh", flush=True)
        config["resume_ckpt"] = None
        return 0
    iteration = snapshot_iteration(found)
    print(f"--resume-ckpt latest: resuming {found} at iteration {iteration}", flush=True)
    config["resume_ckpt"] = str(found)
    return iteration


def warm_start(state: GANTrainState, init_ckpt: Union[str, Path], image_size: int) -> dict:
    """`--init-ckpt`: weights only, shape-tolerant. The snapshot's networks
    are re-keyed from its own image_size (the config beside it) to
    `image_size` and each of generator, discriminator and g_ema takes every
    tensor whose name, shape and dtype match; the rest keep their fresh init.
    Optimizer states are never read. Returns {key: (copied, fresh)}."""
    src_config = load_config_from_checkpoint(init_ckpt)
    src_size = int(src_config.get("image_size", image_size))
    tree = upscale_gan_snapshot_tree(load_gan_snapshot(init_ckpt), src_size, image_size)
    counts = {}
    for key, module in (("generator", state.generator), ("discriminator", state.discriminator),
                        ("g_ema", state.g_ema)):
        if key not in tree:
            continue
        fresh_state = module.state_dict()
        merged, copied, fresh = merge_matching_leaves(fresh_state, tree[key])
        module.load_state_dict(merged, strict=True)
        counts[key] = (copied, fresh)
        print(f"warm start {key} from {src_size}px: {copied} copied, {fresh} kept fresh",
              flush=True)
    return counts


def frozen_noise_layers(config: dict, num_layers: int) -> Tuple[int, ...]:
    """`freeze_stochastic_noise_layers`: true = all layers, a list = those."""
    freeze = config.get("freeze_stochastic_noise_layers", False)
    if freeze is True:
        return tuple(range(num_layers))
    return tuple(int(i) for i in freeze) if freeze else ()


def main(args: argparse.Namespace) -> Trainer:
    """Train as configured; returns the finished Trainer."""
    config = merge_config_and_args(load_config_file(args.config), args)
    if str(config.get("stylegan_variant", 2)) == "1":
        # the JAX CLI (and the reference trainer it follows) dispatches only
        # swagan vs stylegan2: -s 1 trains StyleGAN2
        warnings.warn("stylegan_variant '1' falls back to StyleGAN2 (the reference "
                      "trainer only dispatches swagan vs stylegan2)")
        config["stylegan_variant"] = 2
    check_supported(config)
    if torch.device(config["device"]).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    device = launch(config)
    log_dir = Path(config["log_dir"])
    seed = int(config.get("seed", 0))

    resume_iteration = find_latest_resume(config, log_dir)

    json_path = Path(config["images"])
    image_loader = (CachingLoader(json_path.parent, config["cache_root"])
                    if config.get("cache_root") else resilient_loader)
    dataset = GANImageDataset(json_path, root=json_path.parent, loader=image_loader,
                              image_size=config["image_size"],
                              num_channels=config.get("input_dim", 3))
    # the JAX loader's per-epoch order, which `seek` can resume into
    # `batch_size` is per process: a launched run's processes each read
    # their shard, a global batch of batch_size x world size
    loader = make_loader(dataset, int(config["batch_size"]), shuffle=True, drop_last=True,
                         num_workers=0 if args.debug else int(config.get("num_workers", 8)),
                         seed=seed, pin_memory=device.type == "cuda", sharded=True)

    init_rng = torch.Generator().manual_seed(seed)
    gen = get_generator(config).init_weights(init_rng).to(device)
    disc = get_discriminator(config).init_weights(init_rng).to(device)
    settings = optimizer_settings(config)
    (g_schedule, g_betas), (d_schedule, d_betas) = settings["generator"], settings["discriminator"]
    state = create_gan_train_state(gen, disc, g_schedule, d_schedule, g_betas, d_betas)
    if config.get("init_ckpt") and not config.get("resume_ckpt"):
        warm_start(state, config["init_ckpt"], int(config["image_size"]))
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
    dp = data_parallel(int(config["batch_size"]))
    updater = StyleGAN2Updater(state, {"images": stream},
                               batch_size=dp.global_batch if dp else int(config["batch_size"]),
                               cfg=gan_cfg, seed=seed, device=device)
    if resume_iteration:
        updater.iteration = state.step = resume_iteration
        stream.seek(resume_iteration)
    trainer = Trainer(updater, (int(config["max_iter"]), "iteration"), log_dir=log_dir)
    if is_main_process():
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
    if config.get("val_images") and not args.debug:
        trainer.extend(make_fid_extension(lambda t: t.updater.state, config, device))
    alarm_cfg = dict(config.get("quality_alarm") or {})
    if alarm_cfg.pop("enabled", True) and not args.debug:
        trainer.extend(DivergenceAlarm(trigger=(1, "epoch"), log_dir=log_dir, **alarm_cfg))
    trainer.extend(LogWriter(log_dir, trigger=log_trigger))
    try:
        with trace(config.get("profile_dir")):
            trainer.train()
    finally:
        stream.close()
    return trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train StyleGAN2")
    parser.add_argument("config", help="path to yaml or json config")
    parser.add_argument("--images", default=None, help="Path to json file with train images")
    parser.add_argument("--val-images", dest="val_images", default=None,
                        help="json file of validation images: FID of g_ema against them "
                        "every fid_eval_iter iterations (relative FID unless "
                        "$SIS_METRIC_WEIGHTS/inception_v3.npz exists)")
    parser.add_argument("--resume-ckpt", dest="resume_ckpt", default=None,
                        help="GAN snapshot (.pt) of the port or of the reference to "
                        "resume weights, optimizer states and the path-length mean from; "
                        "'latest' takes the newest snapshot across this run's timestamped "
                        "attempts and restores the iteration and data position too")
    parser.add_argument("--init-ckpt", dest="init_ckpt", default=None,
                        help="weights-only, shape-tolerant warm start from a GAN snapshot "
                        "(e.g. a 256px run from a 128px one); optimizers and iteration "
                        "start fresh")
    parser.add_argument("-c", "--cache-root", default=None,
                        help="copy the training images to this directory on first read "
                        "and read them from there")
    parser.add_argument("-s", "--stylegan-variant", type=str.lower,
                        choices=["1", "2", "swagan"], default=None,
                        help="which stylegan variant to use (1 trains StyleGAN2, with a "
                        "warning)")
    parser.add_argument("-l", "--log-dir", default="training")
    parser.add_argument("-ln", "--log-name", default="stylegan2")
    parser.add_argument("--wandb-project-name", default=None,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("--wandb-entity", default=None)
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler Chrome trace of the run to "
                        "<dir>/trace.json")
    add_torch_compat_args(parser)
    return parser


def resolve_log_dir(args: argparse.Namespace) -> argparse.Namespace:
    """-l/-ln -> logs/<log_dir>/<log_name>/<timestamp> (an absolute -l
    replaces `logs`)."""
    args.log_dir = os.path.join("logs", args.log_dir, args.log_name,
                                datetime.datetime.now().isoformat())
    return args


if __name__ == "__main__":
    main(resolve_log_dir(build_parser().parse_args()))
