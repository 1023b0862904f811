"""Train the adversarial binary -> styled-image generator (counterpart of
synthesis_in_style_tpu/cli/train_adversarial_generator.py).

The generation autoencoder is a content-and-style (6-channel input) w+
autoencoder, the frozen reconstruction autoencoder a w+ autoencoder and the
discriminator the config variant's. Both optimizers clip the global norm to
1.0, add coupled weight decay, then run Adam (b1 `beta1` = 0.5, b2 `beta2`
= 0.999); G's covers the whole generation autoencoder, its decoder
included. Loss weights: reconstruction 2, discriminator 1, style 1e-7,
perceptual 0.1 (`loss_weights` overrides them); R1 every 16 iterations.

The autoencoder checkpoint is a `.pt` of
`utils/checkpoint.save_autoencoder_snapshot` (or an `.npz` of the JAX
package's `save_pytree_npz`): its `autoencoder` becomes the reconstruction
autoencoder and its `g_ema` the generation autoencoder's decoder. The
config is the one stored beside the checkpoint, else the given one
(`--overwrite-config` merges the given one over it).

Writes `<log_dir>/checkpoints/iter_<n>.pt` (`generator`, `discriminator`,
their optimizer states, `iteration`), `<log_dir>/images/` probe grids
[binary | style | generated | reconstructed], `log.jsonl`, and raises the
divergence alarm on a collapsed discriminator loss.

Usage:
  python -m synthesis_in_style_tpu_torch.cli.train_adversarial_generator \\
      <config.yaml> <autoencoder_ckpt> -o real.json -f binary.json -l <dir> \\
      [-d cuda|cpu] [--debug]
"""

from __future__ import annotations

import argparse
import datetime
import os
from pathlib import Path

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
    save_run_config,
)
from synthesis_in_style_tpu_torch.core.extensions import (
    DivergenceAlarm,
    ImagePlotter,
    LogWriter,
    Snapshotter,
)
from synthesis_in_style_tpu_torch.core.trainer import Trainer
from synthesis_in_style_tpu_torch.data.loader import EpochStream, make_loader
from synthesis_in_style_tpu_torch.losses.perceptual import PerceptualAndStyleLoss
from synthesis_in_style_tpu_torch.models.autoencoder import (
    ContentAndStyleStyleganAutoencoder,
    StyleganAutoencoder,
)
from synthesis_in_style_tpu_torch.models.encoder import WPlusEncoder
from synthesis_in_style_tpu_torch.models.factory import (
    get_discriminator,
    get_generator,
    load_autoencoder_state,
)
from synthesis_in_style_tpu_torch.models.stylegan1 import ProgressiveGenerator
from synthesis_in_style_tpu_torch.models.stylegan2 import generator_channels
from synthesis_in_style_tpu_torch.parallel.distributed import is_main_process
from synthesis_in_style_tpu_torch.updaters.adversarial_updater import (
    AdversarialAutoencoderUpdater,
    AdversarialTrainState,
    make_adversarial_steps,
)
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import GANOptimizer
from synthesis_in_style_tpu_torch.utils.checkpoint import load_autoencoder_snapshot
from synthesis_in_style_tpu_torch.utils.dataset_creation import make_image


def build_networks(config: dict):
    """(generation autoencoder, reconstruction autoencoder, discriminator),
    uninitialized. The encoders take StyleGAN1's channel map for variant 1
    and StyleGAN2's otherwise."""
    variant = 1 if str(config.get("stylegan_variant", 2)) == "1" else 2
    if variant == 1:
        channels = ProgressiveGenerator.get_channels()
    else:
        channels = generator_channels(config.get("channel_multiplier", 2))
    size, latent = config["image_size"], config["latent_size"]
    in_ch = config.get("input_dim", 3)
    generation_ae = ContentAndStyleStyleganAutoencoder(
        WPlusEncoder(size, latent, 2 * in_ch, channels, stylegan_variant=variant),
        get_generator(config))
    reconstruction_ae = StyleganAutoencoder(
        WPlusEncoder(size, latent, in_ch, channels, stylegan_variant=variant),
        get_generator(config))
    return generation_ae, reconstruction_ae, get_discriminator(config)


def init_networks(networks, seed: int) -> None:
    """Random init of the three networks from one seeded torch.Generator."""
    gen = torch.Generator().manual_seed(seed)
    generation_ae, reconstruction_ae, discriminator = networks
    for ae in (generation_ae, reconstruction_ae):
        ae.encoder.init_weights(gen)
        ae.decoder.init_weights(gen)
    discriminator.init_weights(gen)


def make_optimizer(params, config: dict) -> GANOptimizer:
    """clip_by_global_norm(1.0) -> add_decayed_weights(weight_decay) ->
    adam(lr, beta1, beta2)."""
    lr = float(config["lr"])
    return GANOptimizer(params, lambda _: lr,
                        (float(config.get("beta1", 0.5)), float(config.get("beta2", 0.999))),
                        max_norm=1.0, weight_decay=float(config.get("weight_decay", 0.0)))


def main(args: argparse.Namespace) -> Trainer:
    """Train as configured; returns the finished Trainer."""
    warn_ignored_torch_args(args)
    config = load_config_from_checkpoint(args.autoencoder_checkpoint, args.config)
    if args.overwrite_config and args.config:
        config.update(load_config_file(args.config))
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    device = launch(args)
    log_dir = Path(args.log_dir)
    seed = int(config.get("seed", 0))

    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset

    def loader(json_path):
        json_path = Path(json_path)
        dataset = GANImageDataset(json_path, root=json_path.parent,
                                  image_size=config["image_size"],
                                  num_channels=config.get("input_dim", 3))
        return make_loader(dataset, int(config["batch_size"]), shuffle=True, drop_last=True,
                           num_workers=0 if args.debug else int(config.get("num_workers", 8)),
                           seed=seed, pin_memory=device.type == "cuda", sharded=True)

    real_loader = loader(args.original_images)
    fake_loader = loader(args.fake_images)

    networks = build_networks(config)
    init_networks(networks, seed)
    generation_ae, reconstruction_ae, discriminator = networks
    snapshot = load_autoencoder_snapshot(args.autoencoder_checkpoint)
    if snapshot is not None:
        load_autoencoder_state(reconstruction_ae, snapshot["autoencoder"])
        if "g_ema" in snapshot:  # the decoder starts from the generator's weights
            load_autoencoder_state(generation_ae.decoder, snapshot["g_ema"], "style")
    generation_ae.to(device).train()
    reconstruction_ae.to(device).eval().requires_grad_(False)
    discriminator.to(device)

    state = AdversarialTrainState(
        generator=generation_ae, discriminator=discriminator, reconstructor=reconstruction_ae,
        g_optimizer=make_optimizer(generation_ae.parameters(), config),
        d_optimizer=make_optimizer(discriminator.parameters(), config))
    perceptual = PerceptualAndStyleLoss(use_style_loss=False).to(device)
    steps = make_adversarial_steps(perceptual, loss_weights=config.get("loss_weights"))
    real_stream = EpochStream(real_loader, key="images")
    fake_stream = EpochStream(fake_loader, key="images")
    updater = AdversarialAutoencoderUpdater(
        steps, state, {"original_images": real_stream, "binary_images": fake_stream},
        seed=seed, device=device)
    trainer = Trainer(updater, (int(config["max_iter"]), "iteration"), log_dir=log_dir)
    if is_main_process():
        save_run_config(log_dir, config, args)

    def save(t: Trainer, path: Path) -> None:
        s = t.updater.state
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        torch.save({"generator": s.generator.state_dict(),
                    "discriminator": s.discriminator.state_dict(),
                    "generator_optimizer": s.g_optimizer.state_dict(),
                    "discriminator_optimizer": s.d_optimizer.state_dict(),
                    "iteration": t.updater.iteration}, tmp)
        os.replace(tmp, path)

    trainer.extend(Snapshotter(save, log_dir,
                               trigger=(int(config.get("snapshot_save_iter", 10000)), "iteration")))

    probe_binary = next(iter(fake_loader))["images"][:4].to(device)
    probe_style = next(iter(real_loader))["images"][:4].to(device)

    @torch.no_grad()
    def render_probe(t: Trainer) -> np.ndarray:
        s = t.updater.state
        g = torch.Generator(device=device).manual_seed(0)
        # the statistics' running averages, as the JAX CLI's probe (the
        # steps put the module back in training mode)
        fake = s.generator.eval()(probe_binary, probe_style, generator=g)
        recon = s.reconstructor(fake, generator=g)
        cols = [make_image(c) for c in (probe_binary, probe_style, fake, recon)]
        rows = [np.concatenate([c[i] for c in cols], axis=1) for i in range(len(cols[0]))]
        return np.concatenate(rows, axis=0)

    trainer.extend(ImagePlotter(render_probe, log_dir,
                                trigger=(int(config.get("image_save_iter", 1000)), "iteration")))
    trainer.extend(LogWriter(log_dir, trigger=(int(config.get("log_iter", 10)), "iteration")))
    alarm_cfg = dict(config.get("quality_alarm") or {})
    if alarm_cfg.pop("enabled", True):
        alarm_cfg.setdefault("d_loss_key", "discriminator/loss")
        trainer.extend(DivergenceAlarm(trigger=(1, "epoch"), log_dir=log_dir, **alarm_cfg))
    try:
        trainer.train()
    finally:
        real_stream.close()
        fake_stream.close()
    return trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train an adversarial binary-to-styled-image generator")
    parser.add_argument("config", help="path to yaml config to use for training")
    parser.add_argument("autoencoder_checkpoint")
    parser.add_argument("--overwrite-config", action="store_true", default=False)
    parser.add_argument("-o", "--original-images", required=True)
    parser.add_argument("-f", "--fake-images", required=True)
    parser.add_argument("--val-images", dest="val_images", default=None,
                        help="accepted and unused, as in the JAX CLI")
    parser.add_argument("--absolute", action="store_true", default=False)
    parser.add_argument("-l", "--log-dir", default="adversarial_training")
    parser.add_argument("-ln", "--log-name", default="training")
    parser.add_argument("--debug", action="store_true", default=False,
                        help="no loader worker processes")
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
