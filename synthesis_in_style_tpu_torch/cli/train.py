"""Train a segmentation network on a labelled [image|mask] dataset
(counterpart of synthesis_in_style_tpu/cli/train.py).

The same flags and config keys as the JAX CLI, plus `-d/--device` (default
cuda): the YAML config merged under the flags, the log directory
`logs/<log_dir>/<log_name>/<timestamp>` (an absolute `-l` replaces `logs`),
`config/config.json`, `log.jsonl`, snapshots `checkpoints/iter_<N>.pt`
(`segmentation_network`, `main_optimizer`), sample grids under `images/`,
learning-rate reports, and dice / IoU on `--val-images` every epoch and at
the end. `--fine-tune` loads a snapshot's (or a reference `.pt`'s) network;
`--resume-ckpt <snapshot>` resumes network, optimizer, iteration and data
position. Augmentation runs in the loader workers without OpenCV.

Not ported yet (each raises NotImplementedError, see ROADMAP.md):
`--resume-ckpt latest`, `--cache-root`, wandb logging, `--profile-dir`,
networks other than DocUFCN, `dataset: dataset_gan`, and more than one
process.

Usage:
  python -m synthesis_in_style_tpu_torch.cli.train <config.yaml> \\
      --images train.json --class-to-color-map colors.json -l out -ln run1 [-d cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import resolve_log_dir
from synthesis_in_style_tpu_torch.core.config import (
    load_config_file,
    merge_config_and_args,
    save_run_config,
)
from synthesis_in_style_tpu_torch.core.extensions import LogWriter, LRReporter
from synthesis_in_style_tpu_torch.core.trainer import Trainer
from synthesis_in_style_tpu_torch.data.loader import make_loader
from synthesis_in_style_tpu_torch.data.segmentation_dataset import AugmentedSegmentationDataset
from synthesis_in_style_tpu_torch.training_builder import get_train_builder_class
from synthesis_in_style_tpu_torch.utils.checkpoint import snapshot_iteration


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to synthesis_in_style_tpu_torch yet (see ROADMAP.md)"
    )


def sanity_check_config(config: dict) -> None:
    if "network" in config:
        choices = ["DocUFCN", "TransUNet", "EMANet", "PixelEnsemble"]
        assert config["network"] in choices, f'The network must be one of: {", ".join(choices)}'
    if "dataset" in config:
        choices = ["wpi", "dataset_gan"]
        assert config["dataset"] in choices, f'The dataset must be one of: {", ".join(choices)}'
    with open(config["class_to_color_map"]) as f:
        class_to_color_map = json.load(f)
    assert len(class_to_color_map) == config["num_classes"], (
        "The number of classes in the class_to_color_map must be equal to "
        "the num_classes in the config"
    )


def check_supported(config: dict) -> None:
    """Raise on every option this port does not implement yet."""
    if config.get("resume_ckpt") == "latest":
        raise _not_ported("--resume-ckpt latest")
    for key, flag in (("cache_root", "--cache-root"), ("wandb_project_name", "wandb logging"),
                      ("profile_dir", "--profile-dir")):
        if config.get(key):
            raise _not_ported(flag)
    if config.get("network", "DocUFCN") != "DocUFCN":
        raise _not_ported(f"network {config['network']}")
    if config.get("dataset", "wpi") != "wpi":
        raise _not_ported(f"dataset {config['dataset']}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or config.get("local_rank") is not None or \
            config.get("mpi_backend"):
        raise _not_ported("training in more than one process")


def get_data_loader(json_path: Path, config: dict, args: argparse.Namespace,
                    validation: bool = False, pin_memory: bool = False):
    dataset = AugmentedSegmentationDataset(
        json_path, class_to_color_map_path=Path(args.class_to_color_map),
        root=json_path.parent, image_size=config["image_size"],
        num_augmentations=config.get("num_augmentations", 1),
        num_input_channels=config.get("input_dim", 3))
    num_workers = 0 if args.debug else int(config.get("num_workers", 8))
    return make_loader(dataset, int(config["batch_size"]), shuffle=not validation,
                       drop_last=not validation, num_workers=num_workers,
                       seed=int(config.get("seed", 0)), pin_memory=pin_memory)


def main(args: argparse.Namespace) -> Trainer:
    """Train as configured; returns the finished Trainer."""
    config = merge_config_and_args(load_config_file(args.config), args)
    config["log_dir"] = args.log_dir
    check_supported(config)
    sanity_check_config(config)
    device = torch.device(config["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    seed = int(config.get("seed", 0))

    pin = device.type == "cuda"
    train_loader = get_data_loader(Path(config["train_json"]), config, args, pin_memory=pin)
    val_loader = (get_data_loader(Path(config["validation_json"]), config, args,
                                  validation=True, pin_memory=pin)
                  if config.get("validation_json") else None)
    builder = get_train_builder_class(config)(config, train_loader, val_loader, seed=seed,
                                              device=device)
    resume_iteration = 0
    if config.get("resume_ckpt"):
        builder.resume(config["resume_ckpt"])
        resume_iteration = snapshot_iteration(config["resume_ckpt"])

    if "max_iter" in config:
        stop_trigger = (int(config["max_iter"]), "iteration")
    else:
        stop_trigger = (int(config["epochs"]), "epoch")
    updater = builder.get_updater()
    trainer = Trainer(updater, stop_trigger, log_dir=args.log_dir)
    if resume_iteration:
        updater.iteration = resume_iteration
        updater.iterators["images"].seek(resume_iteration)
    save_run_config(args.log_dir, config, args)

    evaluator = builder.get_evaluator()
    if evaluator is not None:
        trainer.extend(evaluator)
    trainer.extend(builder.get_snapshotter())
    image_plotter = builder.get_image_plotter()
    if image_plotter is not None:
        trainer.extend(image_plotter)
    log_trigger = (int(config.get("log_iter", 10)), "iteration")
    trainer.extend(LRReporter({"main": builder.lr_schedule()}, trigger=log_trigger))
    trainer.extend(LogWriter(args.log_dir, trigger=log_trigger))
    try:
        trainer.train()
    finally:
        updater.iterators["images"].close()
    return trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train a network for semantic segmentation of documents")
    parser.add_argument("config", help="path to config with common train settings")
    parser.add_argument("-op", "--original-generator-config-path", type=Path, default=None)
    parser.add_argument("--images", dest="train_json", required=True,
                        help="Path to json file with train images")
    parser.add_argument("--val-images", dest="validation_json", default=None,
                        help="path to json file with validation images")
    parser.add_argument("--coco-gt", default=None)
    parser.add_argument("--fine-tune", default=None, help="Path to model to finetune from")
    parser.add_argument("--resume-ckpt", dest="resume_ckpt", default=None,
                        help="snapshot to resume network, optimizer, iteration and data "
                        "position from ('latest' is not ported yet)")
    parser.add_argument("--class-to-color-map", default="handwriting_colors.json")
    parser.add_argument("-c", "--cache-root", default=None,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("-l", "--log-dir", default="training", help="outputs path")
    parser.add_argument("-ln", "--log-name", default="training")
    parser.add_argument("--warm-restarts", action="store_true", default=None)
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


if __name__ == "__main__":
    main(resolve_log_dir(build_parser().parse_args()))
