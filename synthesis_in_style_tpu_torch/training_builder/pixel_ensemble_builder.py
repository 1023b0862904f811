"""PixelEnsemble (DatasetGAN) train builder (counterpart of
synthesis_in_style_tpu/training_builder/pixel_ensemble_builder.py): the
stacked ensemble (feature length from the training set), the per-member
clip / weight-decay / Adam chain at a constant `lr` (`EnsembleOptimizer`),
the dice evaluator, the DatasetGAN plotter and the snapshots.

The training set is the dataset itself, never wrapped in loader workers:
its batches are gathered on the device by `sample_pixel_batches`. A
snapshot is `checkpoints/iter_<N>.pt` in the reference layout
(`network_<i>`, `optimizer_<i>`); `--fine-tune` loads the members of such a
snapshot (or of a JAX `.npz`), `--resume-ckpt` also their optimizer states
and the iteration. As in the JAX package, a resumed run's pixel stream
starts again from its seed.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

import numpy as np
import torch

from synthesis_in_style_tpu_torch.core.extensions import Evaluator, ImagePlotter, Snapshotter
from synthesis_in_style_tpu_torch.core.schedules import segmentation_lr_schedule
from synthesis_in_style_tpu_torch.evaluation.dataset_gan_evaluator import (
    make_dataset_gan_eval_fn,
)
from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.models.pixel_classifier import PixelEnsembleClassifier
from synthesis_in_style_tpu_torch.training_builder.base import BaseTrainBuilder
from synthesis_in_style_tpu_torch.updaters.dataset_gan_updater import (
    DatasetGANUpdater,
    EnsembleOptimizer,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    load_pixel_ensemble_state,
    save_pixel_ensemble_snapshot,
)


class PixelEnsembleTrainBuilder(BaseTrainBuilder):
    @property
    def train_dataset(self):
        return getattr(self.train_data_loader, "dataset", self.train_data_loader)

    def _build_network(self) -> PixelEnsembleClassifier:
        get_len = getattr(self.train_dataset, "get_feature_vector_length", None)
        if get_len is None:
            raise RuntimeError(
                'The given dataset does not seem to implement the "get_feature_vector_length" '
                "method. However, this is required for initializing the PixelEnsemble classifier"
            )
        return PixelEnsembleClassifier(
            self.config.get("numpy_class", self.config.get("num_classes", 3)), get_len(),
            self.config["num_models"])

    def _build_optimizer(self) -> EnsembleOptimizer:
        config = self.config
        return EnsembleOptimizer(
            self.network, float(config["lr"]),
            (float(config.get("beta1", 0.9)), float(config.get("beta2", 0.999))),
            weight_decay=float(config.get("weight_decay", 0.0)))

    def lr_schedule(self) -> Callable[[int], float]:
        """The schedule the LR reporter logs, over len(dataset) // batch_size
        batches an epoch. The optimizer steps at the constant `lr`, as the
        JAX package's does."""
        per_epoch = len(self.train_dataset) // int(self.config["batch_size"])
        return segmentation_lr_schedule(self.config, per_epoch)

    def segmenter_config(self) -> SegmenterConfig:
        return SegmenterConfig(num_classes=self.network.num_classes)

    def load_network(self, checkpoint) -> None:
        self.network.load_state_dict(load_pixel_ensemble_state(checkpoint)["ensemble"])

    def resume(self, checkpoint) -> None:
        snap = load_pixel_ensemble_state(checkpoint)
        self.network.load_state_dict(snap["ensemble"])
        if "optimizers" in snap:
            self.optimizer.load_member_state_dicts(snap["optimizers"])

    def get_updater(self) -> DatasetGANUpdater:
        if self._updater is None:
            dataset = self.train_dataset
            batch_size = int(self.config["batch_size"])
            iterator = EpochAwareBatches(dataset.sample_pixel_batches(batch_size, self.seed),
                                         dataset)
            self._updater = DatasetGANUpdater(
                self.network, self.optimizer, iterators={"feature_vectors": iterator},
                dataset=dataset if hasattr(dataset, "reset_dataset") else None,
                seed=self.seed, device=self.device)
        return self._updater

    def get_snapshotter(self, log_dir=None) -> Snapshotter:
        def save(trainer, path) -> None:
            members = [self.network.member_state_dict(i) for i in range(self.network.num_models)]
            save_pixel_ensemble_snapshot(path, members, self.optimizer.member_state_dicts(),
                                         trainer.updater.iteration)

        return Snapshotter(save, log_dir or self.config["log_dir"],
                           trigger=(int(self.config.get("snapshot_save_iter", 1000)), "iteration"))

    def get_evaluator(self) -> Optional[Evaluator]:
        if self.val_data_loader is None:
            print("No validation dataset is given. Omitting Evaluator...")
            return None
        val_dataset = getattr(self.val_data_loader, "dataset", self.val_data_loader)

        def val_batches():
            f = val_dataset.feature_vector_length
            for i in range(val_dataset.pixel_labels.shape[0]):
                yield {"activations": val_dataset.pixel_activations[i].reshape(-1, f),
                       "label": torch.from_numpy(val_dataset.pixel_labels[i].reshape(-1))}

        return Evaluator(make_dataset_gan_eval_fn(self.network, val_batches),
                         trigger=(1, "epoch"))

    def get_image_plotter(self, log_dir=None) -> Optional[ImagePlotter]:
        from synthesis_in_style_tpu_torch.visualization.dataset_gan_plotter import (
            render_dataset_gan_grid,
        )

        images, acts, labels = self.train_dataset.get_images_for_plot(
            int(self.config.get("display_size", 4)))
        if not images:
            return None
        with open(self.config["class_to_color_map"]) as f:
            color_map = json.load(f)

        def render(trainer) -> np.ndarray:
            return render_dataset_gan_grid(images, acts, labels, self.network, color_map)

        return ImagePlotter(render, log_dir or self.config["log_dir"],
                            trigger=(int(self.config.get("image_save_iter", 1000)), "iteration"))


class EpochAwareBatches:
    """The dataset's batch stream, with the dataset's epoch."""

    def __init__(self, iterator, dataset):
        self._iterator = iterator
        self.dataset = dataset

    def __next__(self):
        return next(self._iterator)

    def __iter__(self):
        return self

    @property
    def epoch(self) -> float:
        return getattr(self.dataset, "epoch", 0.0)
