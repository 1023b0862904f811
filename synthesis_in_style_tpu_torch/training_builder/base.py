"""Train builders (counterpart of synthesis_in_style_tpu/training_builder/base.py):
network, optimizer, updater, snapshotter, evaluator and image plotter of one
segmentation architecture.

A snapshot is `<log_dir>/checkpoints/iter_<N>.pt` holding
`segmentation_network` (the network's state dict, reference layout; EMANet's
µ bases are its `emau.mu` buffer) and `main_optimizer` (the torch
optimizer's state: DocUFCN's Adam, TransUNet's and EMANet's SGD).
`--fine-tune` loads the network only; `--resume-ckpt` loads both and the
iteration.

In a launched multi-process run every process builds the same network from
the same seed, its train loader is its shard (cli/train.py), and the
optimizers average the gradients (parallel/distributed.py), so the replicas
stay equal; only rank 0 writes snapshots and images (core/extensions.py).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from synthesis_in_style_tpu_torch.core.extensions import Evaluator, ImagePlotter, Snapshotter
from synthesis_in_style_tpu_torch.core.schedules import segmentation_lr_schedule
from synthesis_in_style_tpu_torch.data.loader import EpochStream
from synthesis_in_style_tpu_torch.evaluation.metrics import (
    calculate_confusion_matrix,
    calculate_metric,
)
from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.updaters.segmentation_updater import SegmentationUpdater
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    SEGMENTATION_NETWORK_KEY,
    load_segmenter_snapshot,
    save_segmenter_snapshot,
)


class BaseTrainBuilder:
    def __init__(self, config: dict, train_data_loader=None, val_data_loader=None,
                 seed: int = 0, device="cuda"):
        self.config = config
        self.train_data_loader = train_data_loader
        self.val_data_loader = val_data_loader
        self.seed = seed
        self.device = torch.device(device)
        self.network = self._build_network()
        init = torch.Generator().manual_seed(seed)
        self.network.init_weights(init)
        self._load_pretrained()
        if config.get("fine_tune"):
            self.load_network(config["fine_tune"])
        # cuDNN's NHWC convolutions; the loader's NHWC batches are already
        # channels last as NCHW views
        memory_format = torch.channels_last if self.device.type == "cuda" else \
            torch.contiguous_format
        self.network.to(self.device, memory_format=memory_format)
        self._optimizer = None
        self._updater: Optional[SegmentationUpdater] = None

    # ---------------- per architecture ----------------

    def _build_network(self) -> nn.Module:
        raise NotImplementedError

    def _build_optimizer(self):
        """An optimizer with `step(grads)`, `count`, `state_dict()` and
        `load_state_dict()`."""
        raise NotImplementedError

    def _load_pretrained(self) -> None:
        """Weights from outside the port's snapshots, applied after the
        seeded init (none by default)."""

    def _updater_kwargs(self) -> dict:
        """The updater's step: DocUFCN's weighted cross-entropy by default."""
        return {"class_weights": self.config.get("class_weights")}

    def segmenter_config(self) -> SegmenterConfig:
        if hasattr(self.network, "segmenter_config"):
            return self.network.segmenter_config()
        return SegmenterConfig(num_classes=self.config["num_classes"])

    # ---------------- optimizer / state ----------------

    def lr_schedule(self) -> Callable[[int], float]:
        per_epoch = len(self.train_data_loader) if self.train_data_loader is not None else 1
        return segmentation_lr_schedule(self.config, per_epoch)

    @property
    def optimizer(self):
        if self._optimizer is None:
            self._optimizer = self._build_optimizer()
        return self._optimizer

    def load_network(self, checkpoint) -> None:
        """Network weights (and BatchNorm statistics) only."""
        snap = load_segmenter_snapshot(checkpoint)
        self.network.load_state_dict(snap[SEGMENTATION_NETWORK_KEY], strict=True)

    def resume(self, checkpoint) -> None:
        """Network, optimizer state (its update count included)."""
        snap = load_segmenter_snapshot(checkpoint)
        self.network.load_state_dict(snap[SEGMENTATION_NETWORK_KEY], strict=True)
        if "main_optimizer" in snap:
            self.optimizer.load_state_dict(snap["main_optimizer"])

    # ---------------- trainer wiring ----------------

    def get_updater(self) -> SegmentationUpdater:
        if self._updater is None:
            self._updater = SegmentationUpdater(
                self.network, self.optimizer,
                iterators={"images": EpochStream(self.train_data_loader)},
                compute_dtype=self.config.get("compute_dtype"), seed=self.seed,
                device=self.device, **self._updater_kwargs())
        return self._updater

    def get_snapshotter(self, log_dir=None) -> Snapshotter:
        def save(trainer, path: Path) -> None:
            save_segmenter_snapshot(path, self.network, self.optimizer,
                                    trainer.updater.iteration)

        return Snapshotter(save, log_dir or self.config["log_dir"],
                           trigger=(int(self.config.get("snapshot_save_iter", 1000)), "iteration"))

    # ---------------- evaluation / plotting ----------------

    @torch.no_grad()
    def predict_logits(self, images: torch.Tensor) -> torch.Tensor:
        """Eval-mode float32 logits (B, C, H, W) of NHWC images."""
        was_training = self.network.training
        self.network.eval()
        try:
            return self.network(images.to(self.device).permute(0, 3, 1, 2)).float()
        finally:
            self.network.train(was_training)

    def class_names(self):
        path = self.config.get("class_to_color_map")
        if path and Path(path).exists():
            with open(path) as f:
                return list(json.load(f).keys())
        return [f"class_{i}" for i in range(self.segmenter_config().num_classes)]

    def evaluate(self) -> Dict[str, float]:
        """Dice and IoU (weighted averages, all classes and text classes)
        over the validation loader."""
        num_classes = self.segmenter_config().num_classes
        class_names = list(self.class_names())
        confusion = np.zeros((num_classes, num_classes))
        for batch in self.val_data_loader:
            pred = self.predict_logits(batch["images"]).argmax(dim=1)
            confusion += calculate_confusion_matrix(batch["segmented"].to(pred.device), pred,
                                                    num_classes)
        out = {}
        for metric in ("dice", "iou"):
            scores = calculate_metric(confusion, class_names, metric)
            out[f"{metric}_weighted_avg"] = scores["weighted_avg"]["score"]
            out[f"{metric}_weighted_text_avg"] = scores["weighted_text_avg"]["score"]
        return out

    def get_evaluator(self) -> Optional[Evaluator]:
        if self.val_data_loader is None:
            return None
        return Evaluator(lambda trainer: self.evaluate(), trigger=(1, "epoch"),
                         prefix="evaluation")

    def get_image_plotter(self, log_dir=None) -> Optional[ImagePlotter]:
        loader = self.val_data_loader or self.train_data_loader
        if loader is None:
            return None
        from synthesis_in_style_tpu_torch.visualization.segmentation_plotter import (
            render_segmentation_grid,
        )

        dataset = loader.dataset
        n = min(int(self.config.get("display_size", 4)), len(dataset))
        samples = [dataset[i] for i in range(n)]
        inputs = torch.stack([s["images"] for s in samples])
        labels = torch.stack([s["segmented"] for s in samples]).numpy()
        with open(self.config["class_to_color_map"]) as f:
            color_map = json.load(f)

        def render(trainer) -> np.ndarray:
            logits = self.predict_logits(inputs).permute(0, 2, 3, 1).cpu().numpy()
            return render_segmentation_grid(inputs.numpy(), labels, logits, color_map)

        return ImagePlotter(render, log_dir or self.config["log_dir"],
                            trigger=(int(self.config.get("image_save_iter", 1000)), "iteration"))

    # ---------------- inference loading ----------------

    def get_network_for_inference(self, checkpoint) -> Tuple[nn.Module, SegmenterConfig]:
        """(network in eval mode on the builder's device, its postprocess
        settings) from a snapshot or a reference `.pt`."""
        self.load_network(checkpoint)
        return self.network.eval(), self.segmenter_config()
