"""Input / ground truth / prediction rows for the segmenter's image plotter
(counterpart of synthesis_in_style_tpu/visualization/segmentation_plotter.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from synthesis_in_style_tpu_torch.utils.segmentation_utils import (
    class_image_to_segmentation_image,
)
from synthesis_in_style_tpu_torch.visualization.utils import network_output_to_color_image


def render_segmentation_grid(input_images: np.ndarray, label_images: np.ndarray,
                             predictions: np.ndarray, class_to_color_map: Dict) -> np.ndarray:
    """One row [input | ground truth | prediction] per sample, as one uint8
    image. input_images (B, H, W, C) in [-1, 1]; label_images (B, H, W)
    ints; predictions (B, H, W, num_classes) scores."""
    inputs = np.clip((np.asarray(input_images) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    if inputs.shape[-1] == 1:
        inputs = np.repeat(inputs, 3, axis=-1)
    gts = np.stack([class_image_to_segmentation_image(np.asarray(lbl), class_to_color_map)
                    for lbl in label_images])
    preds = network_output_to_color_image(predictions, class_to_color_map)
    rows = [np.concatenate([i, g, p], axis=1) for i, g, p in zip(inputs, gts, preds)]
    return np.concatenate(rows, axis=0)
