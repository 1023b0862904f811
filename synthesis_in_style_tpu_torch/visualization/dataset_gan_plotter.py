"""DatasetGAN plotter (counterpart of
synthesis_in_style_tpu/visualization/dataset_gan_plotter.py): one row per
image, [generated image | ground-truth colours | the ensemble's vote]."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from synthesis_in_style_tpu_torch.utils.segmentation_utils import (
    class_image_to_segmentation_image,
)


def render_dataset_gan_grid(images: Sequence[np.ndarray], pixel_activations: Sequence[torch.Tensor],
                            label_images: Sequence[np.ndarray], ensemble,
                            class_to_color_map: Dict) -> np.ndarray:
    """(H * n, 3 * W, 3) uint8 grid of the n images; (S, S, F) activations
    and (S, S) labels per image."""
    rows = []
    for image, acts, labels in zip(images, pixel_activations, label_images):
        h, w, f = acts.shape
        pred = ensemble.predict_classes(acts.reshape(-1, f)).view(h, w).cpu().numpy()
        gt_color = class_image_to_segmentation_image(np.asarray(labels).astype(np.int64),
                                                     class_to_color_map)
        pred_color = class_image_to_segmentation_image(pred, class_to_color_map)
        image = np.asarray(image)
        if image.shape[:2] != (h, w):
            from PIL import Image

            image = np.asarray(Image.fromarray(image).resize((w, h)))
        rows.append(np.concatenate([image, gt_color, pred_color], axis=1))
    return np.concatenate(rows, axis=0)
