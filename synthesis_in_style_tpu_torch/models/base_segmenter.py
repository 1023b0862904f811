"""Segmenter prediction layer (counterpart of
synthesis_in_style_tpu/models/base_segmenter.py): the postprocess settings,
the softmax with its confidence threshold, and the host small-contour
filter (`get_contours_from_prediction`, `remove_too_small_contours`) on the
OpenCV-free primitives of utils/contour_ops.py. Page inference can filter
on the device instead (segmentation/device_cc.py `filter_small_components`,
pixel areas where this filter measures polygon areas).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from synthesis_in_style_tpu_torch.utils import contour_ops


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    num_classes: int
    background_class_id: int = 0
    min_confidence: float = 0.0
    min_contour_area: int = 0
    num_input_channels: int = 3


def predict_probabilities(logits: torch.Tensor, min_confidence: float = 0.0,
                          dim: int = -1) -> torch.Tensor:
    """Float32 softmax over the class axis `dim`, confidences below
    `min_confidence` set to 0."""
    probs = torch.softmax(logits.float(), dim=dim)
    return torch.where(probs < min_confidence, torch.zeros_like(probs), probs)


def get_contours_from_prediction(class_prediction: np.ndarray) -> Optional[List[np.ndarray]]:
    """External contours (CHAIN_APPROX_NONE) of the 5x5 closing of
    uint8(confidence * 255) of one (H, W) confidence map; None if the closed
    map is empty."""
    scaled = (np.asarray(class_prediction, np.float32) * 255).astype(np.uint8)
    closed = contour_ops.morph_close(scaled, 5)
    if not closed.any():
        return None
    return contour_ops.find_contours(closed, "none")


def remove_too_small_contours(predictions: np.ndarray, min_contour_area: int,
                              background_class_id: int = 0) -> np.ndarray:
    """Zero the regions whose contour (polygon) area is below
    min_contour_area in every non-background class of (B, H, W, C) host
    probabilities; the maps of a batch are traced together."""
    if min_contour_area <= 0:
        return predictions
    out = np.array(predictions, copy=True)
    b, h, w, c = out.shape
    class_ids = [k for k in range(c) if k != background_class_id]
    if not class_ids:
        return out
    maps = out[..., class_ids].transpose(0, 3, 1, 2).reshape(-1, h, w)
    closed = contour_ops.morph_close((maps.astype(np.float32) * 255).astype(np.uint8), 5)
    for i, contours in enumerate(contour_ops.find_contours_batch(closed, "none")):
        areas = contour_ops.contour_areas(contours)
        small = [ct for ct, area in zip(contours, areas) if area < min_contour_area]
        if not small:
            continue
        keep_mask = np.ones((h, w), np.uint8)
        _, xs, ys = contour_ops.filled_pixels(small)
        keep_mask[ys, xs] = 0
        out[i // len(class_ids), :, :, class_ids[i % len(class_ids)]] *= keep_mask
    return out
