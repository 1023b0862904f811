"""Segmenter prediction layer (counterpart of
synthesis_in_style_tpu/models/base_segmenter.py): the postprocess settings
and the softmax with its confidence threshold.

The host contour filter of the JAX package (`get_contours_from_prediction`,
`remove_too_small_contours`, built on OpenCV) is not ported: the port's
page inference filters small regions on the device
(segmentation/device_cc.py `filter_small_components`).
"""

from __future__ import annotations

import dataclasses

import torch


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
