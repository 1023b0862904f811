"""Prediction -> colour image rendering (counterpart of
synthesis_in_style_tpu/visualization/utils.py), numpy NHWC, with the
confidence-gradient mode of page inference's `-vis --show-confidence`."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from synthesis_in_style_tpu_torch.utils.segmentation_utils import parse_color

Color = Tuple[int, int, int]


def linear_gradient(start_rgb: Color, finish_rgb: Color, n: int = 10) -> List[Color]:
    """n evenly spaced colours from start to finish (truncated to int)."""
    colors = [start_rgb]
    for t in range(1, n):
        colors.append(tuple(
            int(start_rgb[j] + (float(t) / (n - 1)) * (finish_rgb[j] - start_rgb[j]))
            for j in range(3)))
    return colors


def network_output_to_color_image(network_outputs: np.ndarray, class_to_color_map: Dict,
                                  show_confidence_in_segmentation: bool = False) -> np.ndarray:
    """(B, H, W, C) class scores -> (B, H, W, 3) uint8 colour images of
    their argmax. With show_confidence_in_segmentation, pixels with any
    non-background score are shaded from white to their class colour by
    their largest score."""
    network_outputs = np.asarray(network_outputs)
    batch_size, height, width, num_predicted_classes = network_outputs.shape
    assert num_predicted_classes == len(class_to_color_map), (
        "Number of predicted classes and expected classes does not match "
        f"{num_predicted_classes} vs {len(class_to_color_map)}"
    )
    out = np.zeros((batch_size, height, width, 3), np.uint8)
    out[:, :, :] = parse_color(class_to_color_map["background"])
    if show_confidence_in_segmentation:
        steps = 100
        gradient_luts = np.asarray([linear_gradient((255, 255, 255), parse_color(color), steps)
                                    for color in class_to_color_map.values()], np.uint8)
        not_background = network_outputs[..., 1:].sum(axis=-1) > 0
        class_idx = np.argmax(network_outputs, axis=-1)
        strength = np.max(network_outputs, axis=-1)
        strength_idx = np.clip((steps * strength).astype(np.int64) - 1, 0, steps - 1)
        shaded = gradient_luts[class_idx, strength_idx]
        out[not_background] = shaded[not_background]
        return out
    predicted = np.argmax(network_outputs, axis=-1)
    for class_id, (class_name, color) in enumerate(class_to_color_map.items()):
        if class_name != "background":
            out[predicted == class_id] = parse_color(color)
    return out
