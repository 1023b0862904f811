"""Prediction -> colour image rendering (counterpart of
synthesis_in_style_tpu/visualization/utils.py), numpy NHWC. The JAX
package's confidence shading belongs to page inference's `-vis`, which is
not ported."""

from __future__ import annotations

from typing import Dict

import numpy as np

from synthesis_in_style_tpu_torch.utils.segmentation_utils import parse_color


def network_output_to_color_image(network_outputs: np.ndarray,
                                  class_to_color_map: Dict) -> np.ndarray:
    """(B, H, W, C) class scores -> (B, H, W, 3) uint8 colour images of
    their argmax."""
    network_outputs = np.asarray(network_outputs)
    batch_size, height, width, num_predicted_classes = network_outputs.shape
    assert num_predicted_classes == len(class_to_color_map), (
        "Number of predicted classes and expected classes does not match "
        f"{num_predicted_classes} vs {len(class_to_color_map)}"
    )
    out = np.zeros((batch_size, height, width, 3), np.uint8)
    out[:, :, :] = parse_color(class_to_color_map["background"])
    predicted = np.argmax(network_outputs, axis=-1)
    for class_id, (class_name, color) in enumerate(class_to_color_map.items()):
        if class_name != "background":
            out[predicted == class_id] = parse_color(color)
    return out
