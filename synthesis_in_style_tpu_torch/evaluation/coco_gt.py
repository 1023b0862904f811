"""Per-image `has_<class>` flags of the train/val split (counterpart of
`COCOGtCreator.determine_classes_in_image` in
synthesis_in_style_tpu/evaluation/coco_gt.py), without OpenCV.

The JAX package sets `has_<class>` when the class mask has an external
contour of at least three points (cv2.findContours, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE). That compression keeps only the end points of a
horizontal, vertical or diagonal run, so a component yields fewer than three
points exactly when all its pixels lie on one such line. Its pixels then
have 8-neighbours along one direction only; any other 8-connected component
has a pixel with neighbours along two directions (a connected graph whose
edges come in two directions has a vertex touching both). So the flag is:
some pixel of the mask has mask neighbours along two of the four directions.

`coco_gt.json` (polygon tracing) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable

import numpy as np

from synthesis_in_style_tpu_torch.utils.segmentation_utils import parse_color

# the four neighbour directions up to sign: horizontal, vertical, two diagonals
_DIRECTIONS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _shifted(mask: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """out[y, x] = mask[y + dy, x + dx], False outside."""
    h, w = mask.shape
    out = np.zeros_like(mask)
    out[max(-dy, 0): h - max(dy, 0), max(-dx, 0): w - max(dx, 0)] = mask[
        max(dy, 0): h - max(-dy, 0), max(dx, 0): w - max(-dx, 0)
    ]
    return out


def has_contour_of_three_points(mask: np.ndarray) -> bool:
    """True iff the (H, W) mask has an 8-connected component that is not a
    straight horizontal, vertical or diagonal run (see module docstring)."""
    mask = np.asarray(mask, bool)
    directions = np.zeros(mask.shape, np.int32)
    for dy, dx in _DIRECTIONS:
        directions += _shifted(mask, dy, dx) | _shifted(mask, -dy, -dx)
    return bool((mask & (directions >= 2)).any())


def class_mask(label_image: np.ndarray, color) -> np.ndarray:
    return np.all(label_image == np.asarray(parse_color(color)), axis=2)


def determine_classes_in_image(pair_image: np.ndarray, class_to_color_map: Dict) -> Dict[str, bool]:
    """`has_<class>` flags of an (H, 2W, 3) [image|label] pair."""
    _, label_image = np.split(pair_image, 2, axis=1)
    return {
        f"has_{name}": has_contour_of_three_points(class_mask(label_image, color))
        for name, color in class_to_color_map.items()
        if name != "background"
    }


def iter_through_images_in(image_root: Path, extension: str = "png") -> Iterable[Path]:
    yield from sorted(Path(image_root).glob(f"**/*.{extension}"))
