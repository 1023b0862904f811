"""Colour <-> class helpers (counterpart of part of
synthesis_in_style_tpu/utils/segmentation_utils.py), without PIL."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import numpy as np

Color = Tuple[int, int, int]


def parse_color(color: Union[str, Color]) -> Color:
    """'#rgb' / '#rrggbb' hex strings or (r, g, b) -> (r, g, b) ints.
    Colour names are not supported: give them as hex."""
    if not isinstance(color, str):
        r, g, b = color
        return int(r), int(g), int(b)
    s = color.strip()
    if s.startswith("#") and len(s) in (4, 7):
        digits = s[1:]
        if len(digits) == 3:
            digits = "".join(ch * 2 for ch in digits)
        try:
            return tuple(int(digits[i: i + 2], 16) for i in (0, 2, 4))  # type: ignore[return-value]
        except ValueError:
            pass
    raise ValueError(f"unsupported colour {color!r}: use '#rrggbb' or an (r, g, b) triple")


def resolve_color_map(class_to_color_map: Dict[str, Union[str, Color]]) -> Dict[str, Color]:
    """{class: '#rrggbb' or (r, g, b)} -> {class: (r, g, b)}, order kept."""
    return {name: parse_color(color) for name, color in class_to_color_map.items()}


def get_class_id_map(class_to_color_map: Dict[str, object],
                     background_class_name: str = "background") -> Dict[str, int]:
    """Class name -> id, background 0 and the others in map order from 1."""
    assert background_class_name in class_to_color_map
    class_id_map = {background_class_name: 0}
    others = [n for n in class_to_color_map if n != background_class_name]
    class_id_map.update({name: i + 1 for i, name in enumerate(others)})
    return class_id_map


def segmentation_image_to_class_image(segmentation_image: np.ndarray,
                                      class_to_color_map: Dict[str, Union[str, Color]],
                                      background_class_name: str = "background") -> np.ndarray:
    """(H, W, 3) colour mask -> (H, W) class ids (of the image's dtype);
    a colour of no class is background."""
    color_map = resolve_color_map(class_to_color_map)
    class_id_map = get_class_id_map(color_map, background_class_name)
    class_image = np.zeros(segmentation_image.shape[:2], dtype=segmentation_image.dtype)
    for class_name, color in color_map.items():
        if class_name == background_class_name:
            continue
        mask = np.all(segmentation_image == np.asarray(color), axis=2)
        class_image[mask] = class_id_map[class_name]
    return class_image


def class_image_to_segmentation_image(class_image: np.ndarray,
                                      class_to_color_map: Dict[str, Union[str, Color]],
                                      background_class_name: str = "background") -> np.ndarray:
    """(H, W) class ids -> (H, W, 3) uint8 colour mask."""
    color_map = resolve_color_map(class_to_color_map)
    class_id_map = get_class_id_map(color_map, background_class_name)
    lut = np.zeros((len(class_id_map), 3), np.uint8)
    for name, idx in class_id_map.items():
        lut[idx] = color_map[name]
    return lut[class_image]


class BBox(NamedTuple):
    left: int
    top: int
    right: int
    bottom: int
