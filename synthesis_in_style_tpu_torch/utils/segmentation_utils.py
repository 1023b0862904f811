"""Colour <-> class helpers (counterpart of part of
synthesis_in_style_tpu/utils/segmentation_utils.py), without PIL."""

from __future__ import annotations

from typing import Dict, Tuple, Union

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
