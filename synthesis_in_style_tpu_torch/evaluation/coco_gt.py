"""COCO ground truth of [image|label] PNG pairs (counterpart of
synthesis_in_style_tpu/evaluation/coco_gt.py), without OpenCV: the
compressed-RLE codec (COCO maskApi: column-major run lengths, delta plus
5-bit-chunk signed varint, characters offset by 48), one annotation per
external contour of at least three points of each class mask (the contours
of utils/contour_ops.py, filled as cv2.fillPoly fills them), and the
per-image `has_<class>` flags of the train/val split.

The JAX package sets `has_<class>` when the class mask has an external
contour of at least three points (cv2.findContours, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE). That compression keeps only the end points of a
horizontal, vertical or diagonal run, so a component yields fewer than three
points exactly when all its pixels lie on one such line. Its pixels then
have 8-neighbours along one direction only; any other 8-connected component
has a pixel with neighbours along two directions (a connected graph whose
edges come in two directions has a vertex touching both). So the flag is:
some pixel of the mask has mask neighbours along two of the four directions.
tests/test_torch_host_segmentation.py holds it against `extract_rles`.
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import numpy as np

from synthesis_in_style_tpu_torch.utils.contour_ops import draw_contour_filled, find_contours
from synthesis_in_style_tpu_torch.utils.png import read_png
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


def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """Binary (H, W) mask -> COCO run lengths (column-major, starting with
    the run of zeros)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], changes, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    if not counts:
        counts = [0]
    return counts


def rle_counts_to_string(counts: List[int]) -> str:
    """COCO compressed RLE (maskApi rleToString)."""
    chars = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return "".join(chars)


def rle_string_to_counts(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_encode(mask: np.ndarray) -> Dict:
    """(H, W) binary mask -> {"size": [H, W], "counts": str}."""
    return {"size": [int(mask.shape[0]), int(mask.shape[1])],
            "counts": rle_counts_to_string(mask_to_rle_counts(mask))}


def _counts(rle: Dict) -> List[int]:
    return rle["counts"] if isinstance(rle["counts"], list) else rle_string_to_counts(
        rle["counts"])


def rle_decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for count in _counts(rle):
        flat[pos: pos + count] = val
        pos += count
        val = 1 - val
    return flat.reshape((h, w), order="F")


def rle_area(rle: Dict) -> int:
    return int(sum(_counts(rle)[1::2]))


def rle_to_bbox(rle: Dict) -> List[float]:
    """[x, y, w, h] of the mask's extent (pycocotools toBbox)."""
    ys, xs = np.nonzero(rle_decode(rle))
    if len(xs) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]


def _polygon_to_rle(polygon: np.ndarray, height: int, width: int) -> Dict:
    canvas = np.zeros((height, width), np.uint8)
    draw_contour_filled(canvas, polygon, 1)
    return rle_encode(canvas)


class COCOGtCreator:
    """COCO categories, annotations and images of [image|label] PNG pairs."""

    def __init__(self, class_to_color_map: Dict, image_root: Path = Path("/")):
        self.class_to_color_map = class_to_color_map
        self.categories = self.build_categories()
        self.image_root = Path(image_root)

    def build_categories(self) -> List[dict]:
        return [{"id": category_id, "name": class_name, "supercategory": class_name,
                 "color": color}
                for category_id, (class_name, color) in enumerate(
                    self.class_to_color_map.items())]

    @staticmethod
    def get_label_image(pair_image: np.ndarray) -> np.ndarray:
        _, label_image = np.split(np.asarray(pair_image), 2, axis=1)
        return label_image

    @staticmethod
    def extract_rles(class_mask: np.ndarray) -> List[Dict]:
        """One RLE per external contour (CHAIN_APPROX_SIMPLE) of at least 3
        points, filled."""
        h, w = class_mask.shape[-2:]
        return [_polygon_to_rle(c, h, w) for c in find_contours(class_mask, "simple")
                if c.size >= 6]

    def determine_classes_in_image(self, pair_image: np.ndarray) -> Dict[str, bool]:
        return determine_classes_in_image(pair_image, self.class_to_color_map)

    def build_annotations_for_image(self, pair_image: np.ndarray, image_id: int,
                                    annotation_id: int) -> Tuple[List[dict], int]:
        label_image = self.get_label_image(pair_image)
        annotations = []
        for class_id, (class_name, color) in enumerate(self.class_to_color_map.items()):
            if class_name == "background":
                continue
            for rle in self.extract_rles(class_mask(label_image, color).astype(np.uint8)):
                annotations.append({"id": annotation_id, "image_id": image_id,
                                    "category_id": class_id, "segmentation": rle,
                                    "area": rle_area(rle), "bbox": rle_to_bbox(rle),
                                    "iscrowd": 0})
                annotation_id += 1
        return annotations, annotation_id

    def create_coco_gt_from_image_paths(self, image_paths: Iterable[Path]) -> dict:
        images = []
        annotations = []
        annotation_id = 0
        for i, image_path in enumerate(image_paths):
            pair = read_png(image_path)
            images.append({
                "id": i, "width": pair.shape[1] // 2, "height": pair.shape[0],
                "file_name": str(Path(image_path).relative_to(self.image_root)),
                "license": 0, "flickr_url": "", "coco_url": "",
                "date_captured": str(datetime.datetime.now(datetime.timezone.utc)),
            })
            anns, annotation_id = self.build_annotations_for_image(pair, i, annotation_id)
            annotations.extend(anns)
        return {
            "info": {"year": datetime.date.today().year, "version": "1",
                     "description": "COCO GT for evaluation of semantic segmentation",
                     "contributor": "synthesis_in_style_tpu", "url": "http://example.com"},
            "images": images,
            "annotations": annotations,
            "categories": self.categories,
            "licenses": [{"id": 0, "name": "synthetic", "url": "http://example.com"}],
        }


def create_coco_gt_from_image_root(image_root: Path, class_to_color_map: Dict) -> Path:
    """`<image_root>/coco_gt.json` of every PNG pair under the root."""
    creator = COCOGtCreator(class_to_color_map, image_root=image_root)
    coco_gt = creator.create_coco_gt_from_image_paths(iter_through_images_in(image_root))
    out = Path(image_root) / "coco_gt.json"
    with out.open("w") as f:
        json.dump(coco_gt, f)
    return out
