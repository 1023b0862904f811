"""JSON-manifest image dataset (counterpart of
synthesis_in_style_tpu/data/json_dataset.py).

A manifest is a JSON list of image paths, or of dicts with a 'file_name'
key, relative to `root`. Images decode with PIL."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tiff", ".webp"}


def is_image(path: Union[str, Path]) -> bool:
    return Path(path).suffix.lower() in IMAGE_EXTENSIONS


def default_loader(path: Union[str, Path]) -> np.ndarray:
    """Image file -> (H, W, 3) uint8."""
    from PIL import Image

    with Image.open(path) as image:
        return np.asarray(image.convert("RGB"))


def resilient_loader(path: Union[str, Path]) -> np.ndarray:
    """default_loader, but a file that fails to load becomes a black 256x256
    image (the reference's behaviour for corrupt scans)."""
    try:
        return default_loader(path)
    except Exception as e:  # noqa: BLE001 - any decode failure, as the reference
        print(f"Could not load {path} with exception: {e}")
        return np.zeros((256, 256, 3), np.uint8)


class JSONDataset:
    """Index-addressable image dataset over a JSON manifest."""

    def __init__(self, json_path: Union[str, Path], root: Optional[Union[str, Path]] = None,
                 loader: Callable = resilient_loader):
        self.json_path = Path(json_path)
        self.root = str(root) if root is not None else None
        self.loader = loader
        with self.json_path.open() as f:
            entries = json.load(f)
        paths: List[str] = []
        for entry in entries:
            path = entry["file_name"] if isinstance(entry, dict) else entry
            if is_image(path):
                paths.append(path)
        self.image_data = paths

    def full_path(self, index: int) -> str:
        path = self.image_data[index]
        return os.path.join(self.root, path) if self.root is not None else path

    def __len__(self) -> int:
        return len(self.image_data)

    def __getitem__(self, index: int):
        return self.loader(self.full_path(index))


def normalize_to_tensor(image: np.ndarray, image_size: Optional[int] = None,
                        num_channels: int = 3) -> torch.Tensor:
    """(H, W, C) uint8 -> (image_size, image_size, num_channels) float32 in
    [-1, 1]: bilinear resize (antialiased when shrinking, rounded to uint8,
    as PIL's BILINEAR resize), then (x / 255 - 0.5) / 0.5."""
    x = torch.from_numpy(np.array(image, dtype=np.uint8))
    if x.ndim == 2:
        x = x[:, :, None]
    if image_size is not None and tuple(x.shape[:2]) != (image_size, image_size):
        x = F.interpolate(x.permute(2, 0, 1)[None].float(), size=(image_size, image_size),
                          mode="bilinear", align_corners=False, antialias=True)
        x = x[0].permute(1, 2, 0).round().clamp(0, 255)
    x = x[:, :, :num_channels].float() / 255.0
    return (x - 0.5) / 0.5
