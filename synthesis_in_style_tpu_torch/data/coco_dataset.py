"""COCO ground truth over [image|label] pair PNGs (counterpart of
synthesis_in_style_tpu/data/coco_dataset.py), e.g. the `coco_gt.json` the
dataset CLI writes (`evaluation/coco_gt.py`). An item is the pair's left
half as an (H, W, C) float32 tensor in [-1, 1], its image id and its
annotations; `collate_func` stacks the tensors and keeps the
variable-length annotation lists as a list."""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Union

import torch
from torch.utils.data import default_collate

from synthesis_in_style_tpu_torch.data.json_dataset import normalize_to_tensor, resilient_loader


class COCODataset:
    def __init__(self, json_path: Union[str, Path], root: Optional[Union[str, Path]] = None,
                 image_size: Optional[int] = None, num_channels: int = 3,
                 loader=resilient_loader):
        self.root = Path(root) if root is not None else None
        self.loader = loader
        self.image_size = image_size
        self.num_channels = num_channels
        with Path(json_path).open() as f:
            data = json.load(f)
        self.images = data["images"]
        self.annotations: Dict[int, List[dict]] = defaultdict(list)
        for annotation in data["annotations"]:
            self.annotations[annotation["image_id"]].append(annotation)
        self.categories = data["categories"]

    def __len__(self) -> int:
        return len(self.images)

    @staticmethod
    def collate_func(batch: List[dict]) -> dict:
        """Stack every entry but the annotations, which stay a list."""
        batch = [dict(d) for d in batch]
        annotations = [d.pop("annotations") for d in batch]
        collated = default_collate(batch)
        collated["annotations"] = annotations
        return collated

    def __getitem__(self, index: int) -> dict:
        image_info = self.images[index]
        path = image_info["file_name"]
        if self.root is not None:
            path = self.root / path
        image = self.loader(path)
        left = image[:, : image.shape[1] // 2]
        return {"images": normalize_to_tensor(left, self.image_size, self.num_channels),
                "annotations": self.annotations[image_info["id"]],
                "image_id": torch.tensor(image_info["id"], dtype=torch.int64)}
