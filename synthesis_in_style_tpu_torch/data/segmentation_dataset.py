"""Side-by-side [image|mask] segmentation datasets (counterpart of
synthesis_in_style_tpu/data/segmentation_dataset.py).

Each sample is one PNG with the input image on its left half and the
colour-coded mask on its right half. A sample is {"images": (H, W, C)
float32 in [-1, 1], "segmented": (H, W) int64 class ids}.
`AugmentedSegmentationDataset` is num_augmentations times as long: index <
len(original) gives the original pair, later indices an augmented copy
drawn from `numpy.random.default_rng((seed, index))`, the JAX package's
per-index stream (utils/augmentation.py, without OpenCV).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from synthesis_in_style_tpu_torch.data.json_dataset import (
    JSONDataset,
    normalize_to_tensor,
    resilient_loader,
)
from synthesis_in_style_tpu_torch.utils.augmentation import PairedAugmenter
from synthesis_in_style_tpu_torch.utils.segmentation_utils import (
    segmentation_image_to_class_image,
)


class SegmentationDataset(JSONDataset):
    def __init__(self, json_path: Union[str, Path],
                 class_to_color_map_path: Union[str, Path],
                 root: Optional[Union[str, Path]] = None, image_size: Optional[int] = None,
                 background_class_name: str = "background", loader=resilient_loader,
                 num_input_channels: int = 3):
        super().__init__(json_path, root=root, loader=loader)
        self.background_class_name = background_class_name
        self.image_size = image_size
        self.num_input_channels = num_input_channels
        with Path(class_to_color_map_path).open() as f:
            self.class_to_color_map = json.load(f)
        assert self.background_class_name in self.class_to_color_map, (
            f"Background class name: {self.background_class_name} not found "
            f"in class to color map"
        )

    @property
    def num_classes(self) -> int:
        return len(self.class_to_color_map)

    @staticmethod
    def split_image(image: np.ndarray):
        half = image.shape[1] // 2
        return image[:, :half], image[:, half:]

    def to_sample(self, input_image: np.ndarray, mask_image: np.ndarray) -> Dict[str, torch.Tensor]:
        images = normalize_to_tensor(input_image, self.image_size, self.num_input_channels)
        class_image = torch.from_numpy(segmentation_image_to_class_image(
            np.ascontiguousarray(mask_image[:, :, :3]), self.class_to_color_map,
            self.background_class_name).astype(np.int64))
        size = self.image_size
        if size is not None and tuple(class_image.shape) != (size, size):
            # nearest neighbour at pixel centres, as PIL's NEAREST resize
            class_image = F.interpolate(class_image[None, None].float(), size=(size, size),
                                        mode="nearest-exact")[0, 0].long()
        assert images.shape[:2] == class_image.shape[:2], (
            "Input image and segmentation shape should be the same!"
        )
        return {"images": images, "segmented": class_image}

    def __getitem__(self, index: int) -> Dict[str, torch.Tensor]:
        return self.to_sample(*self.split_image(self.loader(self.full_path(index))))


class AugmentedSegmentationDataset(SegmentationDataset):
    def __init__(self, *args, num_augmentations: int = 1, seed: int = 0, **kwargs):
        assert isinstance(num_augmentations, int), "num_augmentations must be an Integer"
        super().__init__(*args, **kwargs)
        self.num_augmentations = num_augmentations
        self.seed = seed
        self.augmenter = PairedAugmenter()

    def __len__(self) -> int:
        return self.num_augmentations * super().__len__()

    def __getitem__(self, index: int) -> Dict[str, torch.Tensor]:
        original_length = super().__len__()
        input_image, mask_image = self.split_image(
            self.loader(self.full_path(index % original_length)))
        if index // original_length != 0:
            rng = np.random.default_rng((self.seed, index))
            input_image, mask_image = self.augmenter(np.ascontiguousarray(input_image),
                                                     np.ascontiguousarray(mask_image), rng)
        return self.to_sample(input_image, mask_image)
