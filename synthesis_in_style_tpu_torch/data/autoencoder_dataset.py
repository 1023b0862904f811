"""Autoencoder datasets: (augmented input, clean output) pairs (counterpart
of synthesis_in_style_tpu/data/autoencoder_dataset.py): identity, additive
gaussian denoising (the standard deviation drawn per image from
DENOISING_VARIANCES, per channel or shared by the channels at random), and
black-and-white denoising (both sides grayscale)."""

from __future__ import annotations

import itertools
import threading
from typing import Dict

import numpy as np
import torch
from PIL import Image

from synthesis_in_style_tpu_torch.data.json_dataset import (
    JSONDataset,
    normalize_to_tensor,
    resilient_loader,
)

DENOISING_VARIANCES = [5, 10, 15, 25, 35, 50]


class AutoencoderDataset(JSONDataset):
    """{"input_image", "output_image"}: (image_size, image_size, C) in
    [-1, 1]; the input is `augment_image` of the output's source image.

    numpy Generators are not thread-safe, so each reader keeps its own
    stream, seeded from (seed, reader id): a loader worker process's id, or
    for threads of one process a first-use counter."""

    def __init__(self, *args, image_size: int, num_channels: int = 3, seed: int = 666,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.image_size = image_size
        self.num_channels = num_channels
        self._seed = seed
        self._local = threading.local()
        self._worker_counter = itertools.count()

    @property
    def _rng(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            info = torch.utils.data.get_worker_info()
            worker_id = info.id if info is not None else next(self._worker_counter)
            rng = np.random.default_rng((self._seed, worker_id))
            self._local.rng = rng
        return rng

    def augment_image(self, image: np.ndarray) -> np.ndarray:
        return image

    def __getitem__(self, index: int) -> Dict[str, torch.Tensor]:
        image = self.loader(self.full_path(index))
        augmented = self.augment_image(image)
        return {"input_image": normalize_to_tensor(augmented, self.image_size, self.num_channels),
                "output_image": normalize_to_tensor(image, self.image_size, self.num_channels)}


class DenoisingAutoencoderDataset(AutoencoderDataset):
    """Additive gaussian noise, per channel or shared, clipped to uint8."""

    def augment_image(self, image: np.ndarray) -> np.ndarray:
        arr = np.asarray(image).astype(np.float32)
        scale = float(self._rng.choice(DENOISING_VARIANCES))
        per_channel = bool(self._rng.integers(2))
        if per_channel or arr.ndim == 2:
            noise = self._rng.normal(0, scale, arr.shape)
        else:
            noise = self._rng.normal(0, scale, arr.shape[:2])[..., None]
        return np.clip(arr + noise, 0, 255).astype(np.uint8)


def _gray_rgb(image: np.ndarray) -> np.ndarray:
    return np.asarray(Image.fromarray(np.asarray(image)).convert("L").convert("RGB"))


class BlackAndWhiteDenoisingAutoencoderDataset(DenoisingAutoencoderDataset):
    """Grayscale (PIL's L conversion, back to RGB) on both sides."""

    def __init__(self, *args, loader=resilient_loader, **kwargs):
        super().__init__(*args, loader=lambda path: _gray_rgb(loader(path)), **kwargs)

    def augment_image(self, image: np.ndarray) -> np.ndarray:
        return _gray_rgb(super().augment_image(image))
