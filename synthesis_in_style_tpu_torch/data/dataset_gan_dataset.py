"""DatasetGAN pixel datasets (counterpart of
synthesis_in_style_tpu/data/dataset_gan_dataset.py): (feature vector, label)
samples over a generator's activations, one sample a pixel.

* A manifest of {"image", "label", "activations" | "latent"} entries and a
  `tensors.npz` with per-image activation dicts and / or latent codes, as
  `cli/create_dataset_for_activation_classification` writes them.
* `pixel_activations` is one float32 (N, S, S, F) tensor on the device (F =
  5888 for a 256px StyleGAN2: 1.54 GB an image), filled a few images at a
  time (`IMAGES_AT_A_TIME`): generate or read, upsample, write into the
  preallocated tensor. `pixel_labels` is (N, S, S) int32 on the host.
* `sample_pixel_batches` draws its pixel indices from the JAX package's
  numpy stream (`np.random.default_rng(seed)`, the same calls), so the same
  seed serves the same pixels, then gathers those rows on the device.
* `DatasetGANGenerationDataset.reset_dataset()` regenerates the activations
  from the stored latents with fresh noise (randomize_noise, no
  truncation), from a torch.Generator seeded by the dataset's numpy stream.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.data.json_dataset import resilient_loader
from synthesis_in_style_tpu_torch.segmentation.dataset_gan_segmenter import (
    IMAGES_AT_A_TIME,
    scale_activations,
)
from synthesis_in_style_tpu_torch.utils.segmentation_utils import (
    segmentation_image_to_class_image,
)

# generator_fn(latents (B, D) on the device, torch.Generator) -> {layer: (B, h, w, C)}
GeneratorFn = Callable[[torch.Tensor, torch.Generator], Dict[int, torch.Tensor]]


class BaseDatasetGANDataset:
    def __init__(
        self,
        json_path: Union[str, Path],
        tensor_path: Union[str, Path],
        class_to_color_map_path: Union[str, Path],
        image_size: int,
        upsample_mode: str = "bilinear",
        class_probabilities: Union[float, List[float]] = 0.5,
        random_sampling: bool = False,
        background_class_name: str = "background",
        loader=resilient_loader,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.json_path = Path(json_path)
        with self.json_path.open() as f:
            self.json_data = json.load(f)
        with Path(class_to_color_map_path).open() as f:
            self.class_to_color_map = json.load(f)
        self.background_class_name = background_class_name
        self.image_size = image_size
        self.upsample_mode = upsample_mode
        self.tensor_path = Path(tensor_path)
        self.dataset_path = self.tensor_path.parent
        self.random_sampling = random_sampling
        self.loader = loader
        self.device = torch.device(device)
        # the JAX package's first loader thread's stream (it seeds one a thread)
        self._rng = np.random.default_rng((seed, 0))
        if isinstance(class_probabilities, float):
            self.class_probabilities = [class_probabilities, 1 - class_probabilities]
        else:
            self.class_probabilities = list(class_probabilities)
        self.image_paths: List[Path] = []
        self.pixel_activations: Optional[torch.Tensor] = None  # (N, S, S, F)
        self.pixel_labels: Optional[np.ndarray] = None  # (N, S, S) int32
        self.feature_vector_length = -1
        self.epoch = 0.0

    def _load_tensor(self, key: str) -> np.ndarray:
        with np.load(self.tensor_path, allow_pickle=True) as tensors:
            return tensors[key]

    def _load_label(self, entry: dict) -> np.ndarray:
        label_image = np.asarray(self.loader(str(self.dataset_path / entry["label"])))
        label = segmentation_image_to_class_image(label_image, self.class_to_color_map,
                                                  self.background_class_name)
        if label.shape != (self.image_size, self.image_size):
            from PIL import Image

            label = np.asarray(Image.fromarray(label.astype(np.uint8)).resize(
                (self.image_size, self.image_size), Image.NEAREST))
        return label.astype(np.int32)

    def _scale_into_store(self, start: int, activations: Dict[int, torch.Tensor]) -> None:
        """Upsample a few images' activations into pixel_activations[start:],
        allocating it (N, S, S, F) at the first call."""
        if self.pixel_activations is None:
            channels = sum(v.shape[-1] for v in activations.values())
            self.pixel_activations = torch.empty(
                (len(self.json_data), self.image_size, self.image_size, channels),
                dtype=torch.float32, device=self.device)
            self.feature_vector_length = channels
        count = next(iter(activations.values())).shape[0]
        scale_activations(activations, self.image_size, self.upsample_mode,
                          out=self.pixel_activations[start:start + count])

    def get_feature_vector_length(self) -> int:
        return self.feature_vector_length

    def _effective_probabilities(self, bucket_sizes: List[int]) -> np.ndarray:
        """Class probabilities renormalized over the non-empty buckets."""
        probs = np.asarray(self.class_probabilities, np.float64)
        probs = np.where(np.asarray(bucket_sizes) > 0, probs, 0.0)
        total = probs.sum()
        assert total > 0, "all sampling buckets are empty"
        return probs / total

    def __len__(self) -> int:
        if self.random_sampling:
            return sum(int((self.pixel_labels == i).sum())
                       for i in range(len(self.class_probabilities)))
        return int(self.pixel_labels.size)

    def sample_pixel_batches(self, batch_size: int, seed: int = 0
                             ) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless {"activations": (B, F), "label": (B,) int64} batches on
        the device, the bucket sampling policy honoured; `self.epoch` counts
        batches served over len(self) // batch_size."""
        rng = np.random.default_rng(seed)
        labels_flat = self.pixel_labels.reshape(-1)
        labels_device = torch.from_numpy(labels_flat.astype(np.int64)).to(self.device)
        n_batches_per_epoch = max(1, len(self) // batch_size)
        buckets = probs = None
        if self.random_sampling:
            buckets = [np.flatnonzero(labels_flat == i)
                       for i in range(len(self.class_probabilities))]
            probs = self._effective_probabilities([len(b) for b in buckets])
        self.epoch = 0.0
        batches = 0
        while True:
            if self.random_sampling:
                indicator = rng.choice(len(probs), size=batch_size, p=probs)
                idx = np.array([buckets[i][rng.integers(len(buckets[i]))] for i in indicator])
            else:
                idx = rng.integers(0, labels_flat.size, batch_size)
            index = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            # read pixel_activations every batch: a reset rewrites it
            acts_flat = self.pixel_activations.view(-1, self.feature_vector_length)
            yield {"activations": acts_flat[index], "label": labels_device[index]}
            batches += 1
            self.epoch = batches / n_batches_per_epoch

    def get_images_for_plot(self, num_desired_images: int = 16):
        """(input images, (S, S, F) pixel activations, (S, S) label maps) of
        the first images, for the plotter."""
        n = min(num_desired_images, len(self.image_paths))
        images = [np.asarray(self.loader(str(self.image_paths[i]))) for i in range(n)]
        activations = [self.pixel_activations[i] for i in range(n)]
        labels = [self.pixel_labels[i] for i in range(n)]
        return images, activations, labels


class DatasetGANDataset(BaseDatasetGANDataset):
    """Activations precomputed by the activation CLI (`tensors.npz`'s
    `activations`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        activations = self._load_tensor("activations")
        labels = []
        for i, entry in enumerate(self.json_data):
            self.image_paths.append(self.dataset_path / entry["image"])
            labels.append(self._load_label(entry))
            acts = {int(k): torch.from_numpy(np.asarray(v, np.float32)[None]).to(self.device)
                    for k, v in activations[entry["activations"]].items()}
            self._scale_into_store(i, acts)
        self.pixel_labels = np.stack(labels)


class DatasetGANGenerationDataset(BaseDatasetGANDataset):
    """Activations regenerated from the stored latents (`tensors.npz`'s
    `latent_codes`) at construction and at every `reset_dataset()`."""

    def __init__(self, *args, generator_fn: GeneratorFn, **kwargs):
        super().__init__(*args, **kwargs)
        self.generator_fn = generator_fn
        init_vectors = self._load_tensor("latent_codes")
        latents, labels = [], []
        for entry in self.json_data:
            latents.append(np.asarray(init_vectors[entry["latent"]], np.float32))
            self.image_paths.append(self.dataset_path / entry["image"])
            labels.append(self._load_label(entry))
        self.pixel_labels = np.stack(labels)
        self.latents = torch.from_numpy(np.stack(latents)).to(self.device)
        self.reset_dataset()

    def reset_dataset(self) -> None:
        seed = int(self._rng.integers(2**31))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        for start in range(0, len(self.latents), IMAGES_AT_A_TIME):
            self._scale_into_store(
                start, self.generator_fn(self.latents[start:start + IMAGES_AT_A_TIME], generator))


def build_dataset_gan_dataset(json_path: Path, config: dict, args,
                              device: Union[str, torch.device] = "cuda") -> BaseDatasetGANDataset:
    """The training CLI's dataset of `dataset: dataset_gan`: regenerated
    from `checkpoint`'s generator with `generate: true`, else read from
    `tensor_path`."""
    common = dict(
        json_path=json_path,
        tensor_path=config["tensor_path"],
        class_to_color_map_path=Path(args.class_to_color_map),
        image_size=config["image_size"],
        upsample_mode=config.get("upsample_mode", "bilinear"),
        class_probabilities=config.get("class_probability", 0.5),
        random_sampling=config.get("random_sampling", False),
        device=device,
    )
    if not config.get("generate"):
        return DatasetGANDataset(**common)
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.models.factory import load_generator

    gen_config = load_config_from_checkpoint(
        config["checkpoint"], getattr(args, "original_generator_config_path", None))
    gen = load_generator(config["checkpoint"], gen_config, device=device)

    @torch.no_grad()
    def generator_fn(latents: torch.Tensor, generator: torch.Generator):
        _, activations = gen([latents], randomize_noise=True,
                             return_intermediate_activations=True, generator=generator)
        return activations

    return DatasetGANGenerationDataset(generator_fn=generator_fn, **common)
