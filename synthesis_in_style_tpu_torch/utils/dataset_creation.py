"""Synthesis helpers of the dataset-creation CLI (counterpart of
synthesis_in_style_tpu/utils/dataset_creation.py).

* `build_latent_and_noise_generator`: an endless stream of z batches from a
  seeded torch.Generator (the JAX package splits a jax.random key; the two
  streams differ).
* `make_generate_fn`: z -> (activations, uint8 images on the device),
  truncation 0.7 when a mean latent is given, fixed noise buffers.
* `save_generated_images`: side-by-side [image|label] PNGs in the sharded
  layout, a batch encoded and written over a thread pool
  (`utils/png.write_png_batch`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.utils.png import write_png_batch


def get_root_dir_of_checkpoint(checkpoint_file: Union[str, Path]) -> Path:
    return Path(checkpoint_file).parent.parent


def get_base_dirs(args) -> Tuple[Path, Path]:
    """(image_save_base_dir, semantic_segmentation_base_dir), relative to the
    checkpoint unless given."""
    if getattr(args, "semantic_segmentation_base_dir", None) is None:
        base_dir = get_root_dir_of_checkpoint(args.checkpoint)
        semantic_segmentation_base_dir = base_dir / "semantic_segmentation"
    else:
        semantic_segmentation_base_dir = Path(args.semantic_segmentation_base_dir)
        base_dir = semantic_segmentation_base_dir.parent
    if getattr(args, "save_to", None) is None:
        image_save_base_dir = base_dir / "generated_images"
    else:
        image_save_base_dir = Path(args.save_to)
    image_save_base_dir.mkdir(parents=True, exist_ok=True)
    return image_save_base_dir, semantic_segmentation_base_dir


def build_latent_and_noise_generator(
    config: Dict[str, Any], seed: int = 1, device: Union[str, torch.device] = "cuda"
) -> Iterator[torch.Tensor]:
    """Endless stream of (batch_size, latent_size) z batches on `device`,
    drawn on the CPU from a torch.Generator seeded with `seed` (so the
    stream is the same on every device)."""
    g = torch.Generator().manual_seed(seed)
    batch_size = config["batch_size"]
    latent_size = config.get("latent_size", 512)
    while True:
        yield torch.randn((batch_size, latent_size), generator=g).to(device)


def make_generate_fn(
    gen, truncation_latent: Optional[torch.Tensor] = None, gray_fetch: bool = False
) -> Callable[[torch.Tensor], Tuple[Dict[int, torch.Tensor], torch.Tensor]]:
    """z -> (activations {0..num_layers: (B, H, W, C)}, uint8 images (B, H, W,
    3), or (B, H, W) with `gray_fetch`), both on the generator's device."""
    truncation = 0.7 if truncation_latent is not None else 1.0

    @torch.no_grad()
    def generate(z: torch.Tensor):
        image, activations = gen(
            [z],
            truncation=truncation,
            truncation_latent=truncation_latent,
            randomize_noise=False,
            return_intermediate_activations=True,
        )
        image = image.float()
        if gray_fetch:
            image = image.mean(dim=-1)
        image = torch.clamp(torch.round((image + 1.0) * 127.5), 0, 255).to(torch.uint8)
        return activations, image

    return generate


def compute_mean_latent(gen, n: int = 4096, seed: int = 0) -> torch.Tensor:
    return gen.mean_latent(n, torch.Generator().manual_seed(seed))


def make_image(tensor) -> np.ndarray:
    """[-1, 1] float (B, H, W, C) -> uint8 numpy; uint8 passes through."""
    if torch.is_tensor(tensor):
        tensor = tensor.detach().cpu().numpy()
    arr = np.asarray(tensor)
    if arr.dtype == np.uint8:
        return arr
    arr = (arr.astype(np.float32) + 1.0) * 127.5
    return np.clip(np.rint(arr), 0, 255).astype(np.uint8)


def sharded_image_path(image_id: int, base_dir: Path, file_name: str) -> Path:
    """<base>/<id // 100000>/<id // 1000>/<file_name>; creates the parents."""
    dest = Path(base_dir) / str(image_id // 100000) / str(image_id // 1000) / file_name
    dest.parent.mkdir(exist_ok=True, parents=True)
    return dest


def save_generated_images(
    generated_images: np.ndarray,
    semantic_segmentation_images: np.ndarray,
    batch_id: int,
    base_dir: Path,
    num_images: int,
) -> None:
    """Side-by-side [image|label] PNGs named by zero-padded image id, the
    batch written by one thread per CPU core."""
    images = np.concatenate([generated_images, semantic_segmentation_images], axis=2)
    digits = max(4, len(str(num_images)))
    paths = [sharded_image_path(batch_id + idx, base_dir, f"{batch_id + idx:0{digits}d}.png")
             for idx in range(len(images))]
    write_png_batch(images, paths)
