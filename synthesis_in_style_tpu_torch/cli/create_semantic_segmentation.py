"""Cluster discovery: fit per-layer spherical k-means over generator
activations and render cluster visualizations for human labelling
(counterpart of synthesis_in_style_tpu/cli/create_semantic_segmentation.py).

Same flags and artifact layout under `<checkpoint>/../../<destination>`:
`catalogs/<k>.npz` (+ `.annotations.json`), `cluster_labels/<k>.npz`
(int32 (N, H, W) per layer), `cluster_arrays/<k>.npz` (uint8 NCHW colour
renders per layer) and `cluster_images/<k>.png` (a grid: one row per layer
and one for the generated images, one column per sample), which the
labeller and the dataset CLI read.

The activations of all samples are gathered on the host, then every layer
moves to `--device` (default cuda) once for the whole k range (about 12.3 GB
of float32 for the 256px generator at `-n 100`). Each k is fitted on every
layer and its files are written before the next k starts, as in the JAX CLI.

Not ported yet: `-i/--images` (real images through an autoencoder's
encoder) raises NotImplementedError (ROADMAP.md, Queue 1 item 8).

Usage:
  python -m synthesis_in_style_tpu_torch.cli.create_semantic_segmentation \\
      <checkpoint> -n 100 -b 10 -c 3 24
"""

from __future__ import annotations

import argparse
import time
from itertools import cycle
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image, ImageColor

from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.models.factory import load_generator
from synthesis_in_style_tpu_torch.segmentation.factor_catalog import FactorCatalog, save_catalogs
from synthesis_in_style_tpu_torch.segmentation.kmeans import mean_spherical_inertia
from synthesis_in_style_tpu_torch.utils.dataset_creation import (
    build_latent_and_noise_generator,
    make_generate_fn,
    make_image,
)

# Kelly-inspired distinct colour list (the JAX CLI's COLOR_MAP)
COLOR_MAP = [
    "#00B3FF", "#753E80", "#0068FF", "#D7BDA6", "#2000C1", "#62A2CE",
    "#667081", "#347D00", "#8E76F6", "#8A5300", "#5C7AFF", "#7A3753",
    "#008EFF", "#5128B3", "#00C8F4", "#0D187F", "#00AA93", "#153359",
    "#133AF1", "#162C23",
]


def get_next_color() -> Iterable[Tuple[int, int, int]]:
    return cycle(ImageColor.getrgb(c) for c in COLOR_MAP)


def prepare_output_dir(args: argparse.Namespace) -> Path:
    output_dir = Path(args.checkpoint).parent.parent / args.destination
    output_dir.mkdir(exist_ok=True, parents=True)
    return output_dir


def get_activations(
    args: argparse.Namespace, generate: Callable, latent_stream
) -> Tuple[Dict[int, torch.Tensor], np.ndarray]:
    """ceil(num_samples / batch_size) batches through the generator; the
    activations {layer: (N, H, W, C)} gathered in host tensors, and the
    uint8 images (N, H, W, 3)."""
    num_batches = -(-args.num_samples // args.batch_size)
    host: Dict[int, torch.Tensor] = {}
    images = []
    start = 0
    for _ in range(num_batches):
        activations, generated = generate(next(latent_stream))
        b = generated.shape[0]
        for key, act in activations.items():
            if key not in host:
                host[key] = torch.empty((num_batches * b,) + tuple(act.shape[1:]),
                                        dtype=act.dtype)
            host[key][start:start + b].copy_(act)
        images.append(make_image(generated))
        start += b
    return {k: v[:start] for k, v in host.items()}, np.concatenate(images, axis=0)


def strip_activations(activations: Dict[int, torch.Tensor], min_size: int
                      ) -> Dict[int, torch.Tensor]:
    """Drop the layers at or below min_size resolution (NHWC)."""
    return {k: v for k, v in activations.items()
            if v.shape[1] > min_size and v.shape[2] > min_size}


def cluster_ids_to_color_image(labels: np.ndarray, num_clusters: int, colors) -> np.ndarray:
    """(B, H, W) int labels -> (B, H, W, 3) uint8 colour render."""
    lut = np.zeros((num_clusters, 3), np.uint8)
    for cluster_id, color in zip(range(num_clusters), colors):
        lut[cluster_id] = color
    return lut[labels]


def find_and_render_clusters(
    all_activations: Dict[int, torch.Tensor], num_clusters: int,
    report: Optional[List[dict]] = None,
) -> Tuple[Dict[int, np.ndarray], Dict[str, FactorCatalog], Dict[str, np.ndarray]]:
    """Fit one FactorCatalog per layer on the activations' device; return
    the colour renders, the catalogs and the int32 per-pixel labels per
    layer. Only with `report`, append each fit's seconds, steps and mean
    spherical inertia per point (one more pass over the layer)."""
    rendered = {}
    catalogs: Dict[str, FactorCatalog] = {}
    label_arrays: Dict[str, np.ndarray] = {}
    for size_key, activations in all_activations.items():
        catalog = FactorCatalog(num_clusters)
        t0 = time.perf_counter()
        labels = catalog.fit_predict(activations).to(torch.int32).cpu().numpy()
        fit_s = time.perf_counter() - t0
        if report is not None:
            report.append({
                "layer": str(size_key), "k": num_clusters, "fit_s": fit_s,
                "n_steps": catalog.n_steps, "steps_per_s": catalog.n_steps / fit_s,
                "inertia": mean_spherical_inertia(
                    activations.reshape(-1, activations.shape[-1]), catalog.cluster_centers),
            })
        rendered[size_key] = cluster_ids_to_color_image(labels, num_clusters, get_next_color())
        catalogs[str(size_key)] = catalog
        label_arrays[str(size_key)] = labels
    return rendered, catalogs, label_arrays


def save_cluster_visualizations(
    cluster_images: Dict[int, np.ndarray],
    generated_images: np.ndarray,
    num_clusters: int,
    dest_dir: Path,
) -> None:
    """cluster_arrays/<k>.npz (uint8 NCHW) and a cluster_images/<k>.png
    grid (rows = layers, then the generated images; columns = samples)."""
    array_path = (dest_dir / "cluster_arrays" / f"{num_clusters}.npz").resolve()
    array_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        str(array_path),
        **{str(k): v.transpose(0, 3, 1, 2) for k, v in cluster_images.items()},
    )

    all_images = dict(cluster_images)
    all_images[max(cluster_images.keys()) + 1] = generated_images
    largest = max(img.shape[1] for img in all_images.values())
    rows = []
    for batch in all_images.values():
        if batch.shape[1] != largest:
            batch = np.stack([
                np.asarray(Image.fromarray(img).resize((largest, largest), Image.NEAREST))
                for img in batch
            ])
        rows.append(np.concatenate(list(batch), axis=1))
    grid = np.concatenate(rows, axis=0)

    image_path = (dest_dir / "cluster_images" / f"{num_clusters}.png").resolve()
    image_path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(grid).save(image_path)


def main(args: argparse.Namespace, report: Optional[List[dict]] = None) -> dict:
    """Run discovery; returns its generation, move-to-device, fit and write
    seconds and the activations' bytes. With `report`, each fit's own
    numbers are appended to it (`find_and_render_clusters`)."""
    if getattr(args, "images", None) is not None:
        raise NotImplementedError(
            "--images (real images through an autoencoder's encoder) is not ported to "
            "synthesis_in_style_tpu_torch yet: it needs the autoencoder (ROADMAP.md, "
            "Queue 1 item 8)")
    device = torch.device(args.device)
    output_dir = prepare_output_dir(args).resolve()
    config = load_config_from_checkpoint(args.checkpoint, args.original_config_path)
    config["batch_size"] = args.batch_size
    gen = load_generator(args.checkpoint, config, device=device)
    generate = make_generate_fn(gen)
    latent_stream = build_latent_and_noise_generator(config, device=device)

    t0 = time.perf_counter()
    activations, generated_images = get_activations(args, generate, latent_stream)
    generation_s = time.perf_counter() - t0
    del gen
    if args.strip_activations_from is not None:
        activations = strip_activations(activations, args.strip_activations_from)
    activation_bytes = sum(a.numel() * a.element_size() for a in activations.values())
    t0 = time.perf_counter()
    for layer in list(activations):  # once for the whole k range; frees the host copy
        activations[layer] = activations[layer].to(device)
    to_device_s = time.perf_counter() - t0

    fit_s = write_s = 0.0
    for num_clusters in range(*args.cluster_range):
        print(f"clustering k={num_clusters}", flush=True)
        t0 = time.perf_counter()
        rendered, catalogs, label_arrays = find_and_render_clusters(
            activations, num_clusters, report)
        t1 = time.perf_counter()
        save_catalogs(catalogs, output_dir / "catalogs" / f"{num_clusters}.npz")
        labels_path = output_dir / "cluster_labels" / f"{num_clusters}.npz"
        labels_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(str(labels_path), **label_arrays)
        save_cluster_visualizations(rendered, generated_images, num_clusters, output_dir)
        fit_s += t1 - t0
        write_s += time.perf_counter() - t1
    return {"generation_s": generation_s, "to_device_s": to_device_s, "fit_s": fit_s,
            "write_s": write_s, "activation_bytes": activation_bytes,
            "num_samples": int(generated_images.shape[0])}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Use a trained generator to produce images and cluster "
        "catalogs of its intermediate activations for human labelling."
    )
    parser.add_argument("checkpoint", help="Path to trained generator checkpoint (.pt or .npz)")
    parser.add_argument("-op", "--original-config-path", type=Path, default=None)
    parser.add_argument("--destination", default="semantic_segmentation")
    parser.add_argument("-b", "--batch-size", default=10, type=int)
    parser.add_argument("-n", "--num-samples", default=100, type=int)
    parser.add_argument("-c", "--cluster-range", nargs=2, default=[3, 24], type=int)
    parser.add_argument("-i", "--images", default=None,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("-s", "--strip-activations-from", type=int, default=None)
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to synthesize and fit on (default cuda)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
