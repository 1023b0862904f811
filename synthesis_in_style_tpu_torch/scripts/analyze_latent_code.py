"""Latent and noise statistics of an autoencoder's encoder over a dataset:
histograms, CDFs and inverse-CDF blueprints for sampling new codes
(counterpart of synthesis_in_style_tpu/scripts/analyze_latent_code.py).

The dataset is embedded on `--device` (default cuda) and cached to
`<save-dir>/embedded.npz` (keys `latents`, `num_noise_layers`, `noise_<i>`,
as the JAX script's). Then `<save-dir>/latents/` gets latent_histogram.png,
latent_cdf.png, latent_dim_<d>.png for the first 16 dimensions and
latent_blueprint.json, and `<save-dir>/noise/` a histogram per noise map and
noise_blueprint.json. `--stats` adds the parallel-coordinate plots, the
Spearman correlation heatmaps and the Shapiro-Wilk p-value maps (scipy)
under latents/visualizations and latents/test_results;
`--check-reconstructed-cdf` overlays each histogram with data re-sampled
through the inverse CDF. The plots are drawn with PIL under the JAX
script's file names.

Usage:
  python -m synthesis_in_style_tpu_torch.scripts.analyze_latent_code \\
      <autoencoder_ckpt> --dataset images.json --save-dir <dir> [-b 8] \\
      [--stats] [-d cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from synthesis_in_style_tpu_torch.utils import plots


def empirical_cdf(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    x = np.sort(data.reshape(-1))
    y = np.arange(1, len(x) + 1) / len(x)
    return x, y


def create_and_plot_cdf(data: np.ndarray, file_name: Path) -> None:
    x, y = empirical_cdf(data)
    plots.line_plot(x, y, file_name, y_label="F(x)")


def inverse_cdf_sample(data: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """n values drawn through the empirical quantile function of `data`."""
    flat = np.sort(data.reshape(-1))
    u = rng.random(n)
    return np.interp(u, np.arange(1, len(flat) + 1) / len(flat), flat)


def create_and_save_histogram(data: np.ndarray, file_name: Path, bins: int = 100,
                              check_reconstructed_cdf: bool = False) -> None:
    """With `check_reconstructed_cdf`, a second histogram of data
    re-sampled through the inverse CDF on the same bins."""
    overlay = None
    if check_reconstructed_cdf:
        overlay = inverse_cdf_sample(data, data.size, np.random.default_rng(0))
    plots.histogram(data, file_name, bins=bins, overlay=overlay)


def normalize_data(data: np.ndarray, axis=None, eps: float = 1e-9) -> np.ndarray:
    lo = np.min(data, axis=axis, keepdims=axis is not None)
    hi = np.max(data, axis=axis, keepdims=axis is not None)
    return (data - lo) / (hi - lo + eps)


def parallel_coordinate_plot(data: np.ndarray, path: Path, normalize: bool = False,
                             alpha: float = 0.1) -> None:
    if normalize:
        data = normalize_data(data, axis=0)
    plots.parallel_coordinates(data, path, alpha=alpha)


def save_array_as_image(data: np.ndarray, path: Path) -> None:
    plots.heatmap(np.atleast_2d(data), path)


def latent_stats_suite(latent_codes: np.ndarray, dest_dir: Path, max_samples: int = 1000,
                       max_dims: int = 128, dims_per_plot: int = 16) -> None:
    """Over (N, slices, D) codes: parallel-coordinate plots per window of
    dimensions and per dimension across slices, a Spearman correlation
    heatmap per slice, and Shapiro-Wilk p-value maps."""
    from scipy import stats

    if latent_codes.ndim == 2:
        latent_codes = latent_codes[:, None, :]
    data = latent_codes[:max_samples]
    n, slices, dim = data.shape
    max_dims = min(max_dims, dim)
    plot_dir = dest_dir / "visualizations"
    results_dir = dest_dir / "test_results"
    plot_dir.mkdir(parents=True, exist_ok=True)
    results_dir.mkdir(parents=True, exist_ok=True)

    normalized = normalize_data(data, axis=0)
    for k in range(0, max_dims, dims_per_plot):
        for i in range(slices):
            parallel_coordinate_plot(normalized[:, i, k:k + dims_per_plot],
                                     plot_dir / f"plot_a_{k}-{k + dims_per_plot}_{i}.png")
    if slices > 1:
        for j in range(max_dims):
            parallel_coordinate_plot(normalized[:, :, j], plot_dir / f"plot_b_{j}.png")

    for i in range(slices):
        corr, _ = stats.spearmanr(data[:, i, :])
        save_array_as_image(np.atleast_2d(corr), results_dir / f"correlation_c_{i}.png")

    shapiro_n = min(n, 500)
    results_all = np.zeros((slices, 1))
    results_per_code = np.zeros((slices, dim))
    results_per_sample = np.zeros((slices, shapiro_n))
    for i in range(slices):
        results_all[i, 0] = stats.shapiro(data[:shapiro_n, i, :].ravel()).pvalue
        for j in range(dim):
            results_per_code[i, j] = stats.shapiro(data[:shapiro_n, i, j]).pvalue
        for j in range(shapiro_n):
            results_per_sample[i, j] = stats.shapiro(data[j, i, :]).pvalue
    save_array_as_image(results_all, results_dir / "shapiro_wilk_sliced.png")
    save_array_as_image(results_per_code, results_dir / "shapiro_wilk_per_code.png")
    save_array_as_image(results_per_sample, results_dir / "shapiro_wilk_per_sample.png")


def inverse_cdf_blueprint(data: np.ndarray, num_quantiles: int = 256) -> Dict:
    """A quantile grid for inverse-transform sampling, with mean and std."""
    flat = np.sort(data.reshape(-1))
    qs = np.linspace(0.0, 1.0, num_quantiles)
    values = np.quantile(flat, qs)
    return {"quantiles": qs.tolist(), "values": values.tolist(),
            "mean": float(flat.mean()), "std": float(flat.std())}


def analyze_latents(latent_codes: np.ndarray, dest_dir: Path, max_dims_plotted: int = 16,
                    stats: bool = False, check_reconstructed_cdf: bool = False) -> Dict:
    """Histograms, the CDF and latent_blueprint.json of (N, [slices,] D)
    codes."""
    dest_dir.mkdir(parents=True, exist_ok=True)
    flat = latent_codes.reshape(-1, latent_codes.shape[-1])
    create_and_save_histogram(flat, dest_dir / "latent_histogram.png",
                              check_reconstructed_cdf=check_reconstructed_cdf)
    create_and_plot_cdf(flat, dest_dir / "latent_cdf.png")
    for dim in range(min(max_dims_plotted, flat.shape[-1])):
        create_and_save_histogram(flat[:, dim], dest_dir / f"latent_dim_{dim:03d}.png",
                                  check_reconstructed_cdf=check_reconstructed_cdf)
    if stats:
        latent_stats_suite(latent_codes, dest_dir)
    blueprint = {
        "shape": list(latent_codes.shape[1:]),
        "global": inverse_cdf_blueprint(flat),
        "per_dim_mean": flat.mean(axis=0).tolist(),
        "per_dim_std": flat.std(axis=0).tolist(),
    }
    with (dest_dir / "latent_blueprint.json").open("w") as f:
        json.dump(blueprint, f)
    return blueprint


def analyze_noise(noises: List[np.ndarray], dest_dir: Path) -> Dict:
    """A histogram and a blueprint per (N, H, W, 1) noise map."""
    dest_dir.mkdir(parents=True, exist_ok=True)
    blueprint = {}
    for i, noise in enumerate(noises):
        key = f"noise_{noise.shape[1]}x{noise.shape[2]}_{i}"
        create_and_save_histogram(noise, dest_dir / f"{key}_histogram.png")
        blueprint[key] = {"shape": list(noise.shape[1:]), **inverse_cdf_blueprint(noise)}
    with (dest_dir / "noise_blueprint.json").open("w") as f:
        json.dump(blueprint, f)
    return blueprint


@torch.no_grad()
def embed_images(args, config: dict) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The dataset through the autoencoder's encoder on `args.device`, in
    order, in batches of `args.batch_size`; cached to embedded.npz (read
    back unless `args.force`)."""
    cache = Path(args.save_dir) / "embedded.npz"
    if cache.exists() and not args.force:
        with np.load(cache) as data:
            return data["latents"], [data[f"noise_{i}"]
                                     for i in range(int(data["num_noise_layers"]))]

    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset
    from synthesis_in_style_tpu_torch.data.loader import make_loader, shutdown_workers
    from synthesis_in_style_tpu_torch.models.factory import get_autoencoder, load_autoencoder_state
    from synthesis_in_style_tpu_torch.utils.checkpoint import load_autoencoder_snapshot

    device = torch.device(args.device)
    dataset_json = Path(args.dataset)
    dataset = GANImageDataset(dataset_json, root=dataset_json.parent,
                              image_size=config["image_size"],
                              num_channels=config.get("input_dim", 3))
    loader = make_loader(dataset, args.batch_size, shuffle=False, drop_last=False,
                         num_workers=2, pin_memory=device.type == "cuda")
    ae = get_autoencoder(config)
    snapshot = load_autoencoder_snapshot(args.autoencoder_checkpoint)
    if snapshot is None:
        raise ValueError(f"{args.autoencoder_checkpoint} holds no 'autoencoder'")
    load_autoencoder_state(ae, snapshot["autoencoder"])
    ae.to(device).eval()

    all_latents, all_noises = [], None
    try:
        for batch in loader:
            latents = ae.encode(batch["images"].to(device, non_blocking=True))
            all_latents.append(latents.latent.cpu().numpy())
            noises = [n.cpu().numpy() for n in latents.noise]
            if all_noises is None:
                all_noises = [[n] for n in noises]
            else:
                for acc, n in zip(all_noises, noises):
                    acc.append(n)
    finally:
        shutdown_workers(loader)
    latents = np.concatenate(all_latents, axis=0)
    noises = [np.concatenate(acc, axis=0) for acc in all_noises]
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, latents=latents, num_noise_layers=len(noises),
             **{f"noise_{i}": n for i, n in enumerate(noises)})
    return latents, noises


def main(args: argparse.Namespace) -> dict:
    """Embed and analyze; returns the two blueprints."""
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint

    config = load_config_from_checkpoint(args.autoencoder_checkpoint,
                                         args.original_config_path)
    save_dir = Path(args.save_dir)
    latents, noises = embed_images(args, config)
    latent_blueprint = analyze_latents(latents, save_dir / "latents", stats=args.stats,
                                       check_reconstructed_cdf=args.check_reconstructed_cdf)
    noise_blueprint = analyze_noise(noises, save_dir / "noise")
    print(f"analysis written to {save_dir}")
    return {"latents": latent_blueprint, "noise": noise_blueprint}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Analyze the latent codes an encoder produces over a dataset")
    parser.add_argument("autoencoder_checkpoint")
    parser.add_argument("--dataset", required=True, help="json manifest of images to embed")
    parser.add_argument("--save-dir", default="latent_code_analysis")
    parser.add_argument("-op", "--original-config-path", type=Path, default=None)
    parser.add_argument("-f", "--force", action="store_true", default=False)
    parser.add_argument("-b", "--batch-size", type=int, default=8)
    parser.add_argument("--stats", action="store_true", default=False,
                        help="parallel-coordinate plots, Spearman correlation and "
                        "Shapiro-Wilk normality maps")
    parser.add_argument("--check-reconstructed-cdf", action="store_true", default=False,
                        help="overlay histograms with inverse-CDF re-sampled data")
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to embed on (default cuda)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
