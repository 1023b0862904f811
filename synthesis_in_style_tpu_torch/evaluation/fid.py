"""FID, the Frechet distance between feature statistics of real and generated
images (counterpart of synthesis_in_style_tpu/evaluation/fid.py).

The embedding is pluggable: `feature_fn(images) -> (B, D)` on NHWC images in
[-1, 1]. With no feature_fn, FID takes the calibrated InceptionV3 when
`$SIS_METRIC_WEIGHTS/inception_v3.npz` exists on this machine (the JAX
package's converted pytorch_fid weights), and otherwise the fallback: pooled
relu5_3 features of a random-init VGG16. The fallback gives a RELATIVE FID,
consistent within a run (the trend the divergence alarm watches) and not
comparable with published FID.

Real statistics are cached as `fid_stats_<hash>.npz` beside the dataset's
json, keyed on the dataset path, the embedding's name and the sample count.
The port's random VGG16 is drawn from a torch generator, so it is another
embedding than the JAX package's random VGG16 (its name "default"): the port
names it "torch_vgg16_random", and the two packages never read each other's
statistics for it. The calibrated InceptionV3 is the same embedding in both
packages and shares the name "inception_v3".

`GenerativeFID` samples z from a CPU torch.Generator seeded 42 at every
evaluation (the same z each time, on the card and on the CPU) and runs g_ema
with its stored noise.
"""

from __future__ import annotations

import hashlib
import os
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch

FALLBACK_FEATURE_NAME = "torch_vgg16_random"
INCEPTION_FEATURE_NAME = "inception_v3"


@dataclass
class FIDStatistics:
    mu: np.ndarray
    sigma: np.ndarray


def get_statistics(activations: np.ndarray) -> FIDStatistics:
    """Mean and covariance (rows are samples) of a feature matrix."""
    return FIDStatistics(mu=np.mean(activations, axis=0),
                         sigma=np.cov(activations, rowvar=False))


def calculate_frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                               sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)); an eps on the diagonals
    when the square root is not finite, and its imaginary part dropped."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def inception_feature_fn(state_dict, device: Union[str, torch.device] = "cuda") -> Callable:
    """The reference's FID backbone, InceptionV3 pool3 (2048-d), from a state
    dict of the port's layout (models/inception_v3.py converts both
    pytorch_fid's and the JAX package's)."""
    from synthesis_in_style_tpu_torch.models.inception_v3 import (
        InceptionV3Features,
        make_inception_feature_fn,
    )

    model = InceptionV3Features()
    model.load_state_dict(state_dict)
    return make_inception_feature_fn(model.to(device))


def calibrated_feature_fn_from_env(device: Union[str, torch.device] = "cuda"
                                   ) -> Optional[Callable]:
    """InceptionV3 feature fn from `$SIS_METRIC_WEIGHTS/inception_v3.npz`, or
    None when the variable is unset or the file is not there."""
    root = os.environ.get("SIS_METRIC_WEIGHTS")
    if not root:
        return None
    path = Path(root) / "inception_v3.npz"
    if not path.exists():
        return None
    from synthesis_in_style_tpu_torch.models.inception_v3 import load_inception_npz

    return inception_feature_fn(load_inception_npz(path), device)


def default_feature_fn(state_dict=None, device: Union[str, torch.device] = "cuda",
                       seed: int = 0) -> Callable:
    """Pooled VGG16 relu5_3 features, the fallback embedding.

    Without `state_dict` this is a RANDOM-INIT embedding (drawn from
    `seed`): its distances are consistent within a run and usable as a
    relative training signal, but they are NOT FID; a warning says so."""
    from synthesis_in_style_tpu_torch.losses.feature_extractors import (
        VGG16Features,
        init_extractor,
    )

    vgg = VGG16Features()
    if state_dict is None:
        warnings.warn(
            "FID fallback embedding is a RANDOM-INIT VGG16: the reported numbers are "
            "relative distances, NOT calibrated FID. Convert the pytorch_fid InceptionV3 "
            "weights once with the JAX package's scripts/fetch_metric_weights.py and set "
            "SIS_METRIC_WEIGHTS, or pass a feature_fn explicitly.",
            stacklevel=2,
        )
        init_extractor(vgg, seed)
    else:
        vgg.load_state_dict(state_dict)
    vgg = vgg.to(device).eval()

    @torch.no_grad()
    def feature_fn(images: torch.Tensor) -> torch.Tensor:
        return vgg(images)[-1].mean(dim=(2, 3))  # deepest tap, (B, C)

    return feature_fn


def cycle(loader) -> Iterator:
    """An endless stream over a loader's passes."""
    while True:
        yield from loader


class FID:
    """Reconstruction FID for autoencoders; the base of GenerativeFID."""

    def __init__(self, feature_fn: Optional[Callable] = None, num_samples: int = 1000,
                 batch_image_key: str = "output_image", feature_name: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        """`feature_name` labels the embedding in the real-statistics cache
        key; pass one with a custom feature_fn so that statistics of another
        embedding are never read back."""
        self.device = torch.device(device)
        if feature_fn is None:
            calibrated = calibrated_feature_fn_from_env(self.device)
            self.feature_fn = calibrated or default_feature_fn(device=self.device)
            self.feature_name = feature_name or (
                INCEPTION_FEATURE_NAME if calibrated else FALLBACK_FEATURE_NAME)
        else:
            self.feature_fn = feature_fn
            self.feature_name = feature_name or "custom"
        self.num_samples = num_samples
        self.batch_image_key = batch_image_key

    @staticmethod
    def load_precalculated_mu_and_sigma(path: Path) -> FIDStatistics:
        with np.load(str(path)) as data:
            return FIDStatistics(data["mu"][:], data["sigma"][:])

    def _collect(self, batches: Iterable[torch.Tensor]) -> np.ndarray:
        collected, total = [], 0
        for batch in batches:
            feats = self.feature_fn(torch.as_tensor(batch).to(self.device, torch.float32))
            collected.append(feats.float().cpu().numpy())
            total += len(collected[-1])
            if total >= self.num_samples:
                break
        return np.concatenate(collected, axis=0)[: self.num_samples]

    def cache_path(self, dataset_path: Union[str, Path]) -> Path:
        key = f"{dataset_path}|{self.feature_name}|{self.num_samples}"
        digest = hashlib.sha256(key.encode()).hexdigest()[:16]
        return Path(dataset_path).parent / f"fid_stats_{digest}.npz"

    def calculate_statistics_for_real_images(self, cache_path: Optional[Path],
                                             data_loader) -> FIDStatistics:
        """Real statistics, read from / written to `cache_path` when given."""
        if cache_path is not None and Path(cache_path).exists():
            return self.load_precalculated_mu_and_sigma(Path(cache_path))
        stats = get_statistics(self._collect(
            batch[self.batch_image_key] for batch in cycle(data_loader)))
        if cache_path is not None:
            Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
            np.savez(str(cache_path), mu=stats.mu, sigma=stats.sigma)
        return stats

    def fake_batches(self, model_fn: Callable, data_loader) -> Iterator[torch.Tensor]:
        """Reconstruction: the model applied to each batch's input image."""
        for batch in cycle(data_loader):
            yield model_fn(torch.as_tensor(batch["input_image"]).to(self.device))

    def __call__(self, model_fn: Callable, data_loader,
                 dataset_path: Union[str, Path, None] = None) -> float:
        cache = self.cache_path(dataset_path) if dataset_path is not None else None
        real = self.calculate_statistics_for_real_images(cache, data_loader)
        fake = get_statistics(self._collect(self.fake_batches(model_fn, data_loader)))
        return calculate_frechet_distance(real.mu, real.sigma, fake.mu, fake.sigma)


class GenerativeFID(FID):
    """FID of a generator's samples: z ~ N(0, 1) from a CPU torch.Generator
    seeded `seed` at every call, moved to the device, through model_fn."""

    def __init__(self, *args, latent_size: int = 512, batch_size: int = 16, seed: int = 42,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.latent_size = latent_size
        self.batch_size = batch_size
        self.seed = seed

    def fake_batches(self, model_fn: Callable, data_loader) -> Iterator[torch.Tensor]:
        gen = torch.Generator().manual_seed(self.seed)
        while True:
            z = torch.randn((self.batch_size, self.latent_size), generator=gen)
            yield model_fn(z.to(self.device))


def make_fid_extension(state_fn: Callable, config: dict,
                       device: Union[str, torch.device] = "cuda",
                       feature_fn: Optional[Callable] = None):
    """The FID trainer extension of GAN training: g_ema (stored noise)
    against the images of `config["val_images"]`, `fid_samples` of each
    (default 1000), every `fid_eval_iter` iterations (else every epoch) and at
    the end; reports `evaluation/fid_score` and `evaluation/fid_seconds`."""
    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset
    from synthesis_in_style_tpu_torch.core.extensions import Evaluator
    from synthesis_in_style_tpu_torch.data.loader import make_loader

    device = torch.device(device)
    val_json = Path(config["val_images"])
    dataset = GANImageDataset(val_json, root=val_json.parent, image_size=config["image_size"],
                              num_channels=config.get("input_dim", 3))
    # every image counts, also where the set is smaller than one batch
    loader = make_loader(dataset, int(config["batch_size"]), shuffle=True, drop_last=False,
                         num_workers=2, seed=int(config.get("seed", 0)))
    fid = GenerativeFID(feature_fn, latent_size=int(config["latent_size"]),
                        batch_size=int(config["batch_size"]),
                        num_samples=int(config.get("fid_samples", 1000)),
                        batch_image_key="images", device=device)

    def eval_fn(trainer):
        start = time.perf_counter()
        g_ema = state_fn(trainer).g_ema

        @torch.no_grad()
        def sample(z: torch.Tensor) -> torch.Tensor:
            images, _ = g_ema([z], randomize_noise=False)
            return images

        score = fid(sample, loader, dataset_path=val_json)
        return {"fid_score": score, "fid_seconds": time.perf_counter() - start}

    trigger = ((int(config["fid_eval_iter"]), "iteration") if config.get("fid_eval_iter")
               else (1, "epoch"))
    return Evaluator(eval_fn, trigger=trigger, prefix="evaluation")
