"""Latent projection: GAN inversion by direct optimization of (w+, noise)
(counterpart of synthesis_in_style_tpu/latent_projecting/__init__.py).

* `Projector.project` runs Adam on the latent or on the noise maps of a
  `Latents` through a frozen generator (`randomize_noise=False`); the
  other part stays constant. The learning rate follows `lr_with_ramp`
  (cosine rampdown, linear rampup), evaluated at the 0-based update count
  as optax evaluates a schedule: the first update has the schedule's value
  at step 0, which is 0.
* Loss factories: `w_plus_loss` (LPIPS + per-image-summed MSE),
  `naive_noise_loss`, `w_plus_style_loss` (masked perceptual + masked Gram
  style + masked MSE) and `noise_loss`.
* `run_image_reconstruction` optimizes w+ first, then the noise;
  `run_local_style_transfer` the w+ against content and style, then the
  noise against the content and the first stage's image.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from synthesis_in_style_tpu_torch.models.encoder import CodeLatents, Latents
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import GANOptimizer

__all__ = [
    "Latents",
    "CodeLatents",
    "LatentPaths",
    "Projector",
    "lr_with_ramp",
    "w_plus_loss",
    "naive_noise_loss",
    "w_plus_style_loss",
    "noise_loss",
    "run_image_reconstruction",
    "run_local_style_transfer",
]


class LatentPaths:
    """Snapshots of an optimization's trajectory: Latents of numpy arrays."""

    def __init__(self, items: Optional[List[Latents]] = None):
        self.items = items or []

    def append(self, latents: Latents):
        def host(t):  # a copy: a CPU tensor's numpy view would follow the optimizer
            return None if t is None else t.detach().cpu().numpy().copy()

        self.items.append(Latents(
            latent=host(latents.latent),
            noise=None if latents.noise is None else tuple(host(n) for n in latents.noise)))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __add__(self, other: "LatentPaths") -> "LatentPaths":
        return LatentPaths(self.items + other.items)


def lr_with_ramp(base_lr: float, total_steps: int, rampdown: float = 0.25,
                 rampup: float = 0.05) -> Callable[[int], float]:
    """The StyleGAN2 projector's schedule: base_lr * (0.5 - 0.5 cos(pi *
    min(1, (1 - t) / rampdown))) * min(1, t / rampup), t = step / total,
    in float32."""

    f32 = np.float32

    def schedule(step: int) -> float:
        # in float32, as the JAX package computes it
        t = f32(step) / f32(max(1, total_steps))
        ramp = np.minimum(f32(1.0), (f32(1.0) - t) / f32(max(rampdown, 1e-8)))
        ramp = f32(0.5) - f32(0.5) * np.cos(ramp * f32(math.pi))
        ramp = ramp * np.minimum(f32(1.0), t / f32(max(rampup, 1e-8)))
        return float(f32(base_lr) * ramp)

    return schedule


def _per_image_mse(generated: torch.Tensor, original: torch.Tensor) -> torch.Tensor:
    return (generated - original).square().mean(dim=(1, 2, 3)).sum()


def w_plus_loss(lambdas: Dict[str, float], lpips: Callable) -> Callable:
    """LPIPS + per-image-summed MSE."""

    def loss_impl(generated, original):
        perceptual = lambdas["l_percept"] * lpips(generated, original).sum()
        mse = lambdas["l_mse"] * _per_image_mse(generated, original)
        return perceptual + mse, {"perceptual_loss": perceptual, "mse_loss": mse}

    return loss_impl


def naive_noise_loss(lambdas: Dict[str, float]) -> Callable:
    def loss_impl(generated, original):
        mse = lambdas["l_mse"] * _per_image_mse(generated, original)
        return mse, {"mse_loss": mse}

    return loss_impl


def w_plus_style_loss(lambdas: Dict[str, float], content_image: torch.Tensor,
                      style_image: torch.Tensor, mask_image: torch.Tensor,
                      perceptual_and_style) -> Callable:
    """Masked perceptual (against the content) + masked Gram style (against
    the style, outside the mask) + masked MSE; `perceptual_and_style` is a
    losses.perceptual.PerceptualAndStyleLoss."""

    def loss_impl(generated, original):
        _, perceptual = perceptual_and_style(generated, content_image, mask=mask_image)
        style, _ = perceptual_and_style(generated, style_image, mask=1.0 - mask_image)
        style = lambdas["l_style"] * style
        perceptual = lambdas["l_percept"] * perceptual
        mse = lambdas["l_mse"] * (mask_image * (generated - content_image)).square().mean()
        return mse + style + perceptual, {"mse_loss": mse, "style_loss": style,
                                          "perceptual_loss": perceptual}

    return loss_impl


def noise_loss(lambdas: Dict[str, float], content_image: torch.Tensor,
               style_image: torch.Tensor, mask_image: torch.Tensor) -> Callable:
    def loss_impl(generated, original):
        mse_1 = lambdas["l_mse_1"] * (mask_image * (generated - content_image)).square().mean()
        mse_2 = lambdas["l_mse_2"] * ((1.0 - mask_image) * (generated - style_image)
                                      ).square().mean()
        return mse_1 + mse_2, {"mse_1": mse_1, "mse_2": mse_2}

    return loss_impl


class Projector:
    """Optimizes Latents against target images through a frozen generator
    (its parameters get no gradient)."""

    def __init__(self, gen: nn.Module):
        self.gen = gen.requires_grad_(False)

    def generate(self, latents: Latents) -> torch.Tensor:
        image, _ = self.gen([latents.latent], input_is_latent=latents.latent.ndim == 3,
                            noise=None if latents.noise is None else list(latents.noise),
                            randomize_noise=False)
        return image

    def project(self, latents: Latents, images: torch.Tensor, loss_fn: Callable,
                num_steps: int, lr: float, optimize: str = "latent", rampdown: float = 0.25,
                rampup: float = 0.05, snapshot_every: int = 50,
                abort_condition: Optional[Callable] = None) -> Tuple[LatentPaths, Latents]:
        """Adam on `latents.latent` (optimize="latent") or `latents.noise`
        ("noise"). Returns (snapshots every `snapshot_every` steps and at the
        end, final latents). `abort_condition(loss, i)` sees each step's loss
        (before its update) and stops the stage when it returns True."""
        if optimize == "latent":
            leaves = [latents.latent.detach().clone().requires_grad_(True)]
        else:
            leaves = [n.detach().clone().requires_grad_(True) for n in latents.noise]
        optimizer = GANOptimizer(leaves, lr_with_ramp(lr, num_steps, rampdown, rampup),
                                 (0.9, 0.999), max_norm=math.inf)

        def current() -> Latents:
            if optimize == "latent":
                return latents.replace(latent=leaves[0])
            return latents.replace(noise=tuple(leaves))

        paths = LatentPaths()
        for i in range(num_steps):
            loss, _ = loss_fn(self.generate(current()), images)
            optimizer.step(torch.autograd.grad(loss, leaves))
            if (i + 1) % snapshot_every == 0 or i == num_steps - 1:
                paths.append(current())
            if abort_condition is not None and abort_condition(float(loss.detach()), i):
                break
        result = current()
        detached = Latents(latent=result.latent.detach(),
                           noise=None if result.noise is None
                           else tuple(n.detach() for n in result.noise))
        return paths, detached


def run_image_reconstruction(projector: Projector, latents: Latents, images: torch.Tensor,
                             lpips: Callable, latent_step: int = 1000, noise_step: int = 1000,
                             lr: float = 0.1, noise_lr: float = 5.0, mse: float = 0.0,
                             do_optimize_noise: bool = True, latent_abort_condition=None,
                             noise_abort_condition=None, **ramp_kwargs
                             ) -> Tuple[LatentPaths, Latents]:
    """w+ optimization (LPIPS + mse * MSE), then noise optimization (MSE)."""
    paths, best = projector.project(
        latents, images, w_plus_loss({"l_percept": 1.0, "l_mse": mse}, lpips),
        latent_step, lr, optimize="latent", abort_condition=latent_abort_condition,
        **ramp_kwargs)
    if do_optimize_noise:
        more_paths, best = projector.project(
            best, images, naive_noise_loss({"l_mse": 1.0}), noise_step, noise_lr,
            optimize="noise", abort_condition=noise_abort_condition, **ramp_kwargs)
        paths = paths + more_paths
    return paths, best


def run_local_style_transfer(projector: Projector, latents: Latents,
                             content_image: torch.Tensor, style_image: torch.Tensor,
                             mask_image: torch.Tensor, perceptual_and_style,
                             style_latent_step: int = 1000, style_noise_step: int = 1000,
                             lr: float = 0.1, noise_lr: float = 5.0, **ramp_kwargs
                             ) -> Tuple[LatentPaths, Latents]:
    paths, best = projector.project(
        latents, content_image,
        w_plus_style_loss({"l_percept": 1.0, "l_mse": 1.0, "l_style": 1.0}, content_image,
                          style_image, mask_image, perceptual_and_style),
        style_latent_step, lr, optimize="latent", **ramp_kwargs)
    with torch.no_grad():
        reference_image = projector.generate(best)
    more_paths, best = projector.project(
        best, content_image,
        noise_loss({"l_mse_1": 1.0, "l_mse_2": 1.0}, content_image, reference_image, mask_image),
        style_noise_step, noise_lr, optimize="noise", **ramp_kwargs)
    return paths + more_paths, best
