"""Adversarial autoencoder training: binary -> styled image translation
(counterpart of synthesis_in_style_tpu/updaters/adversarial_updater.py).

* D step: softplus logistic loss of the discriminator on the generation
  autoencoder's output for (binary, style) against the real style image;
  the generation autoencoder stays in training mode, so its BatchNorm
  statistics advance here too (twice an iteration, as in the JAX package).
* R1 step every `d_interval` iterations (lazy, weight folded).
* G step: the masked binary reconstruction through the frozen
  reconstruction autoencoder (eval mode), the masked perceptual and style
  losses, and the adversarial loss, weighted by `loss_weights`; the
  gradient goes to every parameter of the generation autoencoder, its
  decoder included.
* mask = 1 - (binary + 1) / 2 of the first channel, without gradient.
* In a launched multi-process run each process steps on its shard: the
  optimizers average the gradients, BatchNorm and the discriminator's
  minibatch stddev span the global batch (parallel/distributed.py), the
  reported metrics are averaged; each process draws its own noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.core.updater import Updater
from synthesis_in_style_tpu_torch.losses.gan import r1_penalty
from synthesis_in_style_tpu_torch.parallel import distributed
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import GANOptimizer

DEFAULT_LOSS_WEIGHTS = {
    "reconstruction": 2.0,
    "discriminator": 1.0,
    "style": 1e-7,
    "perceptual": 0.1,
}


@dataclass
class AdversarialTrainState:
    generator: nn.Module  # ContentAndStyleStyleganAutoencoder (content + style -> image)
    discriminator: nn.Module
    reconstructor: nn.Module  # StyleganAutoencoder, frozen, eval mode
    g_optimizer: GANOptimizer
    d_optimizer: GANOptimizer
    step: int = 0


def create_mask(binary_image: torch.Tensor) -> torch.Tensor:
    """1 - (binary + 1) / 2 of the first channel, (B, H, W, 1), no gradient."""
    return (1.0 - (binary_image[..., 0:1] + 1.0) / 2.0).detach()


def _grads(loss: torch.Tensor, optimizer: GANOptimizer):
    return list(torch.autograd.grad(loss, optimizer.params, allow_unused=True))


def make_adversarial_steps(perceptual_and_style: Callable,
                           loss_weights: Optional[Dict[str, float]] = None,
                           r1_weight: float = 10.0, d_interval: int = 16
                           ) -> Dict[str, Callable]:
    """{"d_step", "d_reg_step", "g_step"}; `perceptual_and_style` is a
    losses.perceptual.PerceptualAndStyleLoss."""
    weights = {**DEFAULT_LOSS_WEIGHTS, **(loss_weights or {})}

    def d_step(state: AdversarialTrainState, binary, style, generator=None):
        with torch.no_grad():
            fake = state.generator.train()(binary, style, generator=generator)
        fake_pred = state.discriminator(fake)
        real_pred = state.discriminator(style)
        loss = F.softplus(fake_pred).mean() + F.softplus(-real_pred).mean()
        state.d_optimizer.step(_grads(loss, state.d_optimizer))
        return {"loss": loss.detach(), "real_score": real_pred.mean().detach(),
                "fake_score": fake_pred.mean().detach()}

    def d_reg_step(state: AdversarialTrainState, style):
        penalty, _ = r1_penalty(state.discriminator, style, r1_weight, d_interval)
        state.d_optimizer.step(_grads(penalty, state.d_optimizer))
        return {"gradient_penalty": penalty.detach()}

    def g_step(state: AdversarialTrainState, binary, style, generator=None):
        mask = create_mask(binary)
        fake = state.generator.train()(binary, style, generator=generator)
        reconstructed_binary = state.reconstructor(fake, generator=generator)
        recon = weights["reconstruction"] * (mask * (reconstructed_binary - binary)).square().mean()
        style_l, perceptual_l = perceptual_and_style(fake, style, mask)
        style_l = weights["style"] * style_l
        perceptual_l = weights["perceptual"] * perceptual_l
        adv = weights["discriminator"] * F.softplus(-state.discriminator(fake)).mean()
        total = recon + adv + perceptual_l + style_l
        state.g_optimizer.step(_grads(total, state.g_optimizer))
        state.step += 1
        return {"loss": total.detach(), "discriminator_loss": adv.detach(),
                "reconstruction_loss": (recon / weights["reconstruction"]).detach(),
                "perceptual_loss": perceptual_l.detach(), "style_loss": style_l.detach()}

    return {"d_step": d_step, "d_reg_step": d_reg_step, "g_step": g_step}


class AdversarialAutoencoderUpdater(Updater):
    """D, then R1 when iteration % d_interval == 0, then G, on the
    `binary_images` and `original_images` streams."""

    def __init__(self, steps: Dict[str, Callable], state: AdversarialTrainState, iterators,
                 d_interval: int = 16, seed: int = 0, device="cuda"):
        super().__init__(iterators, seed=seed, device=device)
        self.steps = steps
        self.state = state
        self.d_interval = d_interval

    def update_core(self):
        binary = self.next_batch("binary_images").to(self.device, non_blocking=True)
        style = self.next_batch("original_images").to(self.device, non_blocking=True)
        d_metrics = self.steps["d_step"](self.state, binary, style, self.rng)
        if self.iteration % self.d_interval == 0:
            d_metrics.update(self.steps["d_reg_step"](self.state, style))
        self.report(distributed.reduce_metrics(d_metrics), prefix="discriminator")
        self.report(distributed.reduce_metrics(
            self.steps["g_step"](self.state, binary, style, self.rng)), prefix="generator")
