"""Autoencoder training: encoder-only updates against a frozen generator
decoder (counterpart of synthesis_in_style_tpu/updaters/autoencoder_updater.py).

* The loss is the per-image mean squared error summed over the batch, plus
  the summed LPIPS distance when an LPIPS module is given
  (`reconstruction_loss_fn`).
* The decoder is frozen: `create_ae_train_state` gives the optimizer the
  encoders' parameters only (`encoder_parameters()`, the JAX package's
  `masked_encoder_tx`), so a clip inside the optimizer sees the encoders'
  gradients alone, and turns the decoder's gradients off.
* `make_autoencoder_gan_steps` adds a discriminator trained on the
  reconstructions (logistic loss, lazy R1 every `d_interval`); the
  autoencoder stays in training mode in its D step, so its BatchNorm
  statistics advance there too, as in the JAX package.
* Every step takes the torch.Generator that the autoencoder's random draws
  come from (the updater's, re-seeded from (seed, iteration)).

An optimizer here is anything with `params` and `step(grads)`:
`adam_optimizer` builds the optax chain [clip_by_global_norm] ->
[add_decayed_weights] -> adam on `updaters/stylegan2_updater.GANOptimizer`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from synthesis_in_style_tpu_torch.core.updater import Updater
from synthesis_in_style_tpu_torch.losses.gan import (
    d_logistic_loss,
    g_nonsaturating_loss,
    r1_penalty,
)
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import GANOptimizer


def adam_optimizer(lr: float, betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                   max_norm: Optional[float] = None, weight_decay: float = 0.0
                   ) -> Callable[[Sequence[nn.Parameter]], GANOptimizer]:
    """params -> optax.chain([clip_by_global_norm(max_norm)],
    [add_decayed_weights(weight_decay)], adam(lr, *betas, eps))."""
    def make(params: Sequence[nn.Parameter]) -> GANOptimizer:
        return GANOptimizer(params, lambda _: lr, betas, eps=eps,
                            max_norm=math.inf if max_norm is None else max_norm,
                            weight_decay=weight_decay)
    return make


@dataclass
class AETrainState:
    autoencoder: nn.Module
    optimizer: GANOptimizer
    discriminator: Optional[nn.Module] = None
    d_optimizer: Optional[GANOptimizer] = None
    step: int = 0


def create_ae_train_state(autoencoder: nn.Module, make_optimizer: Callable,
                          discriminator: Optional[nn.Module] = None,
                          make_d_optimizer: Optional[Callable] = None) -> AETrainState:
    """Train state over initialised networks: the decoder frozen, the
    optimizer over the encoders' parameters, and with a discriminator its
    optimizer (`make_d_optimizer`, else `make_optimizer`)."""
    autoencoder.decoder.requires_grad_(False)
    state = AETrainState(autoencoder, make_optimizer(autoencoder.encoder_parameters()))
    if discriminator is not None:
        state.discriminator = discriminator
        state.d_optimizer = (make_d_optimizer or make_optimizer)(list(discriminator.parameters()))
    return state


def reconstruction_loss_fn(reconstructed: torch.Tensor, target: torch.Tensor,
                           lpips: Optional[Callable]) -> Dict[str, torch.Tensor]:
    """Per-image mean squared error summed over the batch (+ summed LPIPS)."""
    mse = (reconstructed - target).square().mean(dim=(1, 2, 3)).sum()
    losses = {"reconstruction_loss": mse}
    total = mse
    if lpips is not None:
        p = lpips(reconstructed, target).sum()
        losses["perceptual_loss"] = p
        total = total + p
    losses["autoencoder_loss"] = total
    return losses


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]):
    return list(torch.autograd.grad(loss, list(params), allow_unused=True))


def _detached(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in values.items()}


def make_autoencoder_train_step(lpips: Optional[Callable] = None) -> Callable:
    """(state, batch {"input_image", "output_image"}, generator) -> losses:
    one reconstruction step of the encoders."""
    def train_step(state: AETrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        ae = state.autoencoder.train()
        recon = ae(batch["input_image"], generator=generator)
        losses = reconstruction_loss_fn(recon, batch["output_image"], lpips)
        state.optimizer.step(_grads(losses["autoencoder_loss"], state.optimizer.params))
        state.step += 1
        return _detached(losses)

    return train_step


def make_autoencoder_gan_steps(lpips: Optional[Callable] = None, r1_weight: float = 10.0,
                               d_interval: int = 16) -> Dict[str, Callable]:
    """{"d_step", "d_reg_step", "g_step"} of reconstruction with a
    discriminator on the reconstructions."""

    def d_step(state: AETrainState, batch, generator=None) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            recon = state.autoencoder.train()(batch["input_image"], generator=generator)
        disc = state.discriminator
        fake_pred = disc(recon)
        real_pred = disc(batch["output_image"])
        loss = d_logistic_loss(real_pred, fake_pred)
        state.d_optimizer.step(_grads(loss, state.d_optimizer.params))
        return {"loss": loss.detach(), "real_score": real_pred.mean().detach(),
                "fake_score": fake_pred.mean().detach()}

    def d_reg_step(state: AETrainState, batch) -> Dict[str, torch.Tensor]:
        penalty, _ = r1_penalty(state.discriminator, batch["output_image"], r1_weight,
                                d_interval)
        state.d_optimizer.step(_grads(penalty, state.d_optimizer.params))
        return {"gradient_penalty": penalty.detach()}

    def g_step(state: AETrainState, batch, generator=None) -> Dict[str, torch.Tensor]:
        recon = state.autoencoder.train()(batch["input_image"], generator=generator)
        losses = reconstruction_loss_fn(recon, batch["output_image"], lpips)
        adv = g_nonsaturating_loss(state.discriminator(recon))
        losses["discriminator_loss"] = adv
        losses["loss"] = losses["autoencoder_loss"] + adv
        state.optimizer.step(_grads(losses["loss"], state.optimizer.params))
        state.step += 1
        return _detached(losses)

    return {"d_step": d_step, "d_reg_step": d_reg_step, "g_step": g_step}


def _to_device(batch: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


class AutoencoderUpdater(Updater):
    """One reconstruction step per iteration on the `images` stream's
    {"input_image", "output_image"} batches."""

    def __init__(self, train_step: Callable, state: AETrainState, iterators, seed: int = 0,
                 device="cuda"):
        super().__init__(iterators, seed=seed, device=device)
        self.train_step = train_step
        self.state = state

    def update_core(self):
        batch = _to_device(self.next_batch("images"), self.device)
        self.report(self.train_step(self.state, batch, self.rng), prefix="loss")


class AutoencoderDiscriminatorUpdater(Updater):
    """D, then R1 when iteration % d_interval == 0, then the autoencoder."""

    def __init__(self, steps: Dict[str, Callable], state: AETrainState, iterators,
                 d_interval: int = 16, seed: int = 0, device="cuda"):
        super().__init__(iterators, seed=seed, device=device)
        self.steps = steps
        self.state = state
        self.d_interval = d_interval

    def update_core(self):
        batch = _to_device(self.next_batch("images"), self.device)
        d_metrics = self.steps["d_step"](self.state, batch, self.rng)
        if self.iteration % self.d_interval == 0:
            d_metrics.update(self.steps["d_reg_step"](self.state, batch))
        self.report(d_metrics, prefix="discriminator")
        self.report(self.steps["g_step"](self.state, batch, self.rng), prefix="generator")
