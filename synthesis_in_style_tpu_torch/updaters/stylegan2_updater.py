"""StyleGAN2 training steps (counterpart of
synthesis_in_style_tpu/updaters/stylegan2_updater.py).

One iteration, in the JAX package's order: D step, R1 every `d_reg_every`
iterations, G step, path-length regularization every `g_reg_every`
iterations, EMA last.

* The random draws are separate from the step arithmetic: `draw_mix` and
  `draw_path` take the updater's torch.Generator, and each step function
  takes what they drew (z1, z2, the mixing index, the per-layer noise, the
  path-length image noise). Tests feed the JAX step's draws to the port's.
  n_latent, the layers and their noise shapes come from the generator (its
  `n_latent` and noise buffers), so StyleGAN2 (14 latents at 256px) and
  SWAGAN (12) train through the same steps.
* `compute_dtype` ("bfloat16") casts every floating parameter and buffer
  for the D and G steps, like the JAX package's `cast_floating`; the cast
  is differentiable, so gradients reach the float32 masters. R1 and path
  length stay float32.
* Every step hands its gradients to its `GANOptimizer`: global-norm clip
  (optax.clip_by_global_norm, no epsilon) and Adam with the learning rate
  of a schedule evaluated at the 0-based update count (optax.adam). A
  parameter the loss does not reach gets a zero gradient, so every Adam
  state advances together, as optax's single count does.
* In a launched multi-process run (parallel/distributed.py) each process
  steps on its shard of the global batch: every process draws the global
  batch's randoms from the same generator and keeps its rows
  (`local_draws`), the optimizers average the gradients, the discriminator's
  minibatch stddev spans the global batch, the path-length mean is the
  global one, and the reported metrics are averaged over the processes.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from synthesis_in_style_tpu_torch.core.updater import Updater
from synthesis_in_style_tpu_torch.parallel import distributed
from synthesis_in_style_tpu_torch.losses.gan import (
    d_logistic_loss,
    g_nonsaturating_loss,
    r1_penalty,
)


@dataclass
class StyleGAN2Config:
    r1_weight: float = 10.0
    path_reg_weight: float = 2.0
    d_reg_every: int = 16
    g_reg_every: int = 4
    mixing_prob: float = 0.9
    path_batch_shrink: int = 2
    ema_decay: float = 0.5 ** (32 / (10 * 1000))
    # layers whose noise is the stored buffer in every training forward;
    # the others draw fresh noise each step
    freeze_noise_layers: Tuple[int, ...] = ()
    # "bfloat16": D and G steps in that type, float32 masters
    compute_dtype: Optional[str] = None

    @property
    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        return getattr(torch, self.compute_dtype) if self.compute_dtype else None


class GANOptimizer:
    """optax.chain(clip_by_global_norm(max_norm), adam(schedule, b1, b2,
    eps)) over a fixed parameter list, on torch.optim.Adam (whose state
    dict is the reference snapshot's optimizer entry). With `weight_decay`,
    the chain is clip -> add_decayed_weights(weight_decay) -> adam: torch's
    Adam adds weight_decay * param to the clipped gradient before its
    moments (the segmenter's optimizer)."""

    def __init__(self, params: Sequence[nn.Parameter], schedule: Callable[[int], float],
                 betas: Tuple[float, float], eps: float = 1e-8, max_norm: float = 1.0,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=schedule(0), betas=betas, eps=eps,
                                     weight_decay=weight_decay)

    @property
    def count(self) -> int:
        """Updates made so far (Adam's step count, the same for every
        parameter)."""
        state = self.adam.state.get(self.params[0])
        return int(state["step"]) if state else 0

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update from `grads` (in `params` order), averaged over the
        processes of a launched run first."""
        grads = distributed.average_gradients(grads)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # optax: t if norm < max_norm else t / norm * max_norm
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        for p, g in zip(self.params, grads):
            p.grad = g * factor
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


@dataclass
class GANTrainState:
    generator: nn.Module
    discriminator: nn.Module
    g_ema: nn.Module
    g_optimizer: GANOptimizer
    d_optimizer: GANOptimizer
    mean_path_length: torch.Tensor
    step: int = 0


def create_gan_train_state(generator: nn.Module, discriminator: nn.Module,
                           g_schedule: Callable[[int], float], d_schedule: Callable[[int], float],
                           g_betas: Tuple[float, float], d_betas: Tuple[float, float]
                           ) -> GANTrainState:
    """Train state over initialised networks; g_ema starts as a copy of
    the generator (parameters and noise buffers)."""
    device = next(generator.parameters()).device
    g_ema = copy.deepcopy(generator).eval().requires_grad_(False)
    return GANTrainState(
        generator=generator,
        discriminator=discriminator,
        g_ema=g_ema,
        g_optimizer=GANOptimizer(generator.parameters(), g_schedule, g_betas),
        d_optimizer=GANOptimizer(discriminator.parameters(), d_schedule, d_betas),
        mean_path_length=torch.zeros((), device=device),
    )


@dataclass
class MixDraws:
    """The random inputs of one generator forward with style mixing."""

    z1: torch.Tensor
    z2: torch.Tensor
    inject_index: torch.Tensor  # n_latent means "no mixing"
    noise: List[torch.Tensor]  # per layer: the stored buffer or fresh noise


def draw_mix(rng: torch.Generator, gen: nn.Module, batch: int,
             cfg: StyleGAN2Config) -> MixDraws:
    """z1, z2 ~ N(0, 1); with probability `mixing_prob` an inject index
    uniform in [1, n_latent), else n_latent; fresh (batch, H, W, 1) noise
    for every layer not frozen."""
    device = rng.device
    z1 = torch.randn((batch, gen.style_dim), generator=rng, device=device)
    z2 = torch.randn((batch, gen.style_dim), generator=rng, device=device)
    mixed = torch.rand((), generator=rng, device=device) < cfg.mixing_prob
    idx = torch.randint(1, gen.n_latent, (), generator=rng, device=device)
    inject = torch.where(mixed, idx, torch.full_like(idx, gen.n_latent))
    frozen = set(cfg.freeze_noise_layers)
    noise = [
        buf if i in frozen
        else torch.randn((batch,) + tuple(buf.shape[1:]), generator=rng, device=device)
        for i, buf in enumerate(gen.noises.nhwc())
    ]
    return MixDraws(z1, z2, inject, noise)


def draw_path(rng: torch.Generator, gen: nn.Module, batch_size: int,
              cfg: StyleGAN2Config) -> Tuple[MixDraws, torch.Tensor]:
    """The path-length step's draws: a mix at batch_size // path_batch_shrink
    and the image-space noise N(0, 1) / sqrt(H * W)."""
    path_batch = max(1, batch_size // cfg.path_batch_shrink)
    mix = draw_mix(rng, gen, path_batch, cfg)
    shape = (path_batch, gen.size, gen.size, 3)
    pl_noise = torch.randn(shape, generator=rng, device=rng.device) / math.sqrt(gen.size**2)
    return mix, pl_noise


def local_draws(draws: MixDraws, global_batch: int) -> MixDraws:
    """This process's rows of draws made for the global batch (all of them
    in a single process); a stored noise buffer (batch 1) is shared."""
    if distributed.get_world_size() == 1:
        return draws
    rows = distributed.local_batch_slice(global_batch)
    return MixDraws(draws.z1[rows], draws.z2[rows], draws.inject_index,
                    [n[rows] if n.shape[0] == global_batch else n for n in draws.noise])


def _cast(module: nn.Module, dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """{name: tensor} of `module`'s parameters and buffers, the floating ones
    cast to `dtype` (differentiably) when it is given."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    if dtype is None:
        return tensors
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}


def _apply(module: nn.Module, tensors: Dict[str, torch.Tensor], *args, **kwargs):
    return torch.func.functional_call(module, tensors, args, kwargs)


def _fake_images(gen: nn.Module, draws: MixDraws, dtype: Optional[torch.dtype]) -> torch.Tensor:
    z1, z2 = (draws.z1, draws.z2) if dtype is None else (draws.z1.to(dtype), draws.z2.to(dtype))
    image, _ = _apply(gen, _cast(gen, dtype), [z1, z2], inject_index=draws.inject_index,
                      noise=draws.noise)
    return image


def _grads(loss: torch.Tensor, module: nn.Module) -> List[Optional[torch.Tensor]]:
    return list(torch.autograd.grad(loss, list(module.parameters()), allow_unused=True))


def d_step(state: GANTrainState, cfg: StyleGAN2Config, real: torch.Tensor,
           draws: MixDraws) -> Dict[str, torch.Tensor]:
    dtype = cfg.torch_compute_dtype
    with torch.no_grad():
        fake = _fake_images(state.generator, draws, dtype)
    if dtype is not None:
        real = real.to(dtype)
    disc = state.discriminator
    d_tensors = _cast(disc, dtype)
    fake_pred = _apply(disc, d_tensors, fake).float()
    real_pred = _apply(disc, d_tensors, real).float()
    loss = d_logistic_loss(real_pred, fake_pred)
    state.d_optimizer.step(_grads(loss, disc))
    return {"discriminator_loss": loss.detach(), "real_score": real_pred.mean().detach(),
            "fake_score": fake_pred.mean().detach()}


def d_reg_step(state: GANTrainState, cfg: StyleGAN2Config,
               real: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Lazy R1 in float32."""
    disc = state.discriminator
    penalty, r1 = r1_penalty(disc, real, cfg.r1_weight, cfg.d_reg_every)
    state.d_optimizer.step(_grads(penalty, disc))
    return {"r1_penalty": r1.detach()}


def g_step(state: GANTrainState, cfg: StyleGAN2Config,
           draws: MixDraws) -> Dict[str, torch.Tensor]:
    dtype = cfg.torch_compute_dtype
    gen, disc = state.generator, state.discriminator
    fake = _fake_images(gen, draws, dtype)
    fake_pred = _apply(disc, _cast(disc, dtype), fake).float()
    loss = g_nonsaturating_loss(fake_pred)
    state.g_optimizer.step(_grads(loss, gen))
    state.step += 1
    return {"generator_loss": loss.detach()}


def g_reg_step(state: GANTrainState, cfg: StyleGAN2Config, draws: MixDraws,
               pl_noise: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Path-length regularization in float32: the gradient of the image,
    weighted by `pl_noise`, with respect to the per-layer latent, and its
    penalty against the decay-0.01 running mean (the mean keeps its
    gradient, as in the JAX step)."""
    gen = state.generator
    w1, w2 = gen.get_latent(draws.z1), gen.get_latent(draws.z2)
    pos = torch.arange(gen.n_latent, device=w1.device)[None, :, None]
    latent = torch.where(pos < draws.inject_index, w1[:, None, :], w2[:, None, :])
    image, _ = gen([latent], input_is_latent=True, noise=draws.noise)
    (grad_lat,) = torch.autograd.grad((image * pl_noise).sum(), latent, create_graph=True)
    path_lengths = grad_lat.square().sum(dim=2).mean(dim=1).sqrt()
    mpl = state.mean_path_length
    # the mean over the global batch (of equal shards), with its gradient
    global_mean = distributed.global_sum(path_lengths.mean()) / distributed.get_world_size()
    path_mean = mpl + 0.01 * (global_mean - mpl)
    path_loss = (path_lengths - path_mean).square().mean()
    # 0 * image keeps every parameter in the graph
    weighted = cfg.path_reg_weight * cfg.g_reg_every * path_loss + 0.0 * image[0, 0, 0, 0]
    state.g_optimizer.step(_grads(weighted, gen))
    state.mean_path_length = path_mean.detach()
    return {"path_loss": path_loss.detach(), "path_length": path_lengths.mean().detach(),
            "mean_path_length": path_mean.detach()}


@torch.no_grad()
def ema_step(state: GANTrainState, cfg: StyleGAN2Config) -> Dict[str, torch.Tensor]:
    """g_ema <- decay * g_ema + (1 - decay) * generator, parameters only."""
    decay = cfg.ema_decay
    for e, p in zip(state.g_ema.parameters(), state.generator.parameters()):
        e.mul_(decay).add_(p, alpha=1 - decay)
    return {}


class StyleGAN2Updater(Updater):
    """The loop body: draws, then D -> (R1) -> G -> (path length) -> EMA."""

    def __init__(self, state: GANTrainState, iterators, batch_size: int,
                 cfg: Optional[StyleGAN2Config] = None, seed: int = 0, device="cuda"):
        super().__init__(iterators, seed=seed, device=device)
        self.state = state
        self.batch_size = batch_size
        self.cfg = cfg or StyleGAN2Config()

    def update_core(self):
        """`batch_size` is the global batch; `real` this process's shard."""
        cfg, state, gen = self.cfg, self.state, self.state.generator
        real = self.next_batch("images").to(self.device, non_blocking=True)
        world = distributed.get_world_size()
        metrics = {}
        d_batch = real.shape[0] * world
        metrics.update(d_step(state, cfg, real,
                              local_draws(draw_mix(self.rng, gen, d_batch, cfg), d_batch)))
        if cfg.d_reg_every > 0 and self.iteration % cfg.d_reg_every == 0:
            metrics.update(d_reg_step(state, cfg, real))
        metrics.update(g_step(state, cfg, local_draws(
            draw_mix(self.rng, gen, self.batch_size, cfg), self.batch_size)))
        if cfg.g_reg_every > 0 and self.iteration % cfg.g_reg_every == 0:
            mix, pl_noise = draw_path(self.rng, gen, self.batch_size, cfg)
            path_batch = pl_noise.shape[0]
            if world > 1:
                pl_noise = pl_noise[distributed.local_batch_slice(path_batch)]
            metrics.update(g_reg_step(state, cfg, local_draws(mix, path_batch), pl_noise))
        ema_step(state, cfg)
        self.report(distributed.reduce_metrics(metrics), prefix="train")
