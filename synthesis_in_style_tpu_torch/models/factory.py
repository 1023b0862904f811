"""Generator and discriminator factories and checkpoint-backed loading
(counterpart of synthesis_in_style_tpu/models/factory.py, StyleGAN2 variant
only)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from synthesis_in_style_tpu_torch.models.stylegan2 import Discriminator, Generator
from synthesis_in_style_tpu_torch.utils.checkpoint import load_generator_state

# seed of the default noise buffers for a checkpoint that carries none
NOISE_SEED = 1


def _check_variant(config: Dict[str, Any], variant: Optional[Union[str, int]]) -> None:
    variant = variant if variant is not None else config.get("stylegan_variant", 2)
    if str(variant) != "2":
        raise NotImplementedError(
            f"stylegan variant {variant!r} is not ported yet (see ROADMAP.md)"
        )


def get_generator(config: Dict[str, Any], variant: Optional[Union[str, int]] = None) -> Generator:
    """Generator from a training config (`image_size`, `latent_size`,
    `n_mlp`, `channel_multiplier`, `stylegan_variant`)."""
    _check_variant(config, variant)
    return Generator(
        size=config["image_size"],
        style_dim=config.get("latent_size", 512),
        n_mlp=config.get("n_mlp", 8),
        channel_multiplier=config.get("channel_multiplier", 2),
    )


def get_discriminator(
    config: Dict[str, Any], variant: Optional[Union[str, int]] = None
) -> Discriminator:
    """Discriminator from a training config (`image_size`,
    `channel_multiplier`, `input_dim`, `stylegan_variant`)."""
    _check_variant(config, variant)
    return Discriminator(
        size=config["image_size"],
        channel_multiplier=config.get("channel_multiplier", 2),
        input_channels=config.get("input_dim", 3),
    )


def load_generator(
    checkpoint_path: Union[str, Path],
    config: Dict[str, Any],
    device: Union[str, torch.device] = "cuda",
) -> Generator:
    """Generator with weights from `checkpoint_path`, in eval mode on
    `device`. A checkpoint without noise buffers gets them drawn from a
    torch.Generator seeded with NOISE_SEED (the JAX package draws its own
    from jax.random; the two differ)."""
    gen = get_generator(config)
    state = load_generator_state(checkpoint_path)
    missing_noise = not any(k.startswith("noises.") for k in state)
    if missing_noise:
        g = torch.Generator().manual_seed(NOISE_SEED)
        for i in range(gen.noises.num):
            buf = getattr(gen.noises, f"noise_{i}")
            state[f"noises.noise_{i}"] = torch.randn(buf.shape, generator=g)
    gen.load_state_dict(state, strict=True)
    return gen.to(device).eval()
