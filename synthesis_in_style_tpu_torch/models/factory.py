"""Generator and discriminator factories and checkpoint-backed loading
(counterpart of synthesis_in_style_tpu/models/factory.py): `stylegan_variant`
2 (StyleGAN2) and "swagan" (SWAGAN); StyleGAN1 is not ported."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from synthesis_in_style_tpu_torch.models import stylegan2, swagan
from synthesis_in_style_tpu_torch.utils.checkpoint import load_generator_state

# seed of the default noise buffers for a checkpoint that carries none
NOISE_SEED = 1


def _variant(config: Dict[str, Any], variant: Optional[Union[str, int]]) -> str:
    variant = str(variant if variant is not None else config.get("stylegan_variant", 2))
    if variant not in ("2", "swagan"):
        raise NotImplementedError(
            f"stylegan variant {variant!r} is not ported yet (see ROADMAP.md)"
        )
    return variant


def get_generator(config: Dict[str, Any], variant: Optional[Union[str, int]] = None
                  ) -> stylegan2.Generator:
    """Generator from a training config (`image_size`, `latent_size`,
    `n_mlp`, `channel_multiplier`, `stylegan_variant`)."""
    module = swagan if _variant(config, variant) == "swagan" else stylegan2
    return module.Generator(
        size=config["image_size"],
        style_dim=config.get("latent_size", 512),
        n_mlp=config.get("n_mlp", 8),
        channel_multiplier=config.get("channel_multiplier", 2),
    )


def get_discriminator(config: Dict[str, Any], variant: Optional[Union[str, int]] = None
                      ) -> nn.Module:
    """Discriminator from a training config (`image_size`,
    `channel_multiplier`, `input_dim` (StyleGAN2 only), `stylegan_variant`)."""
    size, multiplier = config["image_size"], config.get("channel_multiplier", 2)
    if _variant(config, variant) == "swagan":
        return swagan.Discriminator(size=size, channel_multiplier=multiplier)
    return stylegan2.Discriminator(size=size, channel_multiplier=multiplier,
                                   input_channels=config.get("input_dim", 3))


def load_generator(
    checkpoint_path: Union[str, Path],
    config: Dict[str, Any],
    device: Union[str, torch.device] = "cuda",
) -> stylegan2.Generator:
    """Generator of the config's variant with weights from
    `checkpoint_path`, in eval mode on `device`. A checkpoint without noise
    buffers gets them drawn from a torch.Generator seeded with NOISE_SEED
    (the JAX package draws its own with jax.random; the two differ)."""
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
