"""Generator, discriminator and autoencoder factories and checkpoint-backed
loading (counterpart of synthesis_in_style_tpu/models/factory.py):
`stylegan_variant` 2 (StyleGAN2), "swagan" (SWAGAN) and 1 (StyleGAN1)."""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from synthesis_in_style_tpu_torch.models import stylegan1, stylegan2, swagan
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    load_autoencoder_snapshot,
    load_generator_state,
)

# seed of the default noise buffers for a checkpoint that carries none
NOISE_SEED = 1


def _variant(config: Dict[str, Any], variant: Optional[Union[str, int]]) -> str:
    variant = str(variant if variant is not None else config.get("stylegan_variant", 2))
    if variant not in ("1", "2", "swagan"):
        raise NotImplementedError(f"stylegan variant {variant!r} not supported")
    return variant


def get_generator(config: Dict[str, Any], variant: Optional[Union[str, int]] = None
                  ) -> nn.Module:
    """Generator from a training config (`image_size`, `latent_size`,
    `n_mlp`, `channel_multiplier` and `quantize` (not StyleGAN1),
    `stylegan_variant`)."""
    variant = _variant(config, variant)
    if variant == "1":
        return stylegan1.StyledGenerator(size=config["image_size"],
                                         code_dim=config.get("latent_size", 512),
                                         n_mlp=config.get("n_mlp", 8))
    module = swagan if variant == "swagan" else stylegan2
    return module.Generator(
        size=config["image_size"],
        style_dim=config.get("latent_size", 512),
        n_mlp=config.get("n_mlp", 8),
        channel_multiplier=config.get("channel_multiplier", 2),
        # the int8 serving path (ops/quant.py), a synthesis-time key
        quantized=bool(config.get("quantize", False)),
    )


def get_discriminator(config: Dict[str, Any], variant: Optional[Union[str, int]] = None
                      ) -> nn.Module:
    """Discriminator from a training config (`image_size`,
    `channel_multiplier`, `input_dim` (StyleGAN2 only), `stylegan_variant`).
    StyleGAN1's runs the whole pyramid for the image size."""
    variant = _variant(config, variant)
    size, multiplier = config["image_size"], config.get("channel_multiplier", 2)
    if variant == "1":
        return stylegan1.ProgressiveDiscriminator(default_step=int(math.log2(size)) - 2)
    if variant == "swagan":
        return swagan.Discriminator(size=size, channel_multiplier=multiplier)
    return stylegan2.Discriminator(size=size, channel_multiplier=multiplier,
                                   input_channels=config.get("input_dim", 3))


def autoencoder_type_from_config(config: Dict[str, Any]) -> str:
    """`two_stem` beats `dropout_autoencoder`, else the plain w+
    autoencoder."""
    if config.get("two_stem", False):
        return "two_stem"
    if config.get("dropout_autoencoder", False):
        return "dropout"
    return "wplus"


def get_autoencoder(config: Dict[str, Any], autoencoder_type: str = "wplus") -> nn.Module:
    """Encoder + generator composition from a training config.

    autoencoder_type: 'wplus' | 'dropout' | 'two_stem' | 'content_and_style'
    | 'superresolution' | 'wplus_resnet_noise'. `w_only` swaps in the
    encoders summed to w (WNoNoiseEncoder for two_stem, WWPlusEncoder
    otherwise). The encoders take StyleGAN2's channel map for every variant,
    as the JAX factory does. Parameters are left uninitialized: call the
    encoders' and decoder's `init_weights` or load a state dict."""
    from synthesis_in_style_tpu_torch.models import autoencoder as ae
    from synthesis_in_style_tpu_torch.models import encoder as enc

    decoder = get_generator(config)
    channels = stylegan2.generator_channels(config.get("channel_multiplier", 2))
    image_size = config["image_size"]
    latent_size = config.get("latent_size", 512)
    in_ch = config.get("input_dim", 3)
    variant = 1 if str(config.get("stylegan_variant", 2)) == "1" else 2
    w_only = bool(config.get("w_only", False))

    def wplus_encoder(num_channels=in_ch):
        cls = enc.WWPlusEncoder if w_only else enc.WPlusEncoder
        return cls(image_size, latent_size, num_channels, channels, stylegan_variant=variant)

    if autoencoder_type == "wplus":
        return ae.StyleganAutoencoder(wplus_encoder(), decoder)
    if autoencoder_type == "dropout":
        return ae.DropoutStyleganAutoencoder(wplus_encoder(), decoder)
    if autoencoder_type == "wplus_resnet_noise":
        return ae.StyleganAutoencoder(
            enc.WPlusResnetNoiseEncoder(image_size, latent_size, in_ch, channels,
                                        stylegan_variant=variant), decoder)
    if autoencoder_type == "content_and_style":
        return ae.ContentAndStyleStyleganAutoencoder(wplus_encoder(2 * in_ch), decoder)
    if autoencoder_type == "superresolution":
        return ae.SuperResolutionStyleganAutoencoder(
            wplus_encoder(), decoder,
            extend_noise_with_random=config.get("extend_noise_with_random", True))
    if autoencoder_type == "two_stem":
        latent_cls = enc.WNoNoiseEncoder if w_only else enc.WPlusNoNoiseEncoder
        return ae.TwoStemStyleganAutoencoder(
            latent_cls(image_size, latent_size, in_ch, channels, stylegan_variant=variant),
            enc.NoiseEncoder(image_size, latent_size, in_ch, channels,
                             stylegan_variant=variant),
            decoder)
    raise NotImplementedError(autoencoder_type)


def load_autoencoder_state(model: nn.Module, state: Dict[str, torch.Tensor],
                           mapping_prefix: str = "decoder.style") -> None:
    """Load an autoencoder's (or, with mapping_prefix "style", its
    decoder's) state dict. A JAX autoencoder that only ever decoded w+
    latents has no parameters for its decoder's mapping network (flax
    creates them on first use): those, and only those, may be missing, and
    keep the module's own values."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    bad = [k for k in missing if not k.startswith(mapping_prefix)] + list(unexpected)
    if bad:
        raise RuntimeError(f"autoencoder state dict does not fit: {bad}")


def load_autoencoder_or_generator(
    checkpoint_path: Union[str, Path],
    config: Dict[str, Any],
    device: Union[str, torch.device] = "cuda",
) -> nn.Module:
    """The whole autoencoder (of `autoencoder_type_from_config(config)`)
    when the checkpoint holds an `autoencoder` entry, else the generator of
    `load_generator`; in eval mode on `device`."""
    snapshot = load_autoencoder_snapshot(checkpoint_path)
    if snapshot is None:
        return load_generator(checkpoint_path, config, device)
    model = get_autoencoder(config, autoencoder_type_from_config(config))
    model.decoder.init_weights(torch.Generator().manual_seed(NOISE_SEED))
    load_autoencoder_state(model, snapshot["autoencoder"])
    return model.to(device).eval()


def load_generator(
    checkpoint_path: Union[str, Path],
    config: Dict[str, Any],
    device: Union[str, torch.device] = "cuda",
) -> nn.Module:
    """Generator of the config's variant with weights from
    `checkpoint_path`, in eval mode on `device`. A StyleGAN2 checkpoint
    without noise buffers gets them drawn from a torch.Generator seeded with
    NOISE_SEED (the JAX package draws its own with jax.random; the two
    differ). StyleGAN1 keeps no noise buffers."""
    gen = get_generator(config)
    if isinstance(gen, stylegan1.StyledGenerator):
        from synthesis_in_style_tpu_torch.utils.checkpoint import load_stylegan1_generator_state

        gen.load_state_dict(load_stylegan1_generator_state(checkpoint_path), strict=True)
        return gen.to(device).eval()
    state = load_generator_state(checkpoint_path)
    missing_noise = not any(k.startswith("noises.") for k in state)
    if missing_noise:
        g = torch.Generator().manual_seed(NOISE_SEED)
        for i in range(gen.noises.num):
            buf = getattr(gen.noises, f"noise_{i}")
            state[f"noises.noise_{i}"] = torch.randn(buf.shape, generator=g)
    gen.load_state_dict(state, strict=True)
    return gen.to(device).eval()
