"""GAN-inversion encoders: image -> (w / w+ latents, per-layer noise)
(counterpart of synthesis_in_style_tpu/models/encoder.py).

* Images come in NHWC, as everywhere at the port's interfaces; the encoders
  run NCHW inside (a permuted view of the input). Latents come out (B,
  n_latent, D) for w+ and (B, D) for w; noise maps come out (B, H, W, 1),
  smallest resolution first, the layout and order of the generator's noise
  list (`NoiseInjection.plane` in models/stylegan2.py reads them as they
  are).
* `UNetLikeEncoder` is the shared trunk: a ResNet BasicBlock pyramid from
  image_size down to 4px, with latent heads (global average pool, then a
  1x1 conv) and noise heads (a 1x1 conv to one channel, or a BasicBlock)
  tapped at each step as the variant asks. StyleGAN1 decoders (variant 1)
  take one noise map per resolution, StyleGAN2 two (one at 4px).
* BatchNorm follows flax's `nn.BatchNorm()`: momentum 0.99 (torch's 0.01),
  eps 1e-5, and the running variance moves towards the biased batch
  variance (`models/doc_ufcn.BiasedRunningVariance`). Training mode is the
  module's (`.train()` / `.eval()`).
* Parameter names follow the JAX modules: `resnet_blocks.<i>`,
  `intermediate_blocks.<i>`, `to_latents.<i>` / `intermediate_to_latents.<i>`
  (the JAX `to_latent_<i>` / `intermediate_to_latent_<i>`), `to_noises.<i>` /
  `intermediate_to_noises.<i>`, `to_latent`, `to_code`, and `inner` for the
  wrappers that sum w+ to w; `utils/checkpoint.encoder_params_from_jax`
  carries the JAX parameters and statistics across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from synthesis_in_style_tpu_torch.losses.feature_extractors import lecun_init_
from synthesis_in_style_tpu_torch.models.doc_ufcn import BiasedRunningVariance

BN_MOMENTUM = 0.01  # flax's momentum 0.99
BN_EPS = 1e-5


@dataclasses.dataclass
class Latents:
    latent: Optional[torch.Tensor]
    noise: Optional[Tuple[torch.Tensor, ...]]

    def replace(self, **changes) -> "Latents":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class CodeLatents(Latents):
    code: Optional[torch.Tensor] = None


class BatchNorm2d(BiasedRunningVariance, nn.BatchNorm2d):
    """`nn.BatchNorm2d` with flax's defaults and running-variance update."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    """torchvision's ResNet BasicBlock (3x3-BN-ReLU-3x3-BN + skip) on NCHW.
    The skip is a 1x1 conv (with bias) when asked for or when the stride or
    the width changes; `downsample_bn=False` leaves out its BatchNorm (the
    noise resblocks)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 use_downsample: bool = False, downsample_bn: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample_conv = self.downsample_bn = None
        if use_downsample or stride != 1 or in_channels != features:
            self.downsample_conv = nn.Conv2d(in_channels, features, 1, stride=stride)
            if downsample_bn:
                self.downsample_bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_conv(x)
            if self.downsample_bn is not None:
                identity = self.downsample_bn(identity)
        return torch.relu(out + identity)


def _pyramid_sizes(image_size: int, target_size: int) -> List[int]:
    log_in, log_target = int(math.log2(image_size)), int(math.log2(target_size))
    return [image_size] + [2**s for s in range(log_in - 1, log_target - 1, -1)]


def _latent_head(channels: int, latent_size: int) -> nn.Conv2d:
    return nn.Conv2d(channels, latent_size, 1)


def _pooled(head: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
    """Global average pool, then the 1x1 conv head -> (B, out)."""
    return head(h.mean(dim=(2, 3), keepdim=True)).flatten(1)


def _nhwc_noise(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Initialised(nn.Module):
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's default init drawn from `generator`: conv kernels
        lecun_normal, conv biases 0, BatchNorm scale 1 and bias 0,
        statistics mean 0 and variance 1."""
        lecun_init_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self


class UNetLikeEncoder(_Initialised):
    """The shared trunk; the flags choose the heads:
    with_latent_heads (w+: two per step), with_single_latent (one w after
    the last step), with_noise_heads (one per step, plus one after each
    intermediate block but the last for StyleGAN2), noise_as_resblock
    (noise heads are BasicBlocks), with_code_head (an info code beside w)."""

    def __init__(self, image_size: int, latent_size: int, num_input_channels: int,
                 size_channel_map: Dict, target_size: int = 4, stylegan_variant: int = 2,
                 with_latent_heads: bool = False, with_single_latent: bool = False,
                 with_noise_heads: bool = False, noise_as_resblock: bool = False,
                 with_code_head: bool = False, code_dim: int = 0):
        super().__init__()
        scm = {int(k): int(v) for k, v in size_channel_map.items()}
        self.image_size = image_size
        self.latent_size = latent_size
        self.stylegan_variant = stylegan_variant
        self.with_latent_heads = with_latent_heads
        self.with_single_latent = with_single_latent
        self.with_noise_heads = with_noise_heads
        self.with_code_head = with_code_head
        self.code_dim = code_dim
        sizes = _pyramid_sizes(image_size, target_size)
        self.num_steps = len(sizes)

        def noise_head(c: int) -> nn.Module:
            if noise_as_resblock:
                return BasicBlock(c, 1, use_downsample=True, downsample_bn=False)
            return nn.Conv2d(c, 1, 1)

        self.resnet_blocks, self.intermediate_blocks = nn.ModuleList(), nn.ModuleList()
        self.to_latents, self.intermediate_to_latents = nn.ModuleList(), nn.ModuleList()
        self.to_noises, self.intermediate_to_noises = nn.ModuleList(), nn.ModuleList()
        c_in = num_input_channels
        for i, size in enumerate(sizes):
            c = scm[size]
            self.resnet_blocks.append(BasicBlock(c_in, c, stride=1 if i == 0 else 2,
                                                 use_downsample=True))
            self.intermediate_blocks.append(BasicBlock(c, c))
            if with_latent_heads:
                self.to_latents.append(_latent_head(c, latent_size))
                self.intermediate_to_latents.append(_latent_head(c, latent_size))
            if with_noise_heads:
                self.to_noises.append(noise_head(c))
                if stylegan_variant == 2 and i < len(sizes) - 1:
                    self.intermediate_to_noises.append(noise_head(c))
            c_in = c
        if not with_latent_heads and with_single_latent:
            self.to_latent = _latent_head(c_in, latent_size)
            if with_code_head:
                self.to_code = _latent_head(c_in, code_dim)

    def forward(self, x: torch.Tensor) -> Latents:
        h = x.permute(0, 3, 1, 2)
        latent_codes: List[torch.Tensor] = []
        noise_codes: List[torch.Tensor] = []
        for i in range(self.num_steps):
            h = self.resnet_blocks[i](h)
            if self.with_latent_heads:
                latent_codes.append(_pooled(self.to_latents[i], h))
            if self.with_noise_heads:
                noise_codes.append(_nhwc_noise(self.to_noises[i](h)))
            h = self.intermediate_blocks[i](h)
            if self.with_latent_heads:
                latent_codes.append(_pooled(self.intermediate_to_latents[i], h))
            if self.with_noise_heads and i < len(self.intermediate_to_noises):
                noise_codes.append(_nhwc_noise(self.intermediate_to_noises[i](h)))

        latent = code = None
        if self.with_latent_heads:
            latent = torch.stack(latent_codes[::-1], dim=1)
        elif self.with_single_latent:
            latent = _pooled(self.to_latent, h)
            if self.with_code_head:
                code = _pooled(self.to_code, h)
        noise = tuple(noise_codes[::-1]) if self.with_noise_heads else None
        if self.with_code_head:
            return CodeLatents(latent=latent, noise=noise, code=code)
        return Latents(latent=latent, noise=noise)


def WPlusEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                 stylegan_variant: int = 2, **kwargs) -> UNetLikeEncoder:
    """w+ latents and per-layer noise."""
    return UNetLikeEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                           stylegan_variant=stylegan_variant, with_latent_heads=True,
                           with_noise_heads=True, **kwargs)


def WPlusResnetNoiseEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                            stylegan_variant: int = 2, **kwargs) -> UNetLikeEncoder:
    """w+ latents; the noise heads are BasicBlocks."""
    return UNetLikeEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                           stylegan_variant=stylegan_variant, with_latent_heads=True,
                           with_noise_heads=True, noise_as_resblock=True, **kwargs)


def WEncoder(image_size, latent_size, num_input_channels, size_channel_map,
             stylegan_variant: int = 2, **kwargs) -> UNetLikeEncoder:
    """One w and per-layer noise."""
    return UNetLikeEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                           stylegan_variant=stylegan_variant, with_single_latent=True,
                           with_noise_heads=True, **kwargs)


def WCodeEncoder(code_dim, image_size, latent_size, num_input_channels, size_channel_map,
                 stylegan_variant: int = 2, **kwargs) -> UNetLikeEncoder:
    """One w, an info code and per-layer noise."""
    return UNetLikeEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                           stylegan_variant=stylegan_variant, with_single_latent=True,
                           with_noise_heads=True, with_code_head=True, code_dim=code_dim,
                           **kwargs)


def WPlusNoNoiseEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                        stylegan_variant: int = 2, **kwargs) -> UNetLikeEncoder:
    """w+ latents, no noise."""
    return UNetLikeEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                           stylegan_variant=stylegan_variant, with_latent_heads=True, **kwargs)


def NoiseEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                 stylegan_variant: int = 2, **kwargs) -> UNetLikeEncoder:
    """Per-layer noise only."""
    return UNetLikeEncoder(image_size, latent_size, num_input_channels, size_channel_map,
                           stylegan_variant=stylegan_variant, with_noise_heads=True, **kwargs)


class _SummedWPlus(_Initialised):
    """w+ heads summed over the layer axis to one w."""

    with_noise = True

    def __init__(self, image_size, latent_size, num_input_channels, size_channel_map,
                 stylegan_variant: int = 2):
        super().__init__()
        self.image_size = image_size
        self.inner = UNetLikeEncoder(image_size, latent_size, num_input_channels,
                                     size_channel_map, stylegan_variant=stylegan_variant,
                                     with_latent_heads=True, with_noise_heads=self.with_noise)

    def forward(self, x: torch.Tensor) -> Latents:
        latents = self.inner(x)
        return Latents(latent=latents.latent.sum(dim=1), noise=latents.noise)


class WWPlusEncoder(_SummedWPlus):
    """w+ summed to w, and per-layer noise."""


class WNoNoiseEncoder(_SummedWPlus):
    """w+ summed to w, no noise."""

    with_noise = False


class Encoder(_Initialised):
    """Plain resnet encoder: the BasicBlock pyramid, then
    2 * (log2(image_size) - log2(target_size)) + 2 latent heads, each a
    target_size x target_size conv over the last map -> (B, n, D)."""

    def __init__(self, image_size: int, latent_size: int, num_input_channels: int,
                 size_channel_map: Dict, target_size: int = 4):
        super().__init__()
        scm = {int(k): int(v) for k, v in size_channel_map.items()}
        self.image_size = image_size
        sizes = _pyramid_sizes(image_size, target_size)
        self.resnet_blocks = nn.ModuleList()
        c_in = num_input_channels
        for i, size in enumerate(sizes):
            self.resnet_blocks.append(BasicBlock(c_in, scm[size], stride=1 if i == 0 else 2,
                                                 use_downsample=True))
            c_in = scm[size]
        num_latents = (len(sizes) - 1) * 2 + 2
        self.to_latents = nn.ModuleList(nn.Conv2d(c_in, latent_size, target_size)
                                        for _ in range(num_latents))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for block in self.resnet_blocks:
            h = block(h)
        return torch.stack([head(h).flatten(1) for head in self.to_latents], dim=1)
