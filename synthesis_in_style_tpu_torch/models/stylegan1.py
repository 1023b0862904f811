"""StyleGAN1: the progressive AdaIN generator and discriminator (counterpart
of synthesis_in_style_tpu/models/stylegan1.py).

* Equalized learning rate: weights N(0, 1), scaled by sqrt(2 / fan_in) at
  call time.
* FusedUpsample / FusedDownsample pad the kernel by one and average its four
  shifted copies, then run a stride-2 transposed conv / conv.
* blur_3x3 is a depthwise binomial conv; AdaIN is an instance norm (biased
  variance, eps 1e-5) with a per-style scale (its linear's first half plus
  1) and shift.
* The networks are built for one resolution (the JAX modules' parameters
  materialize for the step they are initialised at): `StyledGenerator(size)`
  runs every block up to step log2(size) - 2, the discriminator's
  `default_step` the same. Both also hold the one-step-lower RGB layer that
  a fade-in (alpha in [0, 1)) blends in, as the JAX modules do.
* Images and noise are NHWC at the interfaces ((B, H, W, 3), (B, H, W, 1));
  the networks run NCHW inside. StyleGAN1 reaches no fused kernel: its
  blur, resampling and AdaIN are plain torch ops, as they are plain XLA ops
  in the JAX package.
* Parameter names follow the JAX modules (`style_layers.<i>`,
  `generator.progression.<i>.{input, conv1, conv1_fused, noise1, adain1,
  conv2, noise2, adain2}`, `generator.to_rgb.<i>`; the discriminator's
  `from_rgb.<i>`, `blocks.<i>.conv1/conv2`, `final_conv1`, `final_conv2`,
  `linear`); `utils/checkpoint.stylegan1_*_params_from_jax` carry the JAX
  parameters across.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BLUR_KERNEL = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16.0

PROGRESSION_CHANNELS = [(512, 512), (512, 512), (512, 512), (512, 512), (512, 256),
                        (256, 128), (128, 64), (64, 32), (32, 16)]
DOWN_CHANNELS = [(16, 32), (32, 64), (64, 128), (128, 256), (256, 512), (512, 512),
                 (512, 512), (512, 512)]


def _equal_scale(fan_in: int) -> float:
    return math.sqrt(2.0 / fan_in)


class EqualLinear(nn.Module):
    """Linear with runtime sqrt(2 / in) scaling; weight (out, in)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.scale = _equal_scale(in_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ (self.weight * self.scale).t() + self.bias


class EqualConv(nn.Module):
    """Conv with runtime sqrt(2 / fan_in) scaling; weight (out, in, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = _equal_scale(in_channels * kernel_size**2)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.scale, self.bias, padding=self.padding)


def blur_3x3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise binomial blur of an NCHW tensor."""
    c = x.shape[1]
    kernel = BLUR_KERNEL.to(x.device, x.dtype)[None, None].expand(c, 1, 3, 3)
    return F.conv2d(x, kernel, padding=1, groups=c)


def _fused_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Pad the kernel's spatial axes (the last two) by one and average its
    four shifted copies."""
    padded = F.pad(weight, (1, 1, 1, 1))
    return (padded[..., 1:, 1:] + padded[..., :-1, 1:] + padded[..., 1:, :-1]
            + padded[..., :-1, :-1]) / 4.0


class FusedUpsample(nn.Module):
    """Stride-2 transposed conv with the fused kernel; weight (in, out, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = _equal_scale(in_channels * kernel_size**2)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = _fused_kernel(self.weight * self.scale)
        return F.conv_transpose2d(x, kernel, self.bias, stride=2, padding=self.padding)


class FusedDownsample(nn.Module):
    """Stride-2 conv with the fused kernel; weight (out, in, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = _equal_scale(in_channels * kernel_size**2)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = _fused_kernel(self.weight * self.scale)
        return F.conv2d(x, kernel, self.bias, stride=2, padding=self.padding)


class AdaptiveInstanceNorm(nn.Module):
    """Instance norm, then gamma * x + beta from the style (gamma = the
    first half of the style linear plus 1)."""

    def __init__(self, channels: int, style_dim: int):
        super().__init__()
        self.style = EqualLinear(style_dim, 2 * channels)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.style(style).chunk(2, dim=-1)
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        normed = (x - mean) * torch.rsqrt(var + 1e-5)
        return (gamma + 1.0)[:, :, None, None] * normed + beta[:, :, None, None]


class NoiseInjection(nn.Module):
    """x + weight * sqrt(2 / C) * noise; weight (1, C, 1, 1), zeros at init."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.scale = _equal_scale(channels)

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return x + self.weight * self.scale * noise


class StyledConvBlock(nn.Module):
    """[const | conv | upsample conv + blur] -> noise -> LeakyReLU -> AdaIN,
    then conv -> noise -> LeakyReLU -> AdaIN."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 kernel_size: int = 3, padding: int = 1, initial: bool = False,
                 upsample: bool = False, fused: bool = False):
        super().__init__()
        self.initial, self.upsample, self.fused = initial, upsample, fused
        if initial:
            self.input = nn.Parameter(torch.empty(1, in_channels, 4, 4))
        elif upsample and fused:
            self.conv1_fused = FusedUpsample(in_channels, out_channels, kernel_size, padding)
        else:
            self.conv1 = EqualConv(in_channels, out_channels, kernel_size, padding)
        # the initial block's first noise and AdaIN see the constant's width
        c1 = in_channels if initial else out_channels
        self.noise1 = NoiseInjection(c1)
        self.adain1 = AdaptiveInstanceNorm(c1, style_dim)
        self.conv2 = EqualConv(c1, out_channels, kernel_size, padding)
        self.noise2 = NoiseInjection(out_channels)
        self.adain2 = AdaptiveInstanceNorm(out_channels, style_dim)

    def forward(self, x: torch.Tensor, styles: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if self.initial:
            out = self.input.expand(x.shape[0], -1, -1, -1).to(styles.dtype)
        elif self.upsample and self.fused:
            out = blur_3x3(self.conv1_fused(x))
        elif self.upsample:
            out = blur_3x3(self.conv1(F.interpolate(x, scale_factor=2, mode="nearest")))
        else:
            out = self.conv1(x)
        out = F.leaky_relu(self.noise1(out, noise), 0.2)
        out = self.adain1(out, styles[:, 0])
        out = F.leaky_relu(self.noise2(self.conv2(out), noise), 0.2)
        return self.adain2(out, styles[:, 1])


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ProgressiveGenerator(nn.Module):
    """The synthesis blocks up to `step`, their RGB layer and the one below
    it (the fade-in's skip)."""

    def __init__(self, code_dim: int = 512, step: int = 6, fused: bool = True):
        super().__init__()
        self.step = step
        self.progression = nn.ModuleList(
            StyledConvBlock(in_ch, out_ch, code_dim, 3, 1, initial=i == 0, upsample=i > 0,
                            fused=fused and i >= 5)
            for i, (in_ch, out_ch) in enumerate(PROGRESSION_CHANNELS[:step + 1]))
        rgb = {str(step): EqualConv(PROGRESSION_CHANNELS[step][1], 3, 1)}
        if step > 0:
            rgb[str(step - 1)] = EqualConv(PROGRESSION_CHANNELS[step - 1][1], 3, 1)
        self.to_rgb = nn.ModuleDict(rgb)

    @staticmethod
    def get_channels() -> Dict[int, int]:
        return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32,
                1024: 16}

    def forward(self, style: Sequence[torch.Tensor], noise: Sequence[torch.Tensor],
                alpha: float = -1.0, return_intermediate_activations: bool = False):
        """style: one (B, D) or (B, n_latent, D) tensor in a list; noise: one
        NHWC map per block. Returns (image (B, H, W, 3), {block: (B, H, W,
        C)} or None)."""
        if len(style) != 1:
            raise ValueError("For projecting only one style code is allowed, mixing has "
                             "to be done earlier")
        style = style[0]
        step = self.step
        if style.ndim != 3:
            style = style[:, None, :].expand(-1, (step + 1) * 2, -1)
        acts: Optional[Dict[int, torch.Tensor]] = {} if return_intermediate_activations else None
        out = _nchw(noise[0])
        out_prev = out
        for i, block in enumerate(self.progression):
            if i > 0 and step > 0:
                out_prev = out
            out = block(out, style[:, 2 * i:2 * i + 2], _nchw(noise[i]))
            if acts is not None:
                acts[i] = _nhwc(out.detach())
        image = self.to_rgb[str(step)](out)
        if step > 0 and 0 <= alpha < 1:
            skip = F.interpolate(self.to_rgb[str(step - 1)](out_prev), scale_factor=2,
                                 mode="nearest")
            image = (1 - alpha) * skip + alpha * image
        return _nhwc(image), acts


class StyledGenerator(nn.Module):
    """The mapping MLP (pixel norm, n_mlp x (EqualLinear, LeakyReLU 0.2))
    and the progressive generator at `size`.

    Parameters are left uninitialized: call `init_weights(generator)` or
    load a state dict."""

    def __init__(self, size: int, code_dim: int = 512, n_mlp: int = 8):
        super().__init__()
        self.size = size
        self.code_dim = self.style_dim = code_dim
        self.step = int(math.log2(size)) - 2
        self.n_latent = (self.step + 1) * 2
        self.style_layers = nn.ModuleList(EqualLinear(code_dim, code_dim) for _ in range(n_mlp))
        self.generator = ProgressiveGenerator(code_dim, self.step)

    def noise_shapes(self) -> List[Tuple[int, int, int, int]]:
        return [(1, 4 * 2**i, 4 * 2**i, 1) for i in range(self.step + 1)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "StyledGenerator":
        """The JAX package's init drawn from `generator`: weights and the
        constant input N(0, 1), biases and noise weights 0."""
        for name, p in self.named_parameters():
            if name.endswith("bias") or ".noise" in name:
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator))
        return self

    def style(self, z: torch.Tensor) -> torch.Tensor:
        out = z * torch.rsqrt(z.square().mean(dim=-1, keepdim=True) + 1e-8)
        for layer in self.style_layers:
            out = F.leaky_relu(layer(out), 0.2)
        return out


    def mean_style(self, z: torch.Tensor) -> torch.Tensor:
        return self.style(z).mean(dim=0, keepdim=True)

    def forward(self, input: Sequence[torch.Tensor],
                noise: Optional[Sequence[torch.Tensor]] = None, alpha: float = 1.0,
                input_is_latent: bool = False, return_intermediate_activations: bool = False,
                step: Optional[int] = None, randomize_noise: bool = True,
                generator: Optional[torch.Generator] = None):
        """`randomize_noise` is accepted for the StyleGAN2 decoder's call
        signature: StyleGAN1 keeps no noise buffers, so noise=None always
        draws fresh maps (from `generator`)."""
        del randomize_noise
        if step is not None and step != self.step:
            raise ValueError(f"this generator is built for step {self.step}, not {step}")
        styles = list(input) if input_is_latent else [self.style(t) for t in input]
        if noise is None:
            batch, device = styles[0].shape[0], styles[0].device
            noise = [torch.randn((batch,) + s[1:], generator=generator, device=device)
                     for s in self.noise_shapes()]
        return self.generator(styles, noise, alpha,
                              return_intermediate_activations=return_intermediate_activations)


class _DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, fused: bool):
        super().__init__()
        self.fused = fused
        self.conv1 = EqualConv(in_channels, out_channels, 3, 1)
        self.conv2 = (FusedDownsample if fused else EqualConv)(out_channels, out_channels, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = blur_3x3(F.leaky_relu(self.conv1(x), 0.2))
        out = self.conv2(out)
        if not self.fused:
            out = F.avg_pool2d(out, 2)
        return F.leaky_relu(out, 0.2)


class ProgressiveDiscriminator(nn.Module):
    """The StyleGAN1 discriminator for images at step `default_step`
    (log2(size) - 2): from_rgb, the down blocks, minibatch stddev, two
    final convs and a linear -> (B, 1) logits.

    Parameters are left uninitialized: call `init_weights(generator)` or
    load a state dict."""

    def __init__(self, fused: bool = True, from_rgb_activate: bool = False,
                 default_step: int = 0):
        super().__init__()
        self.step = step = default_step
        self.from_rgb_activate = from_rgb_activate
        n_layer = len(DOWN_CHANNELS) + 1
        self.first = first = n_layer - step - 1
        rgb = {str(first): EqualConv(3, DOWN_CHANNELS[first][0] if first < len(DOWN_CHANNELS)
                                     else 512, 1)}
        if step > 0:
            rgb[str(first + 1)] = EqualConv(3, DOWN_CHANNELS[first][1], 1)
        self.from_rgb = nn.ModuleDict(rgb)
        self.blocks = nn.ModuleDict({
            str(index): _DownBlock(*DOWN_CHANNELS[index], fused=fused and index < 4)
            for index in range(first, len(DOWN_CHANNELS))})
        self.final_conv1 = EqualConv(513, 512, 3, 1)
        self.final_conv2 = EqualConv(512, 512, 4, 0)
        self.linear = EqualLinear(512, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ProgressiveDiscriminator":
        """Weights N(0, 1), biases 0 (the JAX package's init)."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator))
        return self

    def forward(self, x: torch.Tensor, alpha: float = -1.0) -> torch.Tensor:
        x = _nchw(x)
        out = self.from_rgb[str(self.first)](x)
        if self.from_rgb_activate:
            out = F.leaky_relu(out, 0.2)
        for index in range(self.first, len(DOWN_CHANNELS)):
            out = self.blocks[str(index)](out)
            if index == self.first and self.step > 0 and 0 <= alpha < 1:
                skip = self.from_rgb[str(index + 1)](F.avg_pool2d(x, 2))
                out = (1 - alpha) * skip + alpha * out
        std = torch.sqrt(out.var(dim=0, unbiased=False) + 1e-8)
        stat = std.mean().expand(out.shape[0], 1, out.shape[2], out.shape[3])
        out = torch.cat([out, stat], dim=1)
        out = F.leaky_relu(self.final_conv1(out), 0.2)
        out = F.leaky_relu(self.final_conv2(out), 0.2)
        return self.linear(out.flatten(1))
