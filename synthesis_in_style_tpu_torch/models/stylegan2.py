"""StyleGAN2 generator in PyTorch (counterpart of the generator side of
synthesis_in_style_tpu/models/stylegan2.py).

* Activations are NHWC tensors ((B, H, W, C), C contiguous): the layout of
  the JAX package's outputs, and the layout the epilogue kernels take. A
  convolution sees them as NCHW tensors with channels-last strides (a
  permuted view, no copy).
* ModulatedConv2d uses the JAX package's scale-input / demodulate-output
  form: conv(x * s, w) * d, with a weight shared by the batch.
* Every upsampling StyledConv ends in the fused blur kernel
  (ops/cuda/fused_blur.py): blur + demodulation + noise + bias + LeakyReLU
  in one pass over the logical (B, 2h+1, 2h+1, C) transposed-conv output.
  Every other StyledConv and every activated EqualLinear ends in the fused
  bias-act kernel (ops/fused_act.py).
* Parameter names and layouts are those of the reference StyleGAN2 state
  dict (the layout utils/checkpoint.py of the JAX package exports with
  `flax_generator_to_torch`): linear weight (out, in), modulated conv weight
  (1, out, in, kh, kw), input (1, C, 4, 4), ToRGB bias (1, 3, 1, 1), noise
  buffers `noises.noise_i` (1, 1, H, W).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act
from synthesis_in_style_tpu_torch.ops.fused_act import fused_leaky_relu
from synthesis_in_style_tpu_torch.ops.upfirdn2d import make_kernel, upsample_2d


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalize each latent vector to unit RMS (channel axis last)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view with channels-last strides."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW conv output -> contiguous NHWC (free when channels-last)."""
    return x.permute(0, 2, 3, 1).contiguous()


class EqualLinear(nn.Module):
    """Linear layer with runtime equalized-lr scaling; weight (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ (self.weight * self.scale).t().to(x.dtype)
        bias = (self.bias * self.lr_mul).to(x.dtype)
        if self.activation:
            return fused_leaky_relu(out, bias)
        return out + bias


class ModulatedConv2d(nn.Module):
    """Style-modulated conv, scale-input / demodulate-output form.

    forward returns (out, demod). For an upsampling conv `out` is the
    transposed-conv output (B, 2h+1, 2h+1, C) before blur and demodulation
    (the caller's fused tail applies both); otherwise it is the finished,
    demodulated (B, H, W, C) output."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True, upsample: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.out_channel = out_channel
        self.demodulate = demodulate
        self.upsample = upsample
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.weight = nn.Parameter(torch.empty(1, out_channel, in_channel, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)

    def forward(self, x: torch.Tensor, style: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        w = self.weight[0] * self.scale  # (out, in, kh, kw), shared by the batch
        s = self.modulation(style)  # (B, in)
        demod = None
        if self.demodulate:
            w_sq = (w.float() ** 2).sum(dim=(2, 3))  # (out, in)
            demod = torch.rsqrt((s.float() ** 2) @ w_sq.t() + 1e-8)  # (B, out)
        x = x * s[:, None, None, :].to(x.dtype)
        w = w.to(x.dtype)
        if self.upsample:
            # dilated conv with the flipped kernel (JAX form) ==
            # conv_transpose2d(stride 2) with the unflipped (in, out, kh, kw) weight
            out = F.conv_transpose2d(_nchw(x), w.transpose(0, 1), stride=2)
            return _nhwc(out), demod
        out = _nhwc(F.conv2d(_nchw(x), w, padding=self.kernel_size // 2))
        if demod is not None:
            out = out * demod[:, None, None, :].to(out.dtype)
        return out, demod


class NoiseInjection(nn.Module):
    """Learned-scale spatial noise; the scaled plane is weight * noise."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def plane(self, noise: torch.Tensor, dtype) -> torch.Tensor:
        """(B or 1, H, W) scaled noise plane from a (B or 1, H, W, 1) noise."""
        return (self.weight.to(dtype) * noise.to(dtype))[..., 0]


class FusedLeakyReLU(nn.Module):
    """Holds the StyledConv bias (reference name `activate.bias`)."""

    def __init__(self, channel: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))


class StyledConv(nn.Module):
    """ModulatedConv2d -> noise -> bias + LeakyReLU * sqrt(2).

    Upsampling: the transposed conv, then ONE fused-blur kernel pass for
    blur, demodulation, noise, bias and activation. Otherwise: the conv
    (demodulated), the noise add, then the fused bias-act kernel."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        if upsample and (kernel_size != 3 or len(blur_kernel) != 4):
            raise ValueError("the fused upsample tail takes a 3x3 conv and a 4-tap blur")
        self.upsample = upsample
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size, style_dim,
                                    upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)
        gain = 2.0  # per-axis sqrt(upsample factor ** 2)
        self.taps = tuple(gain * float(t) / sum(blur_kernel) for t in blur_kernel)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        out, demod = self.conv(x, style)
        bias = self.activate.bias.to(out.dtype)
        if self.upsample:
            plane = self.noise.plane(noise, torch.float32)
            return blur_demod_noise_bias_act(out, demod, plane, bias, self.taps)
        out = out + self.noise.weight.to(out.dtype) * noise.to(out.dtype)
        return fused_leaky_relu(out, bias)


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB with skip accumulation."""

    def __init__(self, in_channel: int, style_dim: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), out_channels: int = 3):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channels, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, out_channels, 1, 1))
        self.register_buffer("blur", make_kernel(list(blur_kernel)), persistent=False)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out, _ = self.conv(x, style)
        out = out + self.bias.reshape(-1).to(out.dtype)
        if skip is not None:
            out = out + upsample_2d(skip, self.blur, 2)
        return out


def generator_channels(channel_multiplier: int = 2) -> Dict[int, int]:
    """Per-resolution channel widths."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


class NoiseBuffers(nn.Module):
    """Per-layer fixed noise buffers `noise_i` of shape (1, 1, H, W)."""

    def __init__(self, shapes: Sequence[Tuple[int, int]]):
        super().__init__()
        self.num = len(shapes)
        for i, (h, w) in enumerate(shapes):
            self.register_buffer(f"noise_{i}", torch.zeros(1, 1, h, w))

    def nhwc(self) -> List[torch.Tensor]:
        return [getattr(self, f"noise_{i}").permute(0, 2, 3, 1) for i in range(self.num)]


class Generator(nn.Module):
    """StyleGAN2 synthesis network.

    Parameters are left uninitialized by the constructor: call
    `init_weights(generator)` (a seeded torch.Generator) or load a state dict.
    """

    def __init__(self, size: int, style_dim: int, n_mlp: int,
                 channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), lr_mlp: float = 0.01):
        super().__init__()
        self.size = size
        self.style_dim = style_dim
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2
        channels = generator_channels(channel_multiplier)
        self.channels = channels

        self.style = nn.Sequential(
            PixelNorm(),
            *[EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation=True)
              for _ in range(n_mlp)],
        )
        self.input = nn.Module()
        self.input.input = nn.Parameter(torch.empty(1, channels[4], 4, 4))
        self.conv1 = StyledConv(channels[4], channels[4], 3, style_dim, blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(channels[4], style_dim)

        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channel = channels[4]
        for res_log in range(3, self.log_size + 1):
            out_channel = channels[2**res_log]
            self.convs.append(StyledConv(in_channel, out_channel, 3, style_dim,
                                         upsample=True, blur_kernel=blur_kernel))
            self.convs.append(StyledConv(out_channel, out_channel, 3, style_dim,
                                         blur_kernel=blur_kernel))
            self.to_rgbs.append(ToRGB(out_channel, style_dim))
            in_channel = out_channel

        shapes = []
        for layer_idx in range(self.num_layers):
            res = 2 ** ((layer_idx + 5) // 2)
            shapes.append((res, res))
        self.noises = NoiseBuffers(shapes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Generator":
        """Random init drawn from `generator` (the JAX package's initializers:
        linear weights N(0, 1/lr_mul), conv weights and input N(0, 1),
        modulation bias 1, other biases and noise weights 0, noise buffers
        N(0, 1))."""
        for module in self.modules():
            if isinstance(module, EqualLinear):
                w = torch.randn(module.weight.shape, generator=generator) / module.lr_mul
                module.weight.copy_(w)
            elif isinstance(module, ModulatedConv2d):
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator))
        self.input.input.copy_(torch.randn(self.input.input.shape, generator=generator))
        for i in range(self.noises.num):
            buf = getattr(self.noises, f"noise_{i}")
            buf.copy_(torch.randn(buf.shape, generator=generator))
        return self

    def get_latent(self, z: torch.Tensor) -> torch.Tensor:
        """Map z -> w."""
        return self.style(z)

    @torch.no_grad()
    def mean_latent(self, n_latent: int, generator: torch.Generator) -> torch.Tensor:
        """Average mapped latent (1, style_dim) over n_latent draws of z."""
        z = torch.randn((n_latent, self.style_dim), generator=generator).to(
            self.input.input.device
        )
        return self.get_latent(z).mean(dim=0, keepdim=True)

    def forward(
        self,
        styles: Sequence[torch.Tensor],
        inject_index: Optional[int] = None,
        truncation: float = 1.0,
        truncation_latent: Optional[torch.Tensor] = None,
        randomize_noise: bool = True,
        return_intermediate_activations: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """styles: list of one or two (B, style_dim) z. Returns (image (B, H,
        W, 3), {0..num_layers: (B, H, W, C)} activations or None). `generator` is the torch.Generator for the
        random draws: the mixing index when two styles come without
        `inject_index`, and the noise when `randomize_noise`."""
        styles = [self.get_latent(s) for s in styles]
        if truncation < 1:
            if truncation_latent is None:
                raise ValueError("truncation < 1 needs a truncation_latent")
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]

        n_latent = self.n_latent
        if len(styles) < 2:
            latent = styles[0][:, None, :].expand(-1, n_latent, -1)
        else:
            if inject_index is None:
                inject_index = int(torch.randint(1, n_latent, (1,), generator=generator))
            pos = torch.arange(n_latent, device=styles[0].device)[None, :, None]
            latent = torch.where(pos < inject_index, styles[0][:, None, :], styles[1][:, None, :])

        batch = latent.shape[0]
        device = latent.device
        if randomize_noise:
            noise = [torch.randn((batch,) + tuple(buf.shape[1:]), generator=generator).to(device)
                     for buf in self.noises.nhwc()]
        else:
            noise = self.noises.nhwc()

        acts: Optional[Dict[int, torch.Tensor]] = (
            {} if return_intermediate_activations else None
        )
        out = self.input.input.permute(0, 2, 3, 1).expand(batch, -1, -1, -1).to(latent.dtype)
        out = out.contiguous()
        if acts is not None:
            acts[0] = out
        out = self.conv1(out, latent[:, 0], noise[0])
        if acts is not None:
            acts[1] = out
        skip = self.to_rgb1(out, latent[:, 1])

        i = 1
        for conv1, conv2, noise1, noise2, to_rgb in zip(
            self.convs[::2], self.convs[1::2], noise[1::2], noise[2::2], self.to_rgbs
        ):
            out = conv1(out, latent[:, i], noise1)
            if acts is not None:
                acts[i + 1] = out
            out = conv2(out, latent[:, i + 1], noise2)
            if acts is not None:
                acts[i + 2] = out
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2

        return skip, acts
