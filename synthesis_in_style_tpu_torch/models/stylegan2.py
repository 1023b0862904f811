"""StyleGAN2 generator and discriminator in PyTorch (counterpart of
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
  buffers `noises.noise_i` (1, 1, H, W). The discriminator keeps the
  reference key layout too (`convs.0.*`, `convs.i.conv1/conv2/skip.*`,
  `final_conv.*`, `final_linear.{0,1}.*`, a ConvLayer being a Sequential of
  [Blur,] EqualConv2d [, activation]); its `final_linear.0` columns follow
  the reference's NCHW flatten, so the forward flattens NCHW.
* Every fused op is an autograd Function that runs its kernel on the card in
  both directions (ops/fused_act.py, ops/cuda/fused_blur.py), so training
  differentiates the same kernels, twice for R1 and path length.
* `quantized` (serving only, as in the JAX package): every modulated conv
  without an lhs dilation, i.e. each non-upsampling StyledConv's 3x3, runs
  as a w8a8 int8 convolution (ops/quant.py `conv2d_w8a8`, the int8 kernel on
  the card); demodulation statistics still come from the float weights, the
  upsampling convs and ToRGB stay float, and the upsampling StyledConvs take
  the unfused tail (upfirdn2d blur, demodulation, noise, bias-act kernel)
  instead of the fused blur kernel. The parameters are the same.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act
from synthesis_in_style_tpu_torch.ops.fused_act import fused_leaky_relu
from synthesis_in_style_tpu_torch.ops.quant import conv2d_w8a8
from synthesis_in_style_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d, upsample_2d
from synthesis_in_style_tpu_torch.parallel.distributed import all_gather_batch, local_batch_slice


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
                 style_dim: int, demodulate: bool = True, upsample: bool = False,
                 quantized: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.out_channel = out_channel
        self.demodulate = demodulate
        self.upsample = upsample
        # w8a8 int8 conv where there is no lhs dilation (not the upsampling one)
        self.quantized = quantized
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
        if self.quantized:
            out = conv2d_w8a8(x, w.permute(2, 3, 1, 0), padding=self.kernel_size // 2)
        else:
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
    """Bias + LeakyReLU * sqrt(2) (reference name `activate.bias` in a
    StyledConv, which applies it inside its own fused tail)."""

    def __init__(self, channel: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias.to(x.dtype))


class StyledConv(nn.Module):
    """ModulatedConv2d -> noise -> bias + LeakyReLU * sqrt(2).

    Upsampling: the transposed conv, then ONE fused-blur kernel pass for
    blur, demodulation, noise, bias and activation (`quantized`: the
    unfused tail, as the JAX package's `_fused_eligible` is False there).
    Otherwise: the conv (demodulated), the noise add, then the fused
    bias-act kernel."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), quantized: bool = False):
        super().__init__()
        if upsample and (kernel_size != 3 or len(blur_kernel) != 4):
            raise ValueError("the fused upsample tail takes a 3x3 conv and a 4-tap blur")
        self.upsample = upsample
        self.quantized = quantized
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size, style_dim,
                                    upsample=upsample, quantized=quantized and not upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)
        gain = 2.0  # per-axis sqrt(upsample factor ** 2)
        self.taps = tuple(gain * float(t) / sum(blur_kernel) for t in blur_kernel)
        self.register_buffer("blur", make_kernel(list(blur_kernel)) * gain**2,
                             persistent=False)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        out, demod = self.conv(x, style)
        bias = self.activate.bias.to(out.dtype)
        if self.upsample and not self.quantized:
            plane = self.noise.plane(noise, torch.float32)
            return blur_demod_noise_bias_act(out, demod, plane, bias, self.taps)
        if self.upsample:
            out = upfirdn2d(out, self.blur, pad=(1, 1))
            if demod is not None:
                out = out * demod[:, None, None, :].to(out.dtype)
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


@torch.no_grad()
def init_layer_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers for every equalized layer of `model`:
    linear weights N(0, 1/lr_mul), conv and modulated conv weights N(0, 1);
    biases keep their construction values."""
    for module in model.modules():
        if isinstance(module, EqualLinear):
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator)
                                / module.lr_mul)
        elif isinstance(module, (ModulatedConv2d, EqualConv2d)):
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator))


class Generator(nn.Module):
    """StyleGAN2 synthesis network.

    Parameters are left uninitialized by the constructor: call
    `init_weights(generator)` (a seeded torch.Generator) or load a state dict.
    """

    def __init__(self, size: int, style_dim: int, n_mlp: int,
                 channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), lr_mlp: float = 0.01,
                 quantized: bool = False):
        super().__init__()
        self.size = size
        self.quantized = quantized
        self.style_dim = style_dim
        self.log_size = self._log_size(size)
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
        self.conv1 = StyledConv(channels[4], channels[4], 3, style_dim, blur_kernel=blur_kernel,
                                quantized=quantized)
        self.to_rgb1 = self._to_rgb(channels[4], style_dim)

        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channel = channels[4]
        for res_log in range(3, self.log_size + 1):
            out_channel = channels[2**res_log]
            self.convs.append(StyledConv(in_channel, out_channel, 3, style_dim,
                                         upsample=True, blur_kernel=blur_kernel,
                                         quantized=quantized))
            self.convs.append(StyledConv(out_channel, out_channel, 3, style_dim,
                                         blur_kernel=blur_kernel, quantized=quantized))
            self.to_rgbs.append(self._to_rgb(out_channel, style_dim))
            in_channel = out_channel

        shapes = []
        for layer_idx in range(self.num_layers):
            res = 2 ** ((layer_idx + 5) // 2)
            shapes.append((res, res))
        self.noises = NoiseBuffers(shapes)

    @staticmethod
    def _log_size(size: int) -> int:
        """log2 of the resolution the synthesis pyramid ends at."""
        return int(math.log2(size))

    @staticmethod
    def _to_rgb(in_channel: int, style_dim: int) -> nn.Module:
        return ToRGB(in_channel, style_dim)

    @staticmethod
    def _image(skip: torch.Tensor) -> torch.Tensor:
        """The image from the last ToRGB's accumulated skip."""
        return skip

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Generator":
        """Random init drawn from `generator` (the JAX package's initializers:
        linear weights N(0, 1/lr_mul), conv weights and input N(0, 1),
        modulation bias 1, other biases and noise weights 0, noise buffers
        N(0, 1))."""
        init_layer_weights(self, generator)
        self.input.input.copy_(torch.randn(self.input.input.shape, generator=generator))
        for i in range(self.noises.num):
            buf = getattr(self.noises, f"noise_{i}")
            buf.copy_(torch.randn(buf.shape, generator=generator))
        return self

    def noise_shapes(self) -> List[Tuple[int, int, int, int]]:
        """Per-layer noise shapes, NHWC: (1, H, W, 1)."""
        return [(1,) + tuple(buf.shape[2:]) + (1,)
                for buf in (getattr(self.noises, f"noise_{i}") for i in range(self.noises.num))]

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
        input_is_latent: bool = False,
        noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        return_latents: bool = False,
    ):
        """styles: list of one or two (B, style_dim) z, or with
        `input_is_latent` mapped w: (B, style_dim) each, or one (B, n_latent,
        style_dim) per-layer latent. `noise`: per layer, a (B or 1, H, W, 1)
        tensor to use or None to draw; without it, every layer draws when
        `randomize_noise` and uses its stored buffer otherwise. `generator`
        is the torch.Generator for the random draws (the mixing index when
        two styles come without `inject_index`, and the noise), on the
        latent's device. Returns (image (B, H, W, 3), the (B, n_latent,
        style_dim) latent with `return_latents`, else the {0..num_layers: (B,
        H, W, C)} activations or None)."""
        if not input_is_latent:
            styles = [self.get_latent(s) for s in styles]
        if truncation < 1:
            if truncation_latent is None:
                raise ValueError("truncation < 1 needs a truncation_latent")
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]

        n_latent = self.n_latent
        if len(styles) < 2:
            latent = styles[0]
            if latent.ndim == 2:
                latent = latent[:, None, :].expand(-1, n_latent, -1)
        else:
            if inject_index is None:
                inject_index = int(torch.randint(1, n_latent, (1,), generator=generator,
                                                 device=styles[0].device))
            pos = torch.arange(n_latent, device=styles[0].device)[None, :, None]
            latent = torch.where(pos < inject_index, styles[0][:, None, :], styles[1][:, None, :])

        batch = latent.shape[0]
        device = latent.device
        buffers = self.noises.nhwc()
        if noise is None:
            noise = [None] * len(buffers) if randomize_noise else buffers
        noise = [
            torch.randn((batch,) + tuple(buf.shape[1:]), generator=generator, device=device)
            if n is None else n
            for n, buf in zip(noise, buffers)
        ]

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

        image = self._image(skip)
        if return_latents:
            return image, latent
        return image, acts


# ---------------------------------------------------------------------------
# discriminator


class EqualConv2d(nn.Module):
    """Conv without bias, with runtime equalized-lr scaling, on NHWC tensors;
    weight in the reference layout (out, in, kh, kw). (Every discriminator
    conv puts its bias in the activation after it, or has none.)"""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channel, in_channel, kernel_size, kernel_size))
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(_nchw(x), (self.weight * self.scale).to(x.dtype),
                       stride=self.stride, padding=self.padding)
        return _nhwc(out)


class Blur(nn.Module):
    """FIR blur before a stride-2 conv (no parameters)."""

    def __init__(self, kernel: Sequence[int], pad: Tuple[int, int]):
        super().__init__()
        self.register_buffer("kernel", make_kernel(list(kernel)), persistent=False)
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d(x, self.kernel, pad=self.pad)


class ConvLayer(nn.Sequential):
    """[blur,] EqualConv2d [, bias + LeakyReLU]: the reference Sequential,
    so its keys are `<i>.weight` / `<i>.bias`."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 downsample: bool = False, blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 activate: bool = True):
        layers: List[nn.Module] = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size, stride=stride,
                                  padding=padding))
        if activate:
            layers.append(FusedLeakyReLU(out_channel))
        super().__init__(*layers)


class ResBlock(nn.Module):
    """Residual downsampling block with the 1/sqrt(2) merge."""

    def __init__(self, in_channel: int, out_channel: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True,
                               blur_kernel=blur_kernel)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True, activate=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, num_features: int = 1) -> torch.Tensor:
    """Append the minibatch-stddev channel to an NHWC tensor: per group of
    `group_size` samples, the biased standard deviation over the group,
    averaged over H, W and the channels of each feature, in float32. The
    groups are strided over the global batch, as in the JAX package's
    sharded step: in a launched multi-process run the statistic is taken
    over every process's rows (a differentiable all-gather) and this
    process keeps its own."""
    local_b, h, w, c = x.shape
    full = all_gather_batch(x)
    b = full.shape[0]
    group = min(b, group_size)
    y = full.reshape(group, -1, h, w, num_features, c // num_features).float()
    std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)
    mean_std = std.mean(dim=(1, 2, 4)).repeat(group, 1)  # (B, num_features)
    if b != local_b:
        mean_std = mean_std[local_batch_slice(b)]
    stat = mean_std[:, None, None, :].expand(local_b, h, w, num_features).to(x.dtype)
    return torch.cat([x, stat], dim=-1)


class Discriminator(nn.Module):
    """StyleGAN2 discriminator on NHWC images, logits (B, 1).

    Parameters are left uninitialized: call `init_weights(generator)` or
    load a state dict."""

    def __init__(self, size: int, channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), input_channels: int = 3):
        super().__init__()
        channels = generator_channels(channel_multiplier)
        convs: List[nn.Module] = [ConvLayer(input_channels, channels[size], 1)]
        in_channel = channels[size]
        for i in range(int(math.log2(size)), 2, -1):
            out_channel = channels[2 ** (i - 1)]
            convs.append(ResBlock(in_channel, out_channel, blur_kernel))
            in_channel = out_channel
        self.convs = nn.Sequential(*convs)
        self.final_conv = ConvLayer(in_channel + 1, channels[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 4 * 4, channels[4], activation=True),
            EqualLinear(channels[4], 1),
        )

    def init_weights(self, generator: torch.Generator) -> "Discriminator":
        """Random init drawn from `generator` (the JAX package's
        initializers: weights N(0, 1), biases 0)."""
        init_layer_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.convs(x)
        out = minibatch_stddev(out, group_size=4, num_features=1)
        out = self.final_conv(out)
        # the reference flattens NCHW: its final_linear.0 columns are (c, y, x)
        out = out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)
        return self.final_linear(out)
