"""SWAGAN, the wavelet-domain StyleGAN2, in PyTorch (counterpart of
synthesis_in_style_tpu/models/swagan.py).

* NHWC tensors; a wavelet image holds its four sub-bands as channel chunks
  `[ll | lh | hl | hh]` on the last axis.
* `haar_transform` / `inverse_haar_transform` are the JAX package's
  upfirdn2d forms with the 2x2 Haar kernels of `haar_wavelet_kernels` (note
  the inverse's sign flip of lh and hl and its pad (1, 0, 1, 0)), written
  out as the sums and differences of each 2x2 block they reduce to: no
  convolution, and every order of derivative is PyTorch's own.
* The synthesis pyramid runs one octave below the image (`log_size =
  log2(size) - 1`): at 256px the last StyledConvs are 128x128, each ToRGB
  emits 12 wavelet channels and carries the skip through iwt -> upsample ->
  dwt, and the image is one inverse transform of the last skip. The
  StyledConvs are StyleGAN2's (models/stylegan2.py), so their fused blur
  tail and bias-act kernels run at SWAGAN's shapes on the card.
* `return_intermediate_activations` returns {0..num_layers: (B, H, W, C)},
  in wavelet space (12 entries, 4x4 to 128x128, at 256px).
* Parameter names are the reference SWAGAN state dict's: the generator's
  are StyleGAN2's (its ToRGB bias is (1, 12, 1, 1)); the discriminator's are
  `from_rgbs.{i}.conv.*` (a 1x1 ConvLayer on the 12 wavelet channels),
  `convs.{i}.conv1/conv2.*`, `final_conv.*`, `final_linear.{0,1}.*`. The
  reference's fixed Haar and FIR buffers are not stored
  (utils/checkpoint.strip_blur_kernels drops them from a reference `.pt`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from synthesis_in_style_tpu_torch.models import stylegan2
from synthesis_in_style_tpu_torch.models.stylegan2 import (
    ConvLayer,
    EqualLinear,
    ToRGB,
    generator_channels,
    init_layer_weights,
    minibatch_stddev,
)
from synthesis_in_style_tpu_torch.ops.upfirdn2d import downsample_2d, make_kernel, upsample_2d


def haar_wavelet_kernels() -> Tuple[torch.Tensor, ...]:
    """The four 2x2 Haar analysis kernels, outer products of l = [1, 1] /
    sqrt(2) and h = [-1, 1] / sqrt(2), ordered (ll, lh, hl, hh); lh varies
    along y."""
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    low = torch.tensor([inv_sqrt2, inv_sqrt2])
    high = torch.tensor([-inv_sqrt2, inv_sqrt2])
    return (torch.outer(low, low), torch.outer(high, low), torch.outer(low, high),
            torch.outer(high, high))


def haar_transform(x: torch.Tensor) -> torch.Tensor:
    """Forward Haar DWT: (B, H, W, C) -> (B, H/2, W/2, 4C), [ll | lh | hl |
    hh]. Of each 2x2 block [[a, b], [c, d]]: ll = (a + b + c + d) / 2, lh =
    (a + b - c - d) / 2, hl = (a - b + c - d) / 2, hh = (a - b - c + d) / 2
    (upfirdn2d with each kernel of `haar_wavelet_kernels`, down 2)."""
    n, h, w, c = x.shape
    blocks = x.reshape(n, h // 2, 2, w // 2, 2, c)
    a, b = blocks[:, :, 0, :, 0], blocks[:, :, 0, :, 1]
    c_, d = blocks[:, :, 1, :, 0], blocks[:, :, 1, :, 1]
    return 0.5 * torch.cat([a + b + c_ + d, a + b - c_ - d, a - b + c_ - d, a - b - c_ + d],
                           dim=-1)


def inverse_haar_transform(x: torch.Tensor) -> torch.Tensor:
    """Inverse Haar DWT: (B, H, W, 4C) -> (B, 2H, 2W, C), the exact inverse
    of `haar_transform` (upfirdn2d of ll, -lh, -hl and hh with their kernels,
    up 2, pad (1, 0, 1, 0), summed)."""
    ll, lh, hl, hh = x.chunk(4, dim=-1)
    top = torch.stack([ll + lh + hl + hh, ll + lh - hl - hh], dim=3)
    bottom = torch.stack([ll - lh + hl - hh, ll - lh - hl + hh], dim=3)
    out = 0.5 * torch.stack([top, bottom], dim=2)  # (B, H, 2, W, 2, C)
    n, h, _, w, _, c = out.shape
    return out.reshape(n, 2 * h, 2 * w, c)


class WaveletToRGB(ToRGB):
    """1x1 modulated conv to 12 wavelet-RGB channels; the skip goes through
    iwt -> FIR upsample -> dwt before it is added."""

    def __init__(self, in_channel: int, style_dim: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__(in_channel, style_dim, blur_kernel, out_channels=12)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out, _ = self.conv(x, style)
        out = out + self.bias.reshape(-1).to(out.dtype)
        if skip is not None:
            skip = inverse_haar_transform(skip)
            skip = upsample_2d(skip, self.blur, 2)
            out = out + haar_transform(skip)
        return out


class Generator(stylegan2.Generator):
    """SWAGAN synthesis network: StyleGAN2's with the pyramid one octave
    shallower, wavelet ToRGBs and an inverse Haar transform at the end.
    n_latent = 2 log2(size) - 4 and num_layers = 2 log2(size) - 5 (12 and 11
    at 256px); the noise of layer i is 2 ** ((i + 5) // 2) pixels square.
    Parameters are left uninitialized: call `init_weights(generator)` or
    load a state dict."""

    @staticmethod
    def _log_size(size: int) -> int:
        return int(math.log2(size)) - 1

    @staticmethod
    def _to_rgb(in_channel: int, style_dim: int) -> nn.Module:
        return WaveletToRGB(in_channel, style_dim)

    @staticmethod
    def _image(skip: torch.Tensor) -> torch.Tensor:
        return inverse_haar_transform(skip)


class ConvBlock(nn.Module):
    """Two ConvLayers, the second downsampling."""

    def __init__(self, in_channel: int, out_channel: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True,
                               blur_kernel=blur_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class FromRGB(nn.Module):
    """Wavelet-pyramid input tap: optionally steps the wavelet image down one
    octave (iwt -> FIR downsample -> dwt), then a 1x1 ConvLayer into the
    trunk, added to `skip`. Returns (the wavelet image, trunk features)."""

    def __init__(self, out_channel: int, downsample: bool = True,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.downsample = downsample
        if downsample:
            self.register_buffer("blur", make_kernel(list(blur_kernel)), persistent=False)
        self.conv = ConvLayer(3 * 4, out_channel, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.downsample:
            x = haar_transform(downsample_2d(inverse_haar_transform(x), self.blur, 2))
        out = self.conv(x)
        if skip is not None:
            out = out + skip
        return x, out


class Discriminator(nn.Module):
    """SWAGAN discriminator on NHWC images, logits (B, 1): a DWT of the
    input, then per octave a FromRGB tap and a ConvBlock (the first tap's
    width is channels[size], as in the JAX package), a last tap at 4x4,
    minibatch stddev, final conv and two linears. Parameters are left
    uninitialized: call `init_weights(generator)` or load a state dict."""

    def __init__(self, size: int, channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        channels = generator_channels(channel_multiplier)
        log_size = int(math.log2(size)) - 1
        from_rgbs: List[nn.Module] = []
        convs: List[nn.Module] = []
        in_channel = channels[size]
        for i in range(log_size, 2, -1):
            out_channel = channels[2 ** (i - 1)]
            from_rgbs.append(FromRGB(in_channel, downsample=(i != log_size),
                                     blur_kernel=blur_kernel))
            convs.append(ConvBlock(in_channel, out_channel, blur_kernel))
            in_channel = out_channel
        from_rgbs.append(FromRGB(channels[4], blur_kernel=blur_kernel))
        self.from_rgbs = nn.ModuleList(from_rgbs)
        self.convs = nn.ModuleList(convs)
        self.final_conv = ConvLayer(in_channel + 1, channels[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 4 * 4, channels[4], activation=True),
            EqualLinear(channels[4], 1),
        )

    def init_weights(self, generator: torch.Generator) -> "Discriminator":
        """Random init drawn from `generator` (weights N(0, 1), biases 0)."""
        init_layer_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = haar_transform(x)
        out = None
        for from_rgb, conv in zip(self.from_rgbs, self.convs):
            x, out = from_rgb(x, out)
            out = conv(out)
        _, out = self.from_rgbs[-1](x, out)
        out = minibatch_stddev(out, group_size=4, num_features=1)
        out = self.final_conv(out)
        # the reference flattens NCHW: its final_linear.0 columns are (c, y, x)
        out = out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)
        return self.final_linear(out)
