"""PSNR and SSIM (counterpart of synthesis_in_style_tpu/evaluation/psnr_ssim.py).

Images are NHWC, in [-1, 1] or [0, 1]: a tensor whose own minimum is below
0 is taken to be in [-1, 1] and mapped to [0, 1] first. SSIM is the
gaussian-window SSIM of kornia and skimage (window 5, sigma 1.5, VALID, C1
= (0.01 max)^2, C2 = (0.03 max)^2), its filters one depthwise convolution.
Nothing here syncs with the host: the rescale decision stays a device
tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def clamp_and_unnormalize(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return ((image + 1.0) / 2.0).clamp(0.0, 1.0)


def _maybe_unnormalize(image: torch.Tensor) -> torch.Tensor:
    return torch.where(image.min() < 0, clamp_and_unnormalize(image), image)


def psnr(image: torch.Tensor, target: torch.Tensor, max_value: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole tensor (a 0-d tensor)."""
    image = _maybe_unnormalize(image.float())
    target = _maybe_unnormalize(target.float())
    mse = (image - target).square().mean()
    return 10.0 * torch.log10(max_value**2 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int, sigma: float, device, dtype=torch.float32) -> torch.Tensor:
    coords = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-coords.square() / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(image: torch.Tensor, target: torch.Tensor, kernel_size: int = 5, sigma: float = 1.5,
         max_value: float = 1.0) -> torch.Tensor:
    """Mean structural similarity (a 0-d tensor) of two NHWC tensors,
    computed in float32 as the JAX package computes it, or in float64 where
    an input is float64 (the variances E[x^2] - E[x]^2 cancel on flat
    images, where float32 alone moves the mean by ~1e-5)."""
    dtype = torch.promote_types(torch.promote_types(image.dtype, target.dtype), torch.float32)
    image = _maybe_unnormalize(image.to(dtype)).permute(0, 3, 1, 2)
    target = _maybe_unnormalize(target.to(dtype)).permute(0, 3, 1, 2)
    c = image.shape[1]
    kernel = _gaussian_kernel(kernel_size, sigma, image.device, dtype)
    kernel = kernel.expand(c, 1, kernel_size, kernel_size)

    def filt(x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, kernel, groups=c)

    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    mu_x, mu_y = filt(image), filt(target)
    sigma_x = filt(image * image) - mu_x * mu_x
    sigma_y = filt(target * target) - mu_y * mu_y
    sigma_xy = filt(image * target) - mu_x * mu_y
    numerator = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    denominator = (mu_x.square() + mu_y.square() + c1) * (sigma_x + sigma_y + c2)
    return (numerator / denominator).mean()


class PSNRSSIMEvaluator:
    """PSNR and SSIM of one image at a time (a batch of one, asserted)."""

    def __init__(self, max_value: float = 1.0, ssim_kernel_size: int = 5):
        self.max_value = max_value
        self.ssim_kernel_size = ssim_kernel_size

    def psnr(self, image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        assert len(image) == 1, (
            "Batch size of images must be one in order to get a meaningful psnr result")
        return psnr(image, target, self.max_value)

    def ssim(self, image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        assert len(image) == 1, (
            "Batch size of images must be one in order to get a meaningful ssim result")
        return ssim(image, target, self.ssim_kernel_size, max_value=self.max_value)

    def psnr_and_ssim(self, image: torch.Tensor, target: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.psnr(image, target), self.ssim(image, target)
