"""Bilinear resizes: align_corners=True (the JAX package's
`resize_bilinear_align_corners`, models/ema_net.py), shared by the port's
segmenters (TransUNet's decoder upsamples and EMANet's logits), and
`jax.image.resize`'s "linear" method (`resize_linear`), for the
perceptual losses' masks and the super-resolution autoencoder."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True of an NCHW tensor (the JAX
    function in the port's layout); the tensor itself at its own size."""
    if tuple(x.shape[2:4]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def _linear_weights(in_size: int, out_size: int, device, dtype) -> torch.Tensor:
    """(in_size, out_size) interpolation matrix of `jax.image.resize`'s
    "linear" method (antialiased, its default): a triangle kernel at
    half-pixel sample positions, widened by the shrink factor when
    shrinking, each column normalized to sum 1, columns whose sample lies
    outside the input zeroed."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float64) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, dtype=torch.float64)[:, None]).abs()
    weights = (1.0 - dist / kernel_scale).clamp(min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device, dtype)


def resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """`jax.image.resize(x, ..., method="linear")` of an NCHW tensor over its
    two spatial axes, as two products with the interpolation matrices."""
    wh = _linear_weights(x.shape[2], out_h, x.device, x.dtype)
    ww = _linear_weights(x.shape[3], out_w, x.device, x.dtype)
    return torch.einsum("nchw,hy,wx->ncyx", x, wh, ww)
