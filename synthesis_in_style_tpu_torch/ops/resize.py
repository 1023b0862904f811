"""Bilinear resize with align_corners=True (the JAX package's
`resize_bilinear_align_corners`, models/ema_net.py), shared by the port's
segmenters: TransUNet's decoder upsamples and EMANet's logits."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True of an NCHW tensor (the JAX
    function in the port's layout); the tensor itself at its own size."""
    if tuple(x.shape[2:4]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)
