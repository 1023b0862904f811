"""Fused bias-add + LeakyReLU(0.2) + sqrt(2) gain (counterpart of
synthesis_in_style_tpu/ops/fused_act.py).

Channel axis is the last axis ((..., C)), as in the JAX package. A CUDA tensor
runs the hand-written kernel (ops/cuda/fused_bias_act.py); a CPU tensor runs
its plain PyTorch version; any other device raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
    fused_leaky_relu_cuda,
    fused_leaky_relu_plain,
)

_SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """y = leaky_relu(x + bias) * scale, bias broadcast over the last axis."""
    if x.is_cuda:
        return fused_leaky_relu_cuda(x.contiguous(), bias, negative_slope, scale)
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    raise ValueError(f"fused_leaky_relu: no implementation for device {x.device}")


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU * sqrt(2) without bias."""
    return fused_leaky_relu(x, None, negative_slope)
