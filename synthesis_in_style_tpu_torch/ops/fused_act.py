"""Fused bias-add + LeakyReLU(0.2) + sqrt(2) gain (counterpart of
synthesis_in_style_tpu/ops/fused_act.py), differentiable to any order.

Channel axis is the last axis ((..., C)), as in the JAX package. Every call
goes through one autograd Function on every device; inside it a CUDA tensor
runs the hand-written kernel (ops/cuda/fused_bias_act.py), a CPU tensor runs
its plain PyTorch version, and any other device raises. So the CPU tests run
the same forward, backward and double backward as the card.

* `FusedLeakyReLUFunction` saves only the output y, as the JAX custom VJP
  (ops/pallas/fused_bias_act.py `_fwd_rule`) and the reference CUDA op do:
  the sign mask is rebuilt from y (y >= 0 iff x + b >= 0, scale > 0).
* Its backward is a second Function, `FusedLeakyReLUBackwardFunction`
  (g, y) -> (dx, db): the backward kernel for dx, db = sum of dx over all
  but the channel axis, accumulated in float32.
* That Function's own backward (the double backward R1 and path length
  need) is the same kernel on the incoming gradient of dx, plus the
  incoming gradient of db broadcast over the channel axis, with the same y:
  dx is linear in g with the mask as slope. y gets no gradient: the mask is
  piecewise constant.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
    compute_dtype,
    fused_leaky_relu_bwd_cuda,
    fused_leaky_relu_bwd_plain,
    fused_leaky_relu_cuda,
    fused_leaky_relu_plain,
)

_SQRT2 = math.sqrt(2.0)


def _forward(x, bias, slope, scale):
    if x.is_cuda:
        return fused_leaky_relu_cuda(x.contiguous(), bias, slope, scale)
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, slope, scale)
    raise ValueError(f"fused_leaky_relu: no implementation for device {x.device}")


def _backward(y, g, slope, scale):
    if g.is_cuda:
        return fused_leaky_relu_bwd_cuda(y.contiguous(), g.contiguous(), slope, scale)
    if g.device.type == "cpu":
        return fused_leaky_relu_bwd_plain(y, g, slope, scale)
    raise ValueError(f"fused_leaky_relu backward: no implementation for device {g.device}")


class FusedLeakyReLUBackwardFunction(torch.autograd.Function):
    """(g, y) -> (dx, db); db is None unless `bias_dtype` is given."""

    @staticmethod
    def forward(ctx, g, y, bias_dtype: Optional[torch.dtype], slope: float, scale: float):
        dx = _backward(y, g, slope, scale)
        ctx.save_for_backward(y)
        ctx.slope, ctx.scale = slope, scale
        db = None
        if bias_dtype is not None:
            acc = compute_dtype(dx.dtype)
            db = dx.reshape(-1, dx.shape[-1]).sum(0, dtype=acc).to(bias_dtype)
        return dx, db

    @staticmethod
    def backward(ctx, ggx, ggb):
        (y,) = ctx.saved_tensors
        if ggb is not None:
            ggx = ggx + ggb.to(ggx.dtype)
        gg, _ = FusedLeakyReLUBackwardFunction.apply(ggx, y, None, ctx.slope, ctx.scale)
        return gg, None, None, None, None


class FusedLeakyReLUFunction(torch.autograd.Function):
    """(x, bias or None) -> leaky_relu(x + bias) * scale."""

    @staticmethod
    def forward(ctx, x, bias: Optional[torch.Tensor], slope: float, scale: float):
        y = _forward(x, bias, slope, scale)
        ctx.save_for_backward(y)
        ctx.slope, ctx.scale = slope, scale
        ctx.bias_dtype = bias.dtype if bias is not None else None
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        bias_dtype = ctx.bias_dtype if ctx.needs_input_grad[1] else None
        dx, db = FusedLeakyReLUBackwardFunction.apply(g, y, bias_dtype, ctx.slope, ctx.scale)
        return dx, db, None, None


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """y = leaky_relu(x + bias) * scale, bias broadcast over the last axis."""
    return FusedLeakyReLUFunction.apply(x, bias, negative_slope, scale)


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU * sqrt(2) without bias."""
    return FusedLeakyReLUFunction.apply(x, None, negative_slope, _SQRT2)
