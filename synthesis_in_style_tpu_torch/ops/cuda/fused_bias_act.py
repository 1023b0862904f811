"""Fused bias + LeakyReLU + gain, forward and backward: the kernel wrappers
and their plain versions.

Counterpart of synthesis_in_style_tpu/ops/pallas/fused_bias_act.py
(`fused_leaky_relu_pallas`: `_fwd_kernel` and `_bwd_kernel`). The CUDA
kernels are in `csrc/fused_bias_act.cu`. The autograd Functions in
ops/fused_act.py send a CUDA tensor to a kernel (which raises rather than
fall back) and a CPU tensor to the plain version, which computes the same
function in PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build

_SQRT2 = math.sqrt(2.0)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs (so gradcheck can run on them)."""
    return torch.promote_types(dtype, torch.float32)


def fused_leaky_relu_plain(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """y = leaky_relu(x + bias[c]) * scale over a (..., C) tensor, computed in
    float32 and rounded once to x's dtype (as the kernel does)."""
    acc = compute_dtype(x.dtype)
    v = x.to(acc)
    if bias is not None:
        v = v + bias.to(acc)
    return (torch.where(v >= 0, v, v * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu_cuda(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor (..., C) with C contiguous."""
    if not x.is_cuda:
        raise ValueError(f"fused_leaky_relu_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_leaky_relu_cuda: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_leaky_relu_cuda: x must be contiguous (..., C)")
    c = x.shape[-1]
    if bias is not None:
        if bias.shape != (c,):
            raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
        bias = bias.to(device=x.device, dtype=x.dtype).contiguous()
    y = torch.empty_like(x)
    fn = build.load("fused_bias_act", "sis_bias_act_fwd", _FWD_ARGTYPES)
    err = fn(
        x.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        y.data_ptr(),
        x.numel(),
        c,
        DTYPE_CODES[x.dtype],
        negative_slope,
        scale,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "sis_bias_act_fwd")
    fused_leaky_relu_cuda.launches += 1
    return y


fused_leaky_relu_cuda.launches = 0


def fused_leaky_relu_bwd_plain(
    y: torch.Tensor,
    g: torch.Tensor,
    negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """dx = g * scale where y >= 0, else g * slope * scale; the mask from the
    forward output y compared in float32, the product in float32 rounded
    once to g's dtype (as the kernel does)."""
    acc = compute_dtype(g.dtype)
    gain = torch.where(y.float() >= 0, scale, negative_slope * scale).to(acc)
    return (g.to(acc) * gain).to(g.dtype)


def fused_leaky_relu_bwd_cuda(
    y: torch.Tensor,
    g: torch.Tensor,
    negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors y and g of one shape and
    dtype (any layout the caller made contiguous)."""
    if not (y.is_cuda and g.is_cuda):
        raise ValueError(
            f"fused_leaky_relu_bwd_cuda needs CUDA tensors, got {y.device} and {g.device}"
        )
    if g.dtype not in DTYPE_CODES or y.dtype != g.dtype:
        raise TypeError(f"fused_leaky_relu_bwd_cuda: unsupported dtypes {y.dtype}, {g.dtype}")
    if y.shape != g.shape:
        raise ValueError(f"y shape {tuple(y.shape)} != g shape {tuple(g.shape)}")
    if not (y.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_leaky_relu_bwd_cuda: y and g must be contiguous")
    dx = torch.empty_like(g)
    fn = build.load("fused_bias_act", "sis_bias_act_bwd", _BWD_ARGTYPES)
    err = fn(
        y.data_ptr(),
        g.data_ptr(),
        dx.data_ptr(),
        g.numel(),
        DTYPE_CODES[g.dtype],
        negative_slope,
        scale,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    build.check(err, "sis_bias_act_bwd")
    fused_leaky_relu_bwd_cuda.launches += 1
    return dx


fused_leaky_relu_bwd_cuda.launches = 0
