"""Fused bias + LeakyReLU + gain, forward: the kernel wrapper and its plain
version.

Counterpart of synthesis_in_style_tpu/ops/pallas/fused_bias_act.py
(`fused_leaky_relu_pallas`, forward). The CUDA kernel is
`csrc/fused_bias_act.cu`. A CUDA tensor always goes to the kernel (or
raises); a CPU tensor takes `fused_leaky_relu_plain`, which computes the same
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


def fused_leaky_relu_plain(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = _SQRT2,
) -> torch.Tensor:
    """y = leaky_relu(x + bias[c]) * scale over a (..., C) tensor, computed in
    float32 and rounded once to x's dtype (as the kernel does)."""
    v = x.float()
    if bias is not None:
        v = v + bias.float()
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
    fn = build.load(
        "fused_bias_act",
        "sis_bias_act_fwd",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
         ctypes.c_void_p],
    )
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

