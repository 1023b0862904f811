"""Upsample StyledConv tail in one pass: the kernel wrapper and its plain
version.

  out[b,y,x,c] = act(blur4(x)[b,y,x,c] * demod[b,c] + noise[b,y,x] + bias[c]) * act_scale

Counterpart of synthesis_in_style_tpu/ops/pallas/fused_blur.py
(`blur_demod_noise_bias_act`, forward). The CUDA kernel is
`csrc/fused_blur.cu`. Unlike the TPU kernel, the input is the LOGICAL
(B, 2h+1, 2h+1, C) transposed-conv output: the blur's (1, 1) zero padding is
virtual inside the kernel, so no width-padded producer is needed.

`taps` are the per-axis separable taps including the upsample gain: for the
StyleGAN2 (1, 3, 3, 1) blur after an up-2 conv they are [1, 3, 3, 1] / 8 * 2.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build
from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import DTYPE_CODES
from synthesis_in_style_tpu_torch.ops.upfirdn2d import upfirdn2d

DEFAULT_TAPS = (0.25, 0.75, 0.75, 0.25)


def _check_shapes(x, demod, noise, bias):
    b, h_in, w_in, c = x.shape
    if h_in != w_in or h_in % 2 != 1:
        raise ValueError(f"expected (B, 2h+1, 2h+1, C) input, got {tuple(x.shape)}")
    h_out = h_in - 1
    if demod.shape != (b, c):
        raise ValueError(f"demod shape {tuple(demod.shape)} != ({b}, {c})")
    if noise.shape[1:] != (h_out, h_out) or noise.shape[0] not in (1, b):
        raise ValueError(
            f"noise shape {tuple(noise.shape)} != (1 or {b}, {h_out}, {h_out})"
        )
    if bias.shape != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")


def blur_demod_noise_bias_act_plain(
    x: torch.Tensor,
    demod: torch.Tensor,
    noise: torch.Tensor,
    bias: torch.Tensor,
    taps: Sequence[float] = DEFAULT_TAPS,
    slope: float = 0.2,
    act_scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """upfirdn2d blur (pad (1, 1)) + the epilogue, in float32, rounded once to
    x's dtype. noise is (B or 1, 2h, 2h)."""
    _check_shapes(x, demod, noise, bias)
    k1 = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    k2d = k1[:, None] * k1[None, :]
    pre = upfirdn2d(x.float(), k2d, pad=(1, 1))
    pre = pre * demod.float()[:, None, None, :] + noise.float()[..., None] + bias.float()
    return (torch.where(pre >= 0, pre, pre * slope) * act_scale).to(x.dtype)


def blur_demod_noise_bias_act_cuda(
    x: torch.Tensor,
    demod: torch.Tensor,
    noise: torch.Tensor,
    bias: torch.Tensor,
    taps: Sequence[float] = DEFAULT_TAPS,
    slope: float = 0.2,
    act_scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Launch the kernel. x: contiguous (B, 2h+1, 2h+1, C) float32/bfloat16;
    demod (B, C), noise (B or 1, 2h, 2h) and bias (C,) are read as float32."""
    if not x.is_cuda:
        raise ValueError(f"blur_demod_noise_bias_act_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"blur_demod_noise_bias_act_cuda: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("blur_demod_noise_bias_act_cuda: x must be contiguous NHWC")
    _check_shapes(x, demod, noise, bias)
    b, h_in, _, c = x.shape
    h_out = h_in - 1
    demod = demod.to(device=x.device, dtype=torch.float32).contiguous()
    noise = noise.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    # a (1, H, W) plane is shared by the whole batch: batch stride 0
    noise_batch_stride = 0 if noise.shape[0] == 1 else h_out * h_out
    out = torch.empty((b, h_out, h_out, c), dtype=x.dtype, device=x.device)
    # true convolution == correlation with the flipped taps
    t = [float(v) for v in taps][::-1]
    if len(t) != 4:
        raise ValueError(f"the blur kernel takes 4 taps per axis, got {len(t)}")
    fn = build.load(
        "fused_blur",
        "sis_blur_tail",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
         ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
         ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), demod.data_ptr(), noise.data_ptr(), noise_batch_stride,
        bias.data_ptr(), out.data_ptr(), b, h_in, c, DTYPE_CODES[x.dtype],
        t[0], t[1], t[2], t[3], slope, act_scale,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "sis_blur_tail")
    blur_demod_noise_bias_act_cuda.launches += 1
    return out


blur_demod_noise_bias_act_cuda.launches = 0


def blur_demod_noise_bias_act(
    x: torch.Tensor,
    demod: torch.Tensor,
    noise: torch.Tensor,
    bias: torch.Tensor,
    taps: Sequence[float] = DEFAULT_TAPS,
    slope: float = 0.2,
    act_scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors; any other
    device raises."""
    if x.is_cuda:
        return blur_demod_noise_bias_act_cuda(
            x.contiguous(), demod, noise, bias, taps, slope, act_scale
        )
    if x.device.type == "cpu":
        return blur_demod_noise_bias_act_plain(
            x, demod, noise, bias, taps, slope, act_scale
        )
    raise ValueError(f"blur_demod_noise_bias_act: no implementation for device {x.device}")
