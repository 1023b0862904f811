"""Upsample StyledConv tail in one pass: the kernel wrapper, its plain
version and the autograd Function around both.

  out[b,y,x,c] = act(blur4(x)[b,y,x,c] * demod[b,c] + noise[b,y,x] + bias[c]) * act_scale

Counterpart of synthesis_in_style_tpu/ops/pallas/fused_blur.py
(`blur_demod_noise_bias_act`: the forward kernel and its AD rule
`_jvp_rule`). The CUDA kernel is `csrc/fused_blur.cu`. Unlike the TPU
kernel, the input is the LOGICAL (B, 2h+1, 2h+1, C) transposed-conv output:
the blur's (1, 1) zero padding is virtual inside the kernel, so no
width-padded producer is needed.

`taps` are the per-axis separable taps including the upsample gain: for the
StyleGAN2 (1, 3, 3, 1) blur after an up-2 conv they are [1, 3, 3, 1] / 8 * 2.

`blur_demod_noise_bias_act` is `FusedBlurTailFunction` on every device: the
forward runs the kernel on a CUDA tensor and the plain version on a CPU
tensor; the backward is written in differentiable PyTorch ops (as the JAX
rule is written in XLA), so second-order gradients (path length) go
through it. Its activation step reuses the bias-act backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Sequence, Tuple

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build
from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import DTYPE_CODES, compute_dtype
from synthesis_in_style_tpu_torch.ops.fused_act import FusedLeakyReLUBackwardFunction
from synthesis_in_style_tpu_torch.ops.upfirdn2d import upfirdn2d

DEFAULT_TAPS = (0.25, 0.75, 0.75, 0.25)
# launch geometry of csrc/fused_blur.cu: threads per block (one per output
# column x 16-byte channel vector; the kernel's kMaxThreads), blocks aimed at
# (one wave: two such blocks on each of the H100's 132 SMs), and the fewest
# output rows a block walks
THREADS_PER_BLOCK = 512
TARGET_BLOCKS = 2 * 132
MIN_ROWS = 4
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


@functools.lru_cache(maxsize=64)  # a few shapes per model; saves host time per launch
def blur_tile_geometry(batch: int, h_out: int, c: int, itemsize: int) -> Tuple[int, int, int]:
    """(tile_x, vpp, rows) of the kernel's launch: a block of tile_x * vpp
    threads owns tile_x output columns x vpp 16-byte channel vectors of one
    image and walks `rows` output rows. Rows are cut so that the grid comes
    nearest TARGET_BLOCKS blocks, never fewer than MIN_ROWS rows (each
    strip re-reads 3 halo rows)."""
    c_vecs = c * itemsize // 16
    vpp = min(32, c_vecs)
    tile_x = max(1, min(THREADS_PER_BLOCK // vpp, h_out))
    base = batch * -(-h_out // tile_x) * -(-c_vecs // vpp)
    strips = max(1, min((TARGET_BLOCKS + base // 2) // base, h_out // MIN_ROWS))
    return tile_x, vpp, -(-h_out // strips)


def _blur_kernel(taps: Sequence[float], device, dtype=torch.float32) -> torch.Tensor:
    k1 = torch.as_tensor(taps, dtype=dtype, device=device)
    return k1[:, None] * k1[None, :]


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
    acc = compute_dtype(x.dtype)
    pre = upfirdn2d(x.to(acc), _blur_kernel(taps, x.device, acc), pad=(1, 1))
    pre = pre * demod.to(acc)[:, None, None, :] + noise.to(acc)[..., None] + bias.to(acc)
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
    """Launch the kernel. x: contiguous (B, 2h+1, 2h+1, C) float32/bfloat16,
    16-byte aligned, C a multiple of 4 (float32) or 8 (bfloat16), as every
    StyleGAN2 width is; demod (B, C), noise (B or 1, 2h, 2h) and bias (C,)
    are read as float32."""
    if not x.is_cuda:
        raise ValueError(f"blur_demod_noise_bias_act_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"blur_demod_noise_bias_act_cuda: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("blur_demod_noise_bias_act_cuda: x must be contiguous NHWC")
    _check_shapes(x, demod, noise, bias)
    b, h_in, _, c = x.shape
    if (c * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(
            "blur_demod_noise_bias_act_cuda: the kernel moves 16-byte channel vectors: "
            f"C = {c} must be a multiple of {16 // x.element_size()} and x 16-byte aligned"
        )
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
    fn = build.load("fused_blur", "sis_blur_tail", _ARGTYPES)
    err = fn(
        x.data_ptr(), demod.data_ptr(), noise.data_ptr(), noise_batch_stride,
        bias.data_ptr(), out.data_ptr(), b, h_in, c, DTYPE_CODES[x.dtype],
        t[0], t[1], t[2], t[3], slope, act_scale,
        *blur_tile_geometry(b, h_out, c, x.element_size()),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "sis_blur_tail")
    blur_demod_noise_bias_act_cuda.launches += 1
    blur_demod_noise_bias_act_cuda.shapes[tuple(x.shape), x.dtype] += 1
    return out


blur_demod_noise_bias_act_cuda.launches = 0
# launches by (x's shape, dtype), counted with `launches`
blur_demod_noise_bias_act_cuda.shapes = Counter()


class FusedBlurTailFunction(torch.autograd.Function):
    """(x, demod, noise, bias) -> the tail above. The backward, with
    pre = blur(x) * demod + noise + bias and dpre = act'(pre) * g (from y):

      dbias  = sum over (b, y, x) of dpre      dnoise = sum over c of dpre
      ddemod = sum over (y, x) of dpre * blur(x)
      dx     = blur^T(dpre * demod)  (upfirdn2d with the flipped taps, pad 2)

    dnoise is summed over the batch too for a shared (1, H, W) plane."""

    @staticmethod
    def forward(ctx, x, demod, noise, bias, taps, slope, act_scale):
        if x.is_cuda:
            y = blur_demod_noise_bias_act_cuda(
                x.contiguous(), demod, noise, bias, taps, slope, act_scale
            )
        elif x.device.type == "cpu":
            y = blur_demod_noise_bias_act_plain(x, demod, noise, bias, taps, slope, act_scale)
        else:
            raise ValueError(f"blur_demod_noise_bias_act: no implementation for device {x.device}")
        ctx.save_for_backward(x, demod, noise, bias, y)
        ctx.taps, ctx.slope, ctx.act_scale = tuple(taps), slope, act_scale
        return y

    @staticmethod
    def backward(ctx, g):
        x, demod, noise, bias, y = ctx.saved_tensors
        need_x, need_demod, need_noise, need_bias = ctx.needs_input_grad[:4]
        dpre, dbias = FusedLeakyReLUBackwardFunction.apply(
            g, y, bias.dtype if need_bias else None, ctx.slope, ctx.act_scale
        )
        acc = compute_dtype(x.dtype)
        dpre = dpre.to(acc)
        k2d = _blur_kernel(ctx.taps, x.device, acc)
        dx = ddemod = dnoise = None
        if need_x:
            dx = upfirdn2d(dpre * demod.to(acc)[:, None, None, :], torch.flip(k2d, (0, 1)),
                           pad=(2, 2)).to(x.dtype)
        if need_demod:
            blur_x = upfirdn2d(x.to(acc), k2d, pad=(1, 1))
            ddemod = (dpre * blur_x).sum(dim=(1, 2)).to(demod.dtype)
        if need_noise:
            dnoise = dpre.sum(dim=-1)
            if noise.shape[0] == 1:
                dnoise = dnoise.sum(dim=0, keepdim=True)
            dnoise = dnoise.to(noise.dtype)
        return dx, ddemod, dnoise, dbias, None, None, None


def blur_demod_noise_bias_act(
    x: torch.Tensor,
    demod: torch.Tensor,
    noise: torch.Tensor,
    bias: torch.Tensor,
    taps: Sequence[float] = DEFAULT_TAPS,
    slope: float = 0.2,
    act_scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """`FusedBlurTailFunction`: kernel for CUDA tensors, plain version for
    CPU tensors, any other device raises; differentiable to any order."""
    return FusedBlurTailFunction.apply(x, demod, noise, bias, tuple(taps), slope, act_scale)
