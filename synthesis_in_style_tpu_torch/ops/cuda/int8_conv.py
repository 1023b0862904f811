"""int8 x int8 -> int32 convolution: the kernel wrapper and the plain version.

The kernel is `csrc/int8_conv.cu` (an implicit GEMM on `mma.sync` s8). It
replaces no TPU kernel: the JAX package's ops/quant.py `int8_conv` is one
XLA convolution with an int32 result. Layout is the JAX package's: x (B, H,
W, C) int8, w (KH, KW, C, O) int8, out (B, OH, OW, O) int32.

Integer accumulation is exact, so the kernel and the plain version agree bit
for bit. The plain version is a float64 convolution of the int8 values: every
partial sum is an integer below 127 * 127 * KH * KW * C, far below 2^53.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from synthesis_in_style_tpu_torch.ops.cuda import build

Padding = Union[int, Sequence[Sequence[int]]]


def normalize_padding(padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """int or ((top, bottom), (left, right)) -> the latter."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (top, bottom), (left, right) = padding
    return (int(top), int(bottom)), (int(left), int(right))


def _pair(v: Optional[Sequence[int]]) -> Tuple[int, int]:
    return (1, 1) if v is None else (int(v[0]), int(v[1]))


def output_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: Padding,
              lhs_dilation=None, rhs_dilation=None) -> Tuple[int, int]:
    """Output height and width of the convolution (lax's rule)."""
    (pt, pb), (pl, pr) = normalize_padding(padding)
    (ly, lx), (ry, rx) = _pair(lhs_dilation), _pair(rhs_dilation)
    hd, wd = (h - 1) * ly + 1 + pt + pb, (w - 1) * lx + 1 + pl + pr
    return (hd - (kh - 1) * ry - 1) // stride + 1, (wd - (kw - 1) * rx - 1) // stride + 1


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 operands, got {x.dtype} and {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(
            f"int8_conv: x (B, H, W, C) and w (KH, KW, C, O) expected, got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: Padding = 0,
                    lhs_dilation=None, rhs_dilation=None) -> torch.Tensor:
    """The exact integer convolution as a float64 convolution (any device)."""
    _check(x, w)
    (pt, pb), (pl, pr) = normalize_padding(padding)
    ly, lx = _pair(lhs_dilation)
    xf = x.permute(0, 3, 1, 2).to(torch.float64)
    if ly > 1 or lx > 1:
        b, c, h, wd = xf.shape
        z = xf.new_zeros((b, c, (h - 1) * ly + 1, (wd - 1) * lx + 1))
        z[:, :, ::ly, ::lx] = xf
        xf = z
    xf = F.pad(xf, (pl, pr, pt, pb))
    wf = w.permute(3, 2, 0, 1).to(torch.float64)
    out = F.conv2d(xf, wf, stride=stride, dilation=_pair(rhs_dilation))
    return out.permute(0, 2, 3, 1).round().to(torch.int32).contiguous()


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 14 + [
    ctypes.c_void_p]


def int8_conv_cuda(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: Padding = 0,
                   lhs_dilation=None, rhs_dilation=None) -> torch.Tensor:
    """Launch the kernel on the current stream. Square dilations only (one
    lhs and one rhs factor for both axes); x 16-byte aligned."""
    if not x.is_cuda or not w.is_cuda:
        raise ValueError(f"int8_conv_cuda needs CUDA tensors, got {x.device} and {w.device}")
    _check(x, w)
    ly, lx = _pair(lhs_dilation)
    ry, rx = _pair(rhs_dilation)
    if ly != lx or ry != rx:
        raise ValueError("int8_conv_cuda takes the same dilation on both axes")
    (pt, pb), (pl, pr) = normalize_padding(padding)
    if min(pt, pb, pl, pr) < 0 or stride < 1 or ly < 1 or ry < 1:
        raise ValueError("int8_conv_cuda: padding >= 0, stride and dilations >= 1")
    x = x.contiguous()
    w = w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8_conv_cuda: operands must be 16-byte aligned")
    b, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = output_hw(h, wd, kh, kw, stride, padding, lhs_dilation, rhs_dilation)
    out = torch.empty((b, max(oh, 0), max(ow, 0), o), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    if b * oh * ow >= 2**31 or x.numel() >= 2**31:
        raise ValueError("int8_conv_cuda: more than 2^31 input or output pixels")
    fn = build.load("int8_conv", "sis_int8_conv", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, kh, kw, o, oh, ow,
             stride, pt, pl, ly, ry, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "sis_int8_conv")
    if torch.cuda.is_current_stream_capturing():
        # recorded into a CUDA graph: whoever replays it counts the launches
        int8_conv_cuda.captured += 1
    else:
        int8_conv_cuda.launches += 1
        int8_conv_cuda.shapes[tuple(x.shape), tuple(w.shape), stride, (pt, pb, pl, pr),
                              ly, ry] += 1
    return out


int8_conv_cuda.launches = 0
int8_conv_cuda.captured = 0
# launches by (x shape, w shape, stride, pads, lhs dilation, rhs dilation)
int8_conv_cuda.shapes = Counter()
