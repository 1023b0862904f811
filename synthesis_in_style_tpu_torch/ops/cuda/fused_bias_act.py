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
import functools
import math
from collections import Counter
from typing import Optional, Tuple

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build

_SQRT2 = math.sqrt(2.0)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


# launch geometry of the forward kernel: threads per block (the kernel's
# kFwdThreads, its __launch_bounds__) and the blocks the grid aims at
# (TARGET_BLOCKS_PER_SM for each of the H100's 132 SMs; the sweep behind
# both numbers is described beside __launch_bounds__ in
# csrc/fused_bias_act.cu)
THREADS_PER_BLOCK = 512
TARGET_BLOCKS_PER_SM = 16
NUM_SMS = 132
VECTOR_BYTES = 16


def bias_act_geometry(numel: int, c: int, itemsize: int, x_ptr: int, y_ptr: int,
                      threads: int = THREADS_PER_BLOCK,
                      blocks_per_sm: int = TARGET_BLOCKS_PER_SM) -> Tuple[int, int, int, int]:
    """(vec, threads, rows_per_step, grid) of the forward kernel's launch
    over `numel` elements viewed as (numel / c, c) rows.

    A thread owns `vec` consecutive channels (one 16-byte vector, or one
    value when C x itemsize is not a multiple of 16 or x or y is not 16-byte
    aligned) and walks rows with a stride of `rows_per_step`; the grid holds
    rows_per_step x (c / vec) live threads, cut to about `blocks_per_sm`
    blocks for each SM. A grid with fewer live threads than `threads` for
    each SM gets smaller blocks (whole warps), so that a small call spreads
    over as many SMs as it can fill. Only the pointers' alignment enters the
    result, so the cache keys on that."""
    aligned = (x_ptr | y_ptr) % VECTOR_BYTES == 0
    return _geometry(numel, c, itemsize, aligned, threads, blocks_per_sm)


@functools.lru_cache(maxsize=256)  # a few dozen shapes per model; saves host time per launch
def _geometry(numel: int, c: int, itemsize: int, aligned: bool, threads: int,
              blocks_per_sm: int) -> Tuple[int, int, int, int]:
    if numel <= 0 or c <= 0:
        return 1, threads, 1, 1
    vec = VECTOR_BYTES // itemsize
    if not aligned or (c * itemsize) % VECTOR_BYTES:
        vec = 1
    c_vecs = c // vec
    rows = numel // c
    target_threads = NUM_SMS * blocks_per_sm * threads
    rows_per_step = max(1, min(rows, target_threads // c_vecs))
    live = rows_per_step * c_vecs
    if live >= 2**31:
        raise ValueError(f"fused bias-act: C = {c} is too wide for one launch")
    warps_per_sm = -(-live // (NUM_SMS * 32))
    threads = min(threads, 32 * warps_per_sm)
    return vec, threads, rows_per_step, -(-live // threads)


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
    x_ptr, y_ptr = x.data_ptr(), y.data_ptr()
    fn = build.load("fused_bias_act", "sis_bias_act_fwd", _FWD_ARGTYPES)
    err = fn(
        x_ptr,
        bias.data_ptr() if bias is not None else None,
        y_ptr,
        x.numel(),
        c,
        DTYPE_CODES[x.dtype],
        negative_slope,
        scale,
        *bias_act_geometry(x.numel(), c, x.element_size(), x_ptr, y_ptr),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "sis_bias_act_fwd")
    fused_leaky_relu_cuda.launches += 1
    fused_leaky_relu_cuda.shapes[tuple(x.shape), x.dtype] += 1
    return y


fused_leaky_relu_cuda.launches = 0
# launches by (shape, dtype), counted with `launches`
fused_leaky_relu_cuda.shapes = Counter()


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
    fused_leaky_relu_bwd_cuda.shapes[tuple(g.shape), g.dtype] += 1
    return dx


fused_leaky_relu_bwd_cuda.launches = 0
# launches by (shape, dtype), counted with `launches`
fused_leaky_relu_bwd_cuda.shapes = Counter()
