"""w8a8 int8 quantization for the serving paths (counterpart of
synthesis_in_style_tpu/ops/quant.py).

Layout and scheme are the JAX package's: NHWC activations, HWIO weights,
symmetric int8 with QMAX = 127, one dynamic scale per sample for an
activation and one per output channel for a weight, `round` half to even
(`torch.round`, like `jnp.round`), int32 accumulation. Serving only: the
rounding is not differentiable.

* Dynamic (the generator): `conv2d_w8a8` quantizes its input per sample and
  its weight per output channel at each call, convolves in int8 and
  dequantizes with the product of the two scales.
* Static (DocUFCN, models/doc_ufcn_quant.py): `scale_from_amax` turns a
  calibrated abs-max into a scale, `quantize_weight_folded` folds the input
  scales into the weight before quantizing it, `requantize` maps an
  activation to int8 with a fixed scale.

`int8_conv` is the hand-written kernel (ops/cuda/int8_conv.py) on a CUDA
tensor and its exact plain version on a CPU tensor; any other device raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from synthesis_in_style_tpu_torch.ops.cuda.int8_conv import (
    Padding,
    int8_conv_cuda,
    int8_conv_plain,
)

QMAX = 127.0


def quantize_per_sample(x: torch.Tensor, eps: float = 1e-12
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) -> (int8 codes, float32 scale (B,)), x ~= codes * scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=(1, 2, 3))
    scale = amax.clamp_min(eps) / QMAX
    xq = torch.round(xf / scale[:, None, None, None]).clamp(-QMAX, QMAX).to(torch.int8)
    return xq, scale


def quantize_per_out_channel(w: torch.Tensor, eps: float = 1e-12
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO weight -> (int8 codes, float32 scale (O,)), w ~= codes * scale."""
    wf = w.float()
    amax = wf.abs().amax(dim=(0, 1, 2))
    scale = amax.clamp_min(eps) / QMAX
    wq = torch.round(wf / scale).clamp(-QMAX, QMAX).to(torch.int8)
    return wq, scale


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1, padding: Padding = 0,
              lhs_dilation: Optional[Sequence[int]] = None,
              rhs_dilation: Optional[Sequence[int]] = None) -> torch.Tensor:
    """int8 NHWC x int8 HWIO -> int32 NHWC (zero padding and zero insertion
    are exact: the zero point is 0)."""
    if x_q.is_cuda:
        return int8_conv_cuda(x_q, w_q, stride, padding, lhs_dilation, rhs_dilation)
    if x_q.device.type == "cpu":
        return int8_conv_plain(x_q, w_q, stride, padding, lhs_dilation, rhs_dilation)
    raise ValueError(f"int8_conv: no implementation for device {x_q.device}")


def conv2d_w8a8(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: Padding = 0,
                lhs_dilation: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Quantize -> int8 conv -> dequantize, in x's dtype; HWIO w."""
    xq, sx = quantize_per_sample(x)
    wq, sw = quantize_per_out_channel(w)
    out = int8_conv(xq, wq, stride=stride, padding=padding, lhs_dilation=lhs_dilation)
    scale = sx[:, None, None, None] * sw[None, None, None, :]
    return (out.float() * scale).to(x.dtype)


def scale_from_amax(amax, eps: float = 1e-12) -> torch.Tensor:
    """Calibrated abs-max -> symmetric int8 scale (zero-safe), float32."""
    amax = amax if isinstance(amax, torch.Tensor) else torch.tensor(amax)
    return amax.float().clamp_min(eps) / QMAX


def quantize_weight_folded(w: torch.Tensor, s_in, eps: float = 1e-12
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold per-input-channel activation scales (I,) or a scalar into an HWIO
    weight, then quantize it per output channel."""
    s_in = torch.as_tensor(s_in, dtype=torch.float32, device=w.device)
    return quantize_per_out_channel(w.float() * s_in.reshape(1, 1, -1, 1), eps)


def requantize(y: torch.Tensor, s_out) -> torch.Tensor:
    """float activation -> int8 with a static (per-channel or scalar) scale."""
    s_out = torch.as_tensor(s_out, dtype=torch.float32, device=y.device)
    return torch.round(y.float() / s_out).clamp(-QMAX, QMAX).to(torch.int8)


def _parity_compose(ee: torch.Tensor, eo: torch.Tensor, oe: torch.Tensor,
                    oo: torch.Tensor) -> torch.Tensor:
    """Place the four parity planes on the (2H+1, 2W+1) grid: ee at even rows
    and columns, eo at even rows and odd columns, oe at odd rows and even
    columns, oo at odd rows and columns (disjoint positions)."""
    b, h1, w1, c = ee.shape
    out = ee.new_zeros((b, 2 * h1 - 1, 2 * w1 - 1, c))
    out[:, 0::2, 0::2] = ee
    out[:, 0::2, 1::2] = eo
    out[:, 1::2, 0::2] = oe
    out[:, 1::2, 1::2] = oo
    return out


def conv2d_w8a8_up2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantized 2x transposed conv (k = 3), parity-decomposed into four plain
    int8 convs: bit-identical to `conv2d_w8a8(x, w, padding=2,
    lhs_dilation=(2, 2))`. `w` is HWIO, kh = kw = 3, already flipped by the
    caller. The generator does not route to it (its upsampling convs stay
    float, as in the JAX package)."""
    assert w.shape[0] == 3 and w.shape[1] == 3, w.shape
    xq, sx = quantize_per_sample(x)
    wq, sw = quantize_per_out_channel(w)
    scale = sx[:, None, None, None] * sw[None, None, None, :]

    def sub(kern, pad_h, pad_w):
        out = int8_conv(xq, kern.contiguous(), padding=(pad_h, pad_w))
        return (out.float() * scale).to(x.dtype)

    ee = sub(wq[0::2, 0::2], (1, 1), (1, 1))  # (B, H+1, W+1, O)
    eo = sub(wq[0::2, 1:2], (1, 1), (0, 0))  # (B, H+1, W, O)
    oe = sub(wq[1:2, 0::2], (0, 0), (1, 1))  # (B, H, W+1, O)
    oo = sub(wq[1:2, 1:2], (0, 0), (0, 0))  # (B, H, W, O)
    return _parity_compose(ee, eo, oe, oo)
