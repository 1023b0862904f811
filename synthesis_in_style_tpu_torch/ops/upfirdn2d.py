"""upfirdn2d (upsample -> FIR filter -> downsample) in plain PyTorch, NHWC.

Counterpart of synthesis_in_style_tpu/ops/upfirdn2d.py, where it is one XLA
convolution and no Pallas kernel. Here: zero-insertion upsample (each sample
followed by up-1 zeros), pad or crop, a depthwise convolution with the flipped
FIR kernel, strided downsample.

The op is linear in x, and its adjoint is upfirdn2d again (flipped kernel,
up and down swapped, the pads below), so it is an autograd Function whose
backward calls it: every order of derivative is a forward depthwise
convolution. PyTorch's own double backward of a grouped convolution loops
over the groups (one convolution per channel), which made R1 through the
discriminator's blurs take seconds per step on an H100.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Pad = Union[int, Tuple[int, int], Tuple[int, int, int, int]]


def make_kernel(k: Sequence[float], device=None) -> torch.Tensor:
    """Normalized 2-D FIR kernel: outer product of 1-D taps, unit sum."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def _normalize_pad(pad: Pad) -> Tuple[int, int, int, int]:
    """-> (pad_x0, pad_x1, pad_y0, pad_y1)."""
    if isinstance(pad, int):
        return pad, pad, pad, pad
    if len(pad) == 2:
        return pad[0], pad[1], pad[0], pad[1]
    return tuple(pad)  # type: ignore[return-value]


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)  # type: ignore[return-value]


class UpFirDn2dFunction(torch.autograd.Function):
    """upfirdn2d with its adjoint as backward (module docstring)."""

    @staticmethod
    def forward(ctx, x, kernel, up, down, pad):
        out = _upfirdn2d(x, kernel, up, down, pad)
        ctx.save_for_backward(kernel)
        ctx.up, ctx.down, ctx.pad = up, down, pad
        ctx.in_hw, ctx.out_hw = tuple(x.shape[1:3]), tuple(out.shape[1:3])
        return out

    @staticmethod
    def backward(ctx, g):
        (kernel,) = ctx.saved_tensors
        (up_y, up_x), (down_y, down_x) = ctx.up, ctx.down
        pad_x0, _, pad_y0, _ = ctx.pad
        (h, w), (out_h, out_w) = ctx.in_hw, ctx.out_hw
        kh, kw = kernel.shape
        g_pad = (kw - pad_x0 - 1, w * up_x - out_w * down_x + pad_x0 - up_x + 1,
                 kh - pad_y0 - 1, h * up_y - out_h * down_y + pad_y0 - up_y + 1)
        gx = UpFirDn2dFunction.apply(g, torch.flip(kernel, (0, 1)), ctx.down, ctx.up, g_pad)
        return gx, None, None, None, None


def upfirdn2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: Union[int, Tuple[int, int]] = 1,
    down: Union[int, Tuple[int, int]] = 1,
    pad: Pad = (0, 0),
) -> torch.Tensor:
    """(N, H, W, C) -> (N, (H*up_y + pad_y0 + pad_y1 - kh) // down_y + 1, ..., C).

    `pad` is (pad0, pad1) for both axes or (x0, x1, y0, y1); negative crops.
    `kernel` is a constant (no gradient).
    """
    return UpFirDn2dFunction.apply(x, kernel.detach(), _pair(up), _pair(down),
                                   _normalize_pad(pad))


def _upfirdn2d(x, kernel, up, down, pad):
    (up_y, up_x), (down_y, down_x) = up, down
    pad_x0, pad_x1, pad_y0, pad_y1 = pad
    n, h, w, c = x.shape
    kh, kw = kernel.shape

    out = x.permute(0, 3, 1, 2)  # NCHW view
    if up_y > 1 or up_x > 1:
        z = out.new_zeros((n, c, h * up_y, w * up_x))
        z[:, :, ::up_y, ::up_x] = out
        out = z
    # F.pad takes (left, right, top, bottom); negative values crop
    out = F.pad(out, (pad_x0, pad_x1, pad_y0, pad_y1))
    weight = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    weight = weight[None, None].expand(c, 1, kh, kw)
    out = F.conv2d(out, weight, stride=(down_y, down_x), groups=c)
    return out.permute(0, 2, 3, 1).contiguous()


def upsample_2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """FIR upsample; `kernel` is normalized (make_kernel), gain factor**2 here."""
    kh = kernel.shape[0]
    p = kh - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return upfirdn2d(x, kernel * (factor**2), up=factor, down=1, pad=(pad0, pad1))


def downsample_2d(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """FIR downsample; `kernel` is normalized (make_kernel)."""
    kh = kernel.shape[0]
    p = kh - factor
    return upfirdn2d(x, kernel, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur_2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    pad: Tuple[int, int],
    upsample_factor: int = 1,
) -> torch.Tensor:
    """FIR blur (reference `Blur`)."""
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor**2)
    return upfirdn2d(x, kernel, pad=pad)
