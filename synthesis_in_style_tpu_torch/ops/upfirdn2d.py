"""upfirdn2d (upsample -> FIR filter -> downsample) in plain PyTorch, NHWC.

Counterpart of synthesis_in_style_tpu/ops/upfirdn2d.py, where it is one XLA
convolution and no Pallas kernel. Here: zero-insertion upsample (each sample
followed by up-1 zeros), pad or crop, a depthwise convolution with the flipped
FIR kernel, strided downsample.
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


def upfirdn2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: Union[int, Tuple[int, int]] = 1,
    down: Union[int, Tuple[int, int]] = 1,
    pad: Pad = (0, 0),
) -> torch.Tensor:
    """(N, H, W, C) -> (N, (H*up_y + pad_y0 + pad_y1 - kh) // down_y + 1, ..., C).

    `pad` is (pad0, pad1) for both axes or (x0, x1, y0, y1); negative crops.
    """
    up_y, up_x = (up, up) if isinstance(up, int) else up
    down_y, down_x = (down, down) if isinstance(down, int) else down
    pad_x0, pad_x1, pad_y0, pad_y1 = _normalize_pad(pad)
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
