"""(N, H, W, C) <-> (N*H*W, C) reshapes of the cluster path (counterpart of
`partial_flat` / `partial_unflat` in synthesis_in_style_tpu/segmentation/ptutils.py;
channel-last, as there)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def partial_flat(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(N, H, W, C) -> ((N*H*W, C), original_shape)."""
    x = torch.as_tensor(x)
    return x.reshape(-1, x.shape[-1]), tuple(x.shape)


def partial_unflat(
    x: torch.Tensor,
    original_shape: Optional[Tuple[int, ...]] = None,
    n: Optional[int] = None,
    h: Optional[int] = None,
    w: Optional[int] = None,
) -> torch.Tensor:
    """(N*H*W, C) -> (N, H, W, C), from `original_shape` or n, h, w (w
    defaults to h)."""
    if x.ndim != 2:
        raise ValueError(f"expected (N*H*W, C), got shape {tuple(x.shape)}")
    if original_shape is not None:
        n, h, w = original_shape[0], original_shape[1], original_shape[2]
    if w is None:
        w = h
    if n is None or h is None:
        raise ValueError("give original_shape, or n and h")
    return x.reshape(n, h, w, x.shape[1])
