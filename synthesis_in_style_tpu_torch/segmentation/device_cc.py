"""Connected components and component statistics on tensors (counterpart of
synthesis_in_style_tpu/segmentation/device_cc.py).

Labels follow the JAX package's contract: background -1, each component
labelled with the smallest linear index it contains. `connected_components`
picks its route from the tensor's device, outside any compiled region: a
CUDA tensor goes through the hand-written union-find kernel
(ops/cuda/segmented_cc.py), a CPU tensor through the plain version. Any other
device, or an unknown `backend`, raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from synthesis_in_style_tpu_torch.ops.cuda.segmented_cc import (
    connected_components_cuda,
    connected_components_plain,
)

BACKENDS = ("kernel", "plain")


def connected_components(
    mask: torch.Tensor,
    *,
    connectivity: int = 4,
    max_iters: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """(B, H, W) or (H, W) bool -> int32 labels of the same shape.

    connectivity, max_iters and backend are keyword-only: the JAX
    function's positional order is (mask, max_iters, connectivity).

    max_iters is accepted for the JAX signature and not used: both routes
    always reach the fixpoint (the kernel is a union-find, not a sweep
    loop; the plain version iterates until nothing changes).

    backend: None picks "kernel" for a CUDA tensor and "plain" for a CPU
    tensor; "plain" may also be asked for on CUDA (the reference the kernel
    is held against). "kernel" on a CPU tensor raises."""
    if backend is None:
        if mask.is_cuda:
            backend = "kernel"
        elif mask.device.type == "cpu":
            backend = "plain"
        else:
            raise ValueError(f"connected_components: no route for device {mask.device}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown connected_components backend {backend!r}; one of {BACKENDS}")
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[None]
    if backend == "kernel":
        if not mask.is_cuda:
            raise ValueError("the CC kernel needs a CUDA tensor")
        labels = connected_components_cuda(mask, connectivity)
    else:
        labels = connected_components_plain(mask, connectivity)
    return labels[0] if squeeze else labels


def dilate_cross(mask: torch.Tensor) -> torch.Tensor:
    """3x3 cross-kernel binary dilation."""
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[None]
    m = mask.bool()
    out = m.clone()
    out[:, 1:, :] |= m[:, :-1, :]
    out[:, :-1, :] |= m[:, 1:, :]
    out[:, :, 1:] |= m[:, :, :-1]
    out[:, :, :-1] |= m[:, :, 1:]
    return out[0] if squeeze else out


def _border(h: int, w: int, device) -> torch.Tensor:
    border = torch.zeros((h, w), dtype=torch.bool, device=device)
    border[0, :] = True
    border[-1, :] = True
    border[:, 0] = True
    border[:, -1] = True
    return border


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill interior holes: background regions (4-connected, the dual of
    8-connected foreground) that do not touch the image border become
    foreground."""
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[None]
    mask = mask.bool()
    b, h, w = mask.shape
    bg_labels = connected_components(~mask, connectivity=4)
    flat = bg_labels.reshape(b, h * w).long()
    is_bg = flat >= 0
    is_border_bg = is_bg & _border(h, w, mask.device).reshape(1, h * w)
    idx = torch.where(is_bg, flat, torch.zeros_like(flat))
    # a label touches the border if any border pixel carries it
    marked = torch.zeros((b, h * w), dtype=torch.int32, device=mask.device)
    marked.scatter_reduce_(
        1, torch.where(is_border_bg, flat, torch.zeros_like(flat)),
        is_border_bg.to(torch.int32), reduce="amax",
    )
    touches_border = torch.gather(marked, 1, idx) > 0
    hole = is_bg & ~touches_border
    out = mask | hole.reshape(b, h, w)
    return out[0] if squeeze else out


def _flat_ids(labels: torch.Tensor):
    b, h, w = labels.shape
    flat = labels.reshape(b, h * w).long()
    valid = flat >= 0
    idx = torch.where(valid, flat, torch.zeros_like(flat))
    return flat, valid, idx


def component_sums(labels: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per-component float32 sum of `values`, addressed by label id:
    (B, H*W) with sums[b, l] = sum of values over component l."""
    squeeze = labels.ndim == 2
    if squeeze:
        labels, values = labels[None], values[None]
    b, h, w = labels.shape
    _, valid, idx = _flat_ids(labels)
    vals = values.reshape(b, h * w).to(torch.float32)
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    sums = torch.zeros((b, h * w), dtype=torch.float32, device=labels.device)
    sums.scatter_add_(1, idx, vals)
    return sums[0] if squeeze else sums


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """Pixel count of each component, addressed by label id: (B, H*W) int32."""
    squeeze = labels.ndim == 2
    if squeeze:
        labels = labels[None]
    b, h, w = labels.shape
    _, valid, idx = _flat_ids(labels)
    areas = torch.zeros((b, h * w), dtype=torch.int32, device=labels.device)
    areas.scatter_add_(1, idx, valid.to(torch.int32))
    return areas[0] if squeeze else areas


def component_bboxes(labels: torch.Tensor) -> torch.Tensor:
    """Per-component inclusive bbox: (B, H*W, 4) int32 of (y_min, x_min,
    y_max, x_max), addressed by label id; unused slots hold (H, W, -1, -1)."""
    squeeze = labels.ndim == 2
    if squeeze:
        labels = labels[None]
    b, h, w = labels.shape
    dev = labels.device
    _, valid, idx = _flat_ids(labels)
    ys = torch.arange(h, dtype=torch.int32, device=dev).repeat_interleave(w).expand(b, -1)
    xs = torch.arange(w, dtype=torch.int32, device=dev).repeat(h).expand(b, -1)
    out = []
    for coord, empty, reduce in ((ys, h, "amin"), (xs, w, "amin"), (ys, -1, "amax"), (xs, -1, "amax")):
        acc = torch.full((b, h * w), empty, dtype=torch.int32, device=dev)
        src = torch.where(valid, coord, torch.full_like(coord, empty))
        acc.scatter_reduce_(1, idx, src, reduce=reduce)
        out.append(acc)
    boxes = torch.stack(out, dim=-1)
    return boxes[0] if squeeze else boxes


def binary_closing(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Morphological close (dilate, then erode) with a size x size square,
    of a (B, H, W) or (H, W) bool mask. Outside the image counts as neither
    foreground nor background: max_pool2d pads with -inf, so the dilation
    ignores the border, and the erosion is -max_pool2d(-x), which pads
    with +inf."""
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[None]
    pad = size // 2
    x = mask[:, None].float()
    dilated = F.max_pool2d(x, size, stride=1, padding=pad)
    closed = -F.max_pool2d(-dilated, size, stride=1, padding=pad)
    out = closed[:, 0] > 0.5
    return out[0] if squeeze else out


def filter_small_components(mask: torch.Tensor, min_area: float) -> torch.Tensor:
    """Zero out 4-connected components with pixel area < min_area."""
    if min_area <= 0:
        return mask
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[None]
    labels = connected_components(mask)
    b, h, w = labels.shape
    flat, valid, idx = _flat_ids(labels)
    pixel_area = torch.gather(component_areas(labels), 1, idx)
    out = (valid & (pixel_area >= min_area)).reshape(b, h, w)
    return out[0] if squeeze else out
