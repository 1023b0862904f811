"""Connected-components labelling: the union-find kernel wrapper and the
plain version.

Counterpart of synthesis_in_style_tpu/ops/pallas/segmented_cc.py (`cc_sweeps`)
and of the loop that drives it in segmentation/device_cc.py. The CUDA
kernels are in `csrc/segmented_cc.cu`: a tile-local union-find in shared
memory, a union across tile edges and a flatten, all on the current stream,
with no host sync.

The contract is the fixpoint: background -1, every component labelled with
the smallest linear index (y * W + x) it contains. That labelling is unique,
so the kernel route and the plain route agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build

INF = torch.iinfo(torch.int32).max


def _seed_labels(mask: torch.Tensor) -> torch.Tensor:
    _, h, w = mask.shape
    seeds = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(1, h, w)
    return torch.where(mask, seeds, torch.full_like(seeds, INF))


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[b, y, x] = x[b, y - dy, x - dx], INF where that lies outside."""
    _, h, w = x.shape
    out = torch.full_like(x, INF)
    out[:, max(dy, 0): h + min(dy, 0), max(dx, 0): w + min(dx, 0)] = x[
        :, max(-dy, 0): h + min(-dy, 0), max(-dx, 0): w + min(-dx, 0)
    ]
    return out


def connected_components_plain(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Iterated masked neighbour min until nothing changes: slow, obviously
    right. mask (B, H, W) bool -> (B, H, W) int32 labels."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    mask = mask.bool()
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    labels = _seed_labels(mask)
    inf = torch.full_like(labels, INF)
    while True:
        new = labels
        for dy, dx in offsets:
            new = torch.minimum(new, _shift(labels, dy, dx))
        new = torch.where(mask, new, inf)
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(mask, labels, torch.full_like(labels, -1))


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def connected_components_cuda(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Label a (B, H, W) CUDA mask in one call: three kernel launches on the
    current stream, no device-to-host sync. Always reaches the fixpoint (no
    iteration cap). Any H, W with H * W < 2^31."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if not mask.is_cuda:
        raise ValueError(f"connected_components_cuda needs a CUDA tensor, got {mask.device}")
    if mask.ndim != 3:
        raise ValueError(f"expected a (B, H, W) mask, got shape {tuple(mask.shape)}")
    b, h, w = mask.shape
    if h * w >= 2**31:
        raise ValueError(f"connected_components_cuda: H * W = {h * w} does not fit int32 labels")
    mask_u8 = mask.bool().contiguous().view(torch.uint8)
    labels = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
    if labels.numel() == 0:
        return labels
    fn = build.load("segmented_cc", "sis_cc_union_find", _ARGTYPES)
    err = fn(mask_u8.data_ptr(), labels.data_ptr(), b, h, w, connectivity,
             torch.cuda.current_stream(mask.device).cuda_stream)
    build.check(err, "sis_cc_union_find")
    if torch.cuda.is_current_stream_capturing():
        # recorded into a CUDA graph, not launched: whoever replays the
        # graph counts the launches (PageProgram.run)
        connected_components_cuda.captured += 1
    else:
        connected_components_cuda.launches += 1
    return labels


# one count per labelling (three kernels): launched, and recorded into graphs
connected_components_cuda.launches = 0
connected_components_cuda.captured = 0
