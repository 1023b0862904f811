"""Connected-components labelling: the sweep-kernel wrapper, the host loop
that drives it to its fixpoint, and the plain version.

Counterpart of synthesis_in_style_tpu/ops/pallas/segmented_cc.py (`cc_sweeps`)
and of the loop around it in segmentation/device_cc.py. The CUDA kernels are
in `csrc/segmented_cc.cu`.

The contract is the fixpoint: background -1, every component labelled with
the smallest linear index (y * W + x) it contains. That labelling is unique,
so the kernel route and the plain route agree bit for bit whatever their
sweep schedules.
"""

from __future__ import annotations

import ctypes

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build

INF = torch.iinfo(torch.int32).max
# sweeps per kernel call between two reads of the changed flags (one
# device-to-host sync each); even, as the 8-connectivity ping-pong needs
SWEEPS_PER_CALL = 4


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


def cc_sweeps_cuda(
    labels: torch.Tensor,
    scratch: torch.Tensor,
    mask: torch.Tensor,
    changed: torch.Tensor,
    connectivity: int,
    sweeps: int,
) -> None:
    """Run `sweeps` label sweeps in place on `labels` ((B, H, W) int32, INF at
    background), ORing a per-image flag into `changed` ((B,) int32) where a
    label was lowered. `scratch` is a second (B, H, W) int32 buffer; `mask`
    is (B, H, W) uint8."""
    b, h, w = labels.shape
    for t, dtype in ((labels, torch.int32), (scratch, torch.int32), (mask, torch.uint8)):
        if not t.is_cuda or t.dtype != dtype or t.shape != (b, h, w) or not t.is_contiguous():
            raise ValueError("cc_sweeps_cuda: bad labels/scratch/mask tensor")
    if changed.shape != (b,) or changed.dtype != torch.int32 or not changed.is_cuda:
        raise ValueError("cc_sweeps_cuda: changed must be a (B,) int32 CUDA tensor")
    fn = build.load(
        "segmented_cc",
        "sis_cc_sweeps",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
    )
    err = fn(
        labels.data_ptr(), scratch.data_ptr(), mask.data_ptr(), changed.data_ptr(),
        b, h, w, connectivity, sweeps,
        torch.cuda.current_stream(labels.device).cuda_stream,
    )
    build.check(err, "sis_cc_sweeps")
    cc_sweeps_cuda.launches += 1


cc_sweeps_cuda.launches = 0


def connected_components_cuda(
    mask: torch.Tensor, connectivity: int = 4, max_iters: int | None = None
) -> torch.Tensor:
    """Drive the sweep kernel to its fixpoint: after every SWEEPS_PER_CALL
    sweeps read the changed flags, stop when none is set or at `max_iters`
    sweeps (default H*W//2 + 2, a true bound: every sweep carries a
    component's minimum across at least one more run)."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    b, h, w = mask.shape
    if max_iters is None:
        max_iters = h * w // 2 + 2
    mask = mask.bool()
    labels = _seed_labels(mask).contiguous()
    if b == 0 or h * w == 0:
        return torch.where(mask, labels, torch.full_like(labels, -1))
    scratch = torch.empty_like(labels)
    mask_u8 = mask.to(torch.uint8).contiguous()
    changed = torch.zeros((b,), dtype=torch.int32, device=mask.device)
    done = 0
    while done < max_iters:
        changed.zero_()
        cc_sweeps_cuda(labels, scratch, mask_u8, changed, connectivity, SWEEPS_PER_CALL)
        done += SWEEPS_PER_CALL
        if not bool(changed.any()):
            break
    return torch.where(mask, labels, torch.full_like(labels, -1))
