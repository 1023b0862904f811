"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--detail PATH]

1. Builds the three hand-written kernel libraries from
   synthesis_in_style_tpu_torch/csrc (nvcc, one process per source, all
   started together).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the two paths give it, with TF32 off for both: fused bias-act
   forward and backward at (16, 512) and (16, 256, 256, 128) in float32 and
   bfloat16, and the forward at the edges of its launch geometry (C of 3, 8,
   509, 512, fewer elements than one 16-byte vector, no rows, no bias, x at
   a storage offset) in both dtypes; the fused blur tail at the six
   upsample shapes of the 256px generator in float32 and bfloat16;
   union-find connected components,
   4- and 8-connected and bit-identical, on random masks, a 1-px snake, an
   all-foreground batch, a checkerboard, isolated pixels, a ragged
   (3, 37, 53), the real path's masks at (32, 256, 256) and their union at
   (16, 256, 256), and a page-sized (2, 1024, 768), every CC call under
   torch.cuda.set_sync_debug_mode("error") (no host sync inside). Each
   kernel is timed (wall per call, and device time from torch.profiler)
   beside its plain version, its bound and (backward) the nearest PyTorch
   calls.
3. Holds both autograd Functions (fused bias-act, fused blur tail) on the
   card against the same Functions on the CPU, first and second order.
4. Runs every step of one training iteration (D, R1, G, path length, EMA)
   of the full-width 256px G and D at batch 2, float32, on the card and on
   the CPU with the same draws, and holds the gradients of every parameter.
5. Cluster discovery on a randomly initialised 256px StyleGAN2 (seeded
   torch.Generator, the shipped stylegan_256px.yaml widths):
   `create_semantic_segmentation -n 100 -b 10 -c 6 9` (k = 6, 7, 8, all 14
   layers), once small to warm up, once measured with launch counts from 0
   (the bias-act forward and the blur tail must run, CC must not), with its
   generation, per-(layer, k) fit (seconds, steps, inertia), render and
   write seconds and activation bytes; its artifacts checked (14 unit-norm
   centres_ arrays with counts_ per catalog, int32 labels, uint8 NCHW
   arrays, the PNG grid). Then layer 8 (64px, 512 channels) fitted on the
   card and on the CPU with the same seed and TF32 off (equal steps,
   >= 99.9 % of labels equal, centres within 1e-3 cosine) and one epoch on
   the card under torch.cuda.set_sync_debug_mode("error");
   `select_cluster_config --ks 6 7 8 -n 32 -b 8` and `auto_label_clusters
   -k 8 -n 32` on the card with launch counts from 0, read as they return
   (every output parses; then the selection's outputs build the dataset
   segmenter, whose front half runs on one batch), and one statistics
   table card vs CPU (within 1e-4 of max|table|).
6. Holds the whole dataset path at full 256px width against itself on the
   CPU for a batch of 2: generator image and activations, and the device
   back half bit for bit.
7. Drives the dataset CLI (`create_dataset_for_segmentation --device-contours`)
   with that generator, the discovery phase's k = 8 catalog and a label map
   (two clusters by size rank as text), batch 16, 32 images; once to warm
   up, once measured, with every
   kernel's launch count set to 0 just before and read just after. Then
   the host contour route, the JAX package's default: the same CLI without
   --device-contours (batch 16, 32 images, launch counts from 0: the
   generator's bias-act and blur kernels must run and the CC kernel must
   not), its coco_gt.json decoded against the val labels, the same run with
   --contour-workers 2 (label pixels identical), the host route's stages
   per batch (synthesis, masks to the host, host half in process and in 2
   warm workers, PNG writing), and the host and device back halves on one
   batch of the path's own masks (<= 3 % of pixels apart).
8. Drives the training CLI (`train_stylegan_2`) on the shipped
   configs/stylegan/stylegan_256px.yaml (bfloat16, frozen noise on layers
   0-5, the shipped regularization) with batch 16, 8 iterations and a
   snapshot at 8, over 64 synthetic 256px pages: once to warm up, once
   measured (launch counts set to 0 before, read after; finite losses, D and
   G moved, the snapshot's g_ema loads through the dataset path's
   `load_generator` and renders), once with every step synchronized and
   timed for the split by step kind; then one more iteration under
   torch.profiler (device busy share, kernels with the most device time).
   The fused bias-act forward is then held against its plain version at
   every (shape, dtype) the measured run launched, with its device time,
   bound and launches x (device time - bound) per shape.
9. Chains the segmenter path onto step 7's PNG pairs: the segmenter
   training CLI (`train`) on the shipped
   configs/segmenter/stylegan2_doc_ufcn_segmenter.yaml (DocUFCN 32/64/128/256,
   256px, batch 8, bfloat16) for 16 iterations with one validation pass at
   the end, once to warm up and once measured (launch counts set to 0
   before, read after); the loader alone and the training step alone (on a
   batch already on the card, one step under torch.profiler); the trained
   full-width DocUFCN forward, card vs CPU with TF32 off. Then
   `analyze_image_segments --use-device-component-filter` with its snapshot
   over 4 synthetic 2048x1536 pages and their ground truth, swept over
   min_confidence 0.0 0.7 x min_contour_area 0 55 (warm-up, then measured
   with launch counts; segmented_cc must have been launched on this path);
   pages/s of the segmenter at 0.7 / 55, one page under torch.profiler, the
   CC kernel bit for bit against its plain version on that page's closed
   masks, and one page card vs CPU (TF32 off) on a seeded full-width
   DocUFCN whose class map holds two classes or more at >= 1 % each: class
   map >= 99.9 % equal, >= 99.9 % of confidences within 1e-3. Then the
   analyze CLI at 0.7 / 55 without --use-device-component-filter (the host
   contour filter; its launch counts from 0), pages/s with that filter, and
   one page with -vis and every drawing flag (its images must exist).
   Steps 5 and 7 to 9 run with PyTorch's defaults (TF32 cuDNN
   convolutions, float32 matmuls).

The last lines are the card's name and power limit, a JSON line of per-kernel
numbers (the elementwise kernels' rows carry float32 and, as bf16_ms,
bf16_device_ms and bf16_bound_ms, bfloat16 numbers at the main shape), and
{"ok": true, "device": {...}}. Any failed phase raises, and the
script exits non-zero; without a CUDA device it exits 2 before any phase.
On one card, with the long per-phase record written to a file:
  python3 chip_smoke.py --detail chip_smoke_detail.json

The same paths by hand: cluster discovery, selection and labelling
  python -m synthesis_in_style_tpu_torch.cli.create_semantic_segmentation <ckpt> \
      -n 100 -b 10 -c 6 9
  python -m synthesis_in_style_tpu_torch.scripts.select_cluster_config <ckpt> \
      <run>/semantic_segmentation --ks 6 7 8
  python -m synthesis_in_style_tpu_torch.scripts.auto_label_clusters <ckpt> \
      <run>/semantic_segmentation -k 8
the training CLI
  python -m synthesis_in_style_tpu_torch.cli.train_stylegan_2 \
      configs/stylegan/stylegan_256px.yaml --images train.json -l <dir>
the dataset CLI on one of its snapshots (`<run>/checkpoints/iter_N.pt`), the
segmenter training CLI on the dataset's pairs
  python -m synthesis_in_style_tpu_torch.cli.train \
      configs/segmenter/stylegan2_doc_ufcn_segmenter.yaml --images train.json \
      --val-images val.json --class-to-color-map configs/handwriting_colors.json -l <dir>
and page inference with its snapshot
  python -m synthesis_in_style_tpu_torch.cli.analyze_image_segments <pages> \
      -f eval.json -gt <gt> -o <out> -cds --use-device-component-filter
Their CPU counterparts, against the JAX package at small sizes:
  JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q

Rehearsing a phase on the CPU: the phase functions take the module's
DEVICE, CONFIG_256, CREATION_CONFIG, BATCH, NUM_IMAGES and NUM_CLUSTERS, so a
script that imports this file can set DEVICE = "cpu", a small generator
(CONFIG_256 image_size 32, latent_size 32, n_mlp 2, with the creation
config's layers 4 5 / 6 7), BATCH 4 and NUM_IMAGES 8, write a run directory
(`make_run_dir`) with a catalog and label map of its own, and call
`host_route_phase(run, root, fns)` with stand-in counters (objects with a
`launches` attribute; on the CPU the plain versions run, so it must count
the two generator kernels itself). Its `if __name__ == "__main__"` guard
matters: --contour-workers spawns processes that import the main module.
The discovery phase rehearses the same way: `discovery_phase(run, fns)`
with DEVICE = "cpu", that small CONFIG_256, DISCOVERY_SAMPLES 8,
DISCOVERY_BATCH 4, a smaller DISCOVERY_WARMUP, FIT_LAYER "4", STATS_LAYER
"6", SELECT_SAMPLES 8, SELECT_BATCH 4, `_no_sync` and `profile_call` stubbed, stand-in
counters that the plain bias-act and blur functions increment; then
`write_catalog(run, gen)` with the creation config's layers 4 5 / 6 7
(~10 s).
The segmenter phase rehearses the same way (`segmenter_phase`, with
SEG_OVERRIDES, PAGE_H / PAGE_W / NUM_PAGES shrunk and bench_ms,
profile_call, _no_sync and the CC kernel's backend stubbed).
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SQRT2 = 2.0**0.5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
BATCH = 16
NUM_IMAGES = 32
CONFIG_256 = {  # configs/stylegan/stylegan_256px.yaml, as JSON
    "image_size": 256, "latent_size": 512, "n_mlp": 8, "channel_multiplier": 2,
    "stylegan_variant": 2,
}
CREATION_CONFIG = {  # configs/dataset_creation/stylegan2_cluster_based_bw_hwp_wpi.json
    "class_to_color_map": {"background": "#000000", "printed_text": "#0000FF",
                           "handwritten_text": "#FF0000"},
    "keys_for_finegrained_segmentation": ["12", "13"],
    "keys_for_class_determination": ["8", "9"],
    "keys_to_merge": {},
    "segmenter_type": "black_white_handwritten_printed",
    "only_keep_overlapping": False,
    "min_class_contour_area": 50,
    "seed": 1,
}
NUM_CLUSTERS = 8
SMALL_NUMEL = 1 << 22  # below this many elements a call is timed SMALL_ITERS times
SMALL_ITERS = 200


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time per fn() call over `iters` back-to-back calls, by CUDA
    events: the device's time, or the host's dispatch where that sets the
    pace (calls of a few microseconds of device work, timed over many
    iterations so that the mean settles)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Mean device time per fn() call: the card's kernel time from
    torch.profiler over `iters` calls, without the host's dispatch between
    them (which bench_ms includes wherever it sets the pace). None if the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 / iters if busy_us > 0 else None


def queued_ms(fn, iters: int, repeats: int = 3) -> float:
    """Device time per fn() call with the host's dispatch hidden and no
    profiler: a sleep kernel holds the stream while the host queues `iters`
    calls, so CUDA events time them back to back on the card (kernels and
    the gaps between launches). The sleep is doubled until it outlasts the
    queueing; the median of `repeats` such means (the first of a process
    was seen to read 4x its neighbours). After the training runs, a
    torch.profiler profile of 20 calls was seen to hold only 8-10 of the
    launches and records of other profiles, so the phases after them time
    this way."""
    fn()
    torch.cuda.synchronize()
    cycles, means = 1 << 23, []
    while len(means) < repeats:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        marks[2].record()
        queueing_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if marks[0].elapsed_time(marks[1]) > queueing_ms:
            means.append(marks[1].elapsed_time(marks[2]) / iters)
        else:
            cycles *= 2
    return sorted(means)[repeats // 2]


def bound(nbytes: float, nops: float) -> dict:
    """The least time for the work: the larger of its bytes (each input read
    once, each output written once) over the memory rate and its operations
    over the float32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def set_tf32(enabled: bool) -> None:
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


# ---------------------------------------------------------------------------
# kernel phases


def _summary(rows, key, main, keys=("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")):
    """The kernels-line numbers of an elementwise kernel: the float32 row at
    the main shape, and the bfloat16 row there (the training path's dtype) as
    bf16_ms, bf16_device_ms and bf16_bound_ms."""
    f32 = next(r for r in rows if r[key] == main and r["dtype"] == "float32")
    bf16 = next(r for r in rows if r[key] == main and r["dtype"] == "bfloat16")
    return {**{k: f32[k] for k in keys}, "bf16_ms": bf16["ms"],
            "bf16_device_ms": bf16["device_ms"], "bf16_bound_ms": bf16["bound_ms"]}


def _bias_act_bound(x: torch.Tensor) -> dict:
    # read x, write y, read the C-wide bias; add, compare, two multiplies per element
    return bound((2 * x.numel() + x.shape[-1]) * x.element_size(), 4 * x.numel())


def _check_forward(what, x, b, tol) -> tuple:
    """The forward kernel against its plain version on x (and b or None);
    returns (max abs error, tolerance)."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        fused_leaky_relu_cuda,
        fused_leaky_relu_plain,
    )

    got = fused_leaky_relu_cuda(x, b)
    ref = fused_leaky_relu_plain(x, b)
    if got.shape != x.shape or got.dtype != x.dtype:
        raise AssertionError(f"fused_bias_act {what}: {tuple(got.shape)} {got.dtype}")
    if x.numel() == 0:
        return 0.0, 0.0
    err = (got.float() - ref.float()).abs().max().item()
    limit = tol * max(1.0, ref.float().abs().max().item())
    if not err <= limit:
        raise AssertionError(f"fused_bias_act {what}: err {err} > {limit}")
    return err, limit


BIAS_ACT_TOLERANCES = ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7))


def check_fused_bias_act(detail):
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        bias_act_geometry,
        fused_leaky_relu_cuda,
        fused_leaky_relu_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for shape in ((16, 512), (16, 256, 256, 128)):
        for dtype, tol in BIAS_ACT_TOLERANCES:
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
            err, limit = _check_forward(f"{shape} {dtype}", x, b, tol)
            iters = SMALL_ITERS if x.numel() < SMALL_NUMEL else 10
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "tolerance": limit, "iters": iters,
                   "geometry": list(bias_act_geometry(x.numel(), shape[-1], x.element_size(),
                                                      x.data_ptr(), x.data_ptr())),
                   "ms": bench_ms(lambda: fused_leaky_relu_cuda(x, b), iters),
                   "device_ms": device_ms(lambda: fused_leaky_relu_cuda(x, b)),
                   "plain_ms": bench_ms(lambda: fused_leaky_relu_plain(x, b), iters),
                   # the card's practical rate for these bytes: a copy of x
                   "copy_ms": bench_ms(lambda: torch.empty_like(x).copy_(x), iters),
                   **_bias_act_bound(x)}
            detail.append(row)
            worst = max(worst, err)
            log(f"fused_bias_act {row}")
    return {**_summary(detail, "shape", [16, 256, 256, 128]), "max_abs_err": worst}


# (name, shape, with bias, x at a storage offset of one element)
BIAS_ACT_EDGES = (
    ("C=3", (37, 3), True, False),
    ("C=8", (1000, 8), True, False),
    ("C=509", (33, 509), True, False),
    ("C=512", (129, 512), True, False),
    ("numel below one vector", (3,), True, False),
    ("no rows", (0, 8), True, False),
    ("bias=None", (16, 64, 64, 512), False, False),
    ("bias=None C=3", (37, 3), False, False),
    ("misaligned C=8", (1000, 8), True, True),
    ("misaligned C=512", (16, 8, 8, 512), True, True),
    ("misaligned bias=None", (129, 512), False, True),
)


def check_fused_bias_act_edges(detail) -> float:
    """The forward kernel against its plain version at the edges of its
    geometry, float32 (1e-5) and bfloat16 (2^-7), both x max|ref|: channel
    counts that do and do not fill a 16-byte vector, fewer elements than one
    vector, no rows, no bias, and x one element past a 16-byte boundary
    (a contiguous view at a storage offset), which must take the scalar
    route. Returns the worst error."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import bias_act_geometry

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    worst = 0.0
    for dtype, tol in BIAS_ACT_TOLERANCES:
        for name, shape, with_bias, misaligned in BIAS_ACT_EDGES:
            n = math.prod(shape)
            buf = torch.randn(n + 1, generator=g, device="cuda").to(dtype)
            x = (buf[1:] if misaligned else buf[:n].clone()).view(shape)
            b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype) if with_bias else None
            vec = bias_act_geometry(n, shape[-1], x.element_size(), x.data_ptr(), x.data_ptr())[0]
            full = 16 // x.element_size()
            want = 1 if misaligned or (shape[-1] * x.element_size()) % 16 else full
            if n and vec != want:
                raise AssertionError(f"fused_bias_act edge {name}: vector width {vec} != {want}")
            err, limit = _check_forward(f"edge {name} {dtype}", x, b, tol)
            row = {"case": name, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "bias": with_bias, "x_offset_bytes": x.data_ptr() % 16, "vec": vec,
                   "max_abs_err": err, "tolerance": limit}
            detail.append(row)
            worst = max(worst, err)
            log(f"fused_bias_act edge {row}")
    return worst


def check_fused_bias_act_path_shapes(detail, shapes, iterations: int) -> dict:
    """The forward kernel at every (shape, dtype) the training path launched
    (`shapes`: launches by key, from the measured run of `iterations`
    iterations): held against the plain version, its device time
    (`queued_ms`) beside its bound, and launches x (device_ms - bound_ms),
    the time above the bound that shape costs the run; summed, and per
    iteration."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import fused_leaky_relu_cuda

    tols = dict(BIAS_ACT_TOLERANCES)
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    excess = 0.0
    for (shape, dtype), launches in sorted(shapes.items(), key=lambda kv: -kv[1]):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
        err, limit = _check_forward(f"path {shape} {dtype}", x, b, tols[dtype])
        iters = SMALL_ITERS if x.numel() < SMALL_NUMEL else 10
        dev = queued_ms(lambda: fused_leaky_relu_cuda(x, b), iters)
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "launches": launches,
               "max_abs_err": err, "tolerance": limit, "iters": iters,
               "ms": bench_ms(lambda: fused_leaky_relu_cuda(x, b), iters), "device_ms": dev,
               **_bias_act_bound(x)}
        row["excess_ms"] = launches * (dev - row["bound_ms"])
        excess += row["excess_ms"]
        detail.append(row)
        log(f"fused_bias_act path shape {row['shape']} {row['dtype']}: launches {launches}, "
            f"ms {row['ms']:.6f}, device_ms {dev:.6f}, bound_ms {row['bound_ms']:.6f}, "
            f"launches x (device - bound) {row['excess_ms']:.6f}")
    summary = {"shapes": len(shapes), "launches": sum(shapes.values()),
               "excess_ms": excess, "excess_ms_per_iteration": excess / iterations}
    log(f"fused_bias_act on the training path: {summary}")
    return summary


def check_fused_bias_act_bwd(detail):
    """The backward kernel at the forward's shapes: y from the forward
    kernel (so its signs are the path's), g random."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        fused_leaky_relu_bwd_cuda,
        fused_leaky_relu_bwd_plain,
        fused_leaky_relu_cuda,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = 0.0
    for shape in ((16, 512), (16, 256, 256, 128)):
        for dtype, tol in BIAS_ACT_TOLERANCES:
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
            y = fused_leaky_relu_cuda(x, b)
            grad = torch.randn(shape, generator=g, device="cuda").to(dtype)
            got = fused_leaky_relu_bwd_cuda(y, grad).float()
            ref = fused_leaky_relu_bwd_plain(y, grad).float()
            err = (got - ref).abs().max().item()
            limit = tol * max(1.0, ref.abs().max().item())
            if not err <= limit:
                raise AssertionError(f"fused_bias_act_bwd {shape} {dtype}: err {err} > {limit}")

            def library():  # the nearest PyTorch calls: two of them
                return torch.ops.aten.leaky_relu_backward(grad, y, 0.2, True) * SQRT2

            iters = SMALL_ITERS if y.numel() < SMALL_NUMEL else 10
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "tolerance": limit, "iters": iters,
                   "ms": bench_ms(lambda: fused_leaky_relu_bwd_cuda(y, grad), iters),
                   "device_ms": device_ms(lambda: fused_leaky_relu_bwd_cuda(y, grad)),
                   "plain_ms": bench_ms(lambda: fused_leaky_relu_bwd_plain(y, grad), iters),
                   "library_ms": bench_ms(library, iters),
                   "library_device_ms": device_ms(library),
                   # read y and g, write dx; a compare and a multiply per element
                   **bound(3 * y.numel() * y.element_size(), 2 * y.numel())}
            detail.append(row)
            worst = max(worst, err)
            log(f"fused_bias_act_bwd {row}")
    return {**_summary(detail, "shape", [16, 256, 256, 128],
                       ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")),
            "max_abs_err": worst}


BLUR_SHAPES = ((8, 512), (16, 512), (32, 512), (64, 512), (128, 256), (256, 128))


def check_fused_blur(detail):
    """The blur tail at the six upsample shapes, float32 (the dataset path)
    and bfloat16 (training). float32: max abs error <= 1e-4 (the 16
    taps are summed in another order); bfloat16: <= 2^-7 x max|ref|, both
    against the plain version in the working type. The kernels line reports
    the 256^2 x 128 shape in float32 and bfloat16 and the worst float32
    error."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import (
        blur_demod_noise_bias_act_cuda,
        blur_demod_noise_bias_act_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for res, c in BLUR_SHAPES:
            x = torch.randn((BATCH, res + 1, res + 1, c), generator=g, device="cuda").to(dtype)
            demod = torch.rand((BATCH, c), generator=g, device="cuda") + 0.5
            noise = torch.randn((1, res, res), generator=g, device="cuda")
            bias = torch.randn((c,), generator=g, device="cuda")
            args = (x, demod, noise, bias)
            got = blur_demod_noise_bias_act_cuda(*args).float()
            ref = blur_demod_noise_bias_act_plain(*args).float()
            err = (got - ref).abs().max().item()
            limit = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.abs().max().item()
            name = str(dtype).split(".")[-1]
            if not err <= limit:
                raise AssertionError(f"fused_blur {res}x{res}x{c} {name}: err {err} > {limit}")
            out_bytes = got.numel() * x.element_size()
            in_bytes = x.numel() * x.element_size() + \
                (demod.numel() + noise.numel() + bias.numel()) * 4
            iters = SMALL_ITERS if got.numel() < SMALL_NUMEL else 10
            row = {"out": [BATCH, res, res, c], "dtype": name, "max_abs_err": err,
                   "tolerance": limit, "iters": iters,
                   "ms": bench_ms(lambda: blur_demod_noise_bias_act_cuda(*args), iters),
                   "device_ms": device_ms(lambda: blur_demod_noise_bias_act_cuda(*args)),
                   "plain_ms": bench_ms(lambda: blur_demod_noise_bias_act_plain(*args), iters),
                   # 16 multiply-adds, then demod, noise, bias, compare, two multiplies
                   **bound(in_bytes + out_bytes, 38 * got.numel())}
            detail.append(row)
            if dtype == torch.float32:
                worst = max(worst, err)
            log(f"fused_blur {row}")
    return {**_summary(detail, "out", [BATCH, 256, 256, 128]), "max_abs_err": worst}


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.detach().cpu().double() - ref.detach().double()).abs().max()
            / ref.detach().double().abs().max().clamp_min(1e-30)).item()


def check_autograd_functions(detail) -> float:
    """FusedLeakyReLUFunction and FusedBlurTailFunction on the card (kernels)
    against the same Functions fed CPU copies (plain versions), first and
    second order, TF32 off: L = sum(op(inputs) * t), its gradients (first
    order), then the gradients of R = sum(v * dL/dx^2) + sum(u * dL/d(bias
    or demod)) (second order, the R1 / path-length pattern). Relative
    tolerance 1e-4 and 1e-3 of the largest reference value. An element whose
    forward sign differs between kernel and plain version (a pre-activation
    within rounding of 0: the blur kernel sums its taps in another order)
    gets a zero cotangent and is left out of the gradient with respect to
    the cotangent, so a flipped LeakyReLU branch does not enter the
    comparison; the count of such elements is reported."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act
    from synthesis_in_style_tpu_torch.ops.fused_act import fused_leaky_relu

    g = torch.Generator().manual_seed(SEED + 8)
    cases = [("bias_act", fused_leaky_relu,
              lambda: [torch.randn((16, 256, 256, 128), generator=g),
                       torch.randn((128,), generator=g)])]
    for res, c in ((256, 128), (8, 512)):
        cases.append((f"blur_{res}", blur_demod_noise_bias_act, lambda res=res, c=c: [
            torch.randn((4, res + 1, res + 1, c), generator=g),
            torch.rand((4, c), generator=g) + 0.5,
            torch.randn((1, res, res), generator=g),
            torch.randn((c,), generator=g)]))
    worst = 0.0
    for name, op, make in cases:
        inputs = make()
        with torch.no_grad():
            y_card = op(*[a.cuda() for a in inputs]).cpu()
            y_cpu = op(*inputs)
        flipped = (y_card >= 0) != (y_cpu >= 0)
        t = torch.randn(y_cpu.shape, generator=g).masked_fill_(flipped, 0.0)
        v = torch.randn(inputs[0].shape, generator=g)
        u = torch.randn(inputs[1].shape, generator=g)
        out = {}
        for device in ("cuda", "cpu"):
            xs = [a.to(device).requires_grad_(True) for a in inputs]
            tt = t.to(device).requires_grad_(True)
            loss = (op(*xs) * tt).sum()
            first = torch.autograd.grad(loss, xs, create_graph=True)
            r = (v.to(device) * first[0] ** 2).sum() + (u.to(device) * first[1]).sum()
            second = torch.autograd.grad(r, [xs[0], xs[1], tt], allow_unused=True)
            out[device] = (first, second)
        row = {"case": name, "shape": list(inputs[0].shape), "flipped": int(flipped.sum())}
        # dR/dt of a flipped element carries that element's own branch
        for device in out:
            second = list(out[device][1])
            second[2] = second[2].masked_fill(flipped.to(second[2].device), 0.0)
            out[device] = (out[device][0], second)
        for order, tol in ((0, 1e-4), (1, 1e-3)):
            errs = []
            for got, ref in zip(out["cuda"][order], out["cpu"][order]):
                if ref is None or not ref.any():  # d/dx and d/db of the mask: 0
                    if got is not None and got.any():
                        raise AssertionError(f"{name} order {order + 1}: nonzero where 0")
                    continue
                errs.append(_rel(got, ref))
            row[f"rel_err_order{order + 1}"] = max(errs)
            if not max(errs) <= tol:
                raise AssertionError(f"{name} order {order + 1}: rel err {max(errs)} > {tol}")
            worst = max(worst, max(errs))
        detail.append(row)
        log(f"autograd Function {row}")
    return worst


def _snake(h: int, w: int) -> torch.Tensor:
    mask = torch.zeros((h, w), dtype=torch.bool)
    for row in range(0, h, 2):
        mask[row, :] = True
        if row + 1 < h:
            mask[row + 1, w - 1 if (row // 2) % 2 == 0 else 0] = True
    return mask


def _no_sync(fn):
    """fn() with every implicit device-to-host sync turned into an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _cc_cases(path_masks: torch.Tensor):
    from synthesis_in_style_tpu_torch.segmentation.device_cc import fill_holes

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ys = torch.arange(256, device="cuda")[:, None]
    xs = torch.arange(256, device="cuda")[None, :]
    cases = [(f"random{d}", torch.rand((32, 256, 256), generator=g, device="cuda") < d)
             for d in (0.2, 0.45, 0.6)]
    cases += [
        ("snake", _snake(256, 256).cuda()[None].expand(32, -1, -1).contiguous()),
        ("all_foreground", torch.ones((32, 256, 256), dtype=torch.bool, device="cuda")),
        # joined only diagonally: one component under 8, none joined under 4
        ("checkerboard", ((ys + xs) % 2 == 0)[None].expand(32, -1, -1).contiguous()),
        ("isolated_pixels", ((ys % 3 == 0) & (xs % 3 == 0))[None].expand(32, -1, -1)
         .contiguous()),
        ("ragged_3x37x53", torch.rand((3, 37, 53), generator=g, device="cuda") < 0.5),
        ("path", path_masks),
        # the shape of device_segmenter's union call: the filled union of two layers
        ("path_union_16", fill_holes(path_masks[:16] | path_masks[16:])),
        ("page_2x1024x768", torch.rand((2, 1024, 768), generator=g, device="cuda") < 0.5),
    ]
    return cases


def check_segmented_cc(detail, path_masks: torch.Tensor):
    """path_masks: (32, 256, 256) bool, the first CC input of the real back
    half (dilated, hole-filled fine-layer masks). Every kernel call runs with
    implicit syncs made errors; the timed one too (the synchronizes of the
    timing itself lie outside)."""
    from synthesis_in_style_tpu_torch.segmentation.device_cc import connected_components

    for name, mask in _cc_cases(path_masks):
        for conn in (4, 8):
            got = _no_sync(lambda: connected_components(mask, connectivity=conn,
                                                        backend="kernel"))
            ref = connected_components(mask, connectivity=conn, backend="plain")
            if not torch.equal(got, ref):
                raise AssertionError(f"segmented_cc {name} conn {conn}: labels differ")
            if name == "all_foreground" and not bool((got == 0).all()):
                raise AssertionError("segmented_cc all_foreground: labels are not all 0")
            log(f"segmented_cc {name} {tuple(mask.shape)} conn {conn}: bit-identical, "
                f"{int((got >= 0).sum())} fg px, {len(torch.unique(got[got >= 0]))} components")
    mask = path_masks
    row = {"case": "path masks, connectivity 8, one fixpoint per call",
           "shape": list(mask.shape), "max_abs_err": 0, "sync_debug_mode": "error",
           "ms": bench_ms(lambda: _no_sync(lambda: connected_components(
               mask, connectivity=8, backend="kernel")), iters=50, warmup=2),
           "device_ms": device_ms(lambda: connected_components(mask, connectivity=8,
                                                               backend="kernel")),
           "plain_ms": bench_ms(lambda: connected_components(mask, connectivity=8,
                                                             backend="plain"),
                                iters=2, warmup=1),
           # the mask read once (1 B/px), the labels written once (4 B/px); a
           # one-pass labelling compares each pixel with its 8 neighbours
           **bound(mask.numel() * 5, mask.numel() * 8)}
    detail.append(row)
    log(f"segmented_cc {row}")
    return {k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                "max_abs_err")}


# ---------------------------------------------------------------------------
# path set-up


def make_run_dir(root: Path) -> Path:
    """<root>/run/{config/config.json, checkpoints/g_ema.pt}: a randomly
    initialised 256px generator from a seeded torch.Generator."""
    from synthesis_in_style_tpu_torch.models.factory import get_generator

    run = root / "run"
    (run / "config").mkdir(parents=True)
    (run / "checkpoints").mkdir()
    (run / "config" / "config.json").write_text(json.dumps(CONFIG_256))
    gen = get_generator(CONFIG_256).init_weights(torch.Generator().manual_seed(SEED))
    torch.save({"g_ema": gen.state_dict()}, run / "checkpoints" / "g_ema.pt")
    return run


def write_catalog(run: Path, gen) -> None:
    """merged_classes_<k>.json for catalogs/<k>.npz of the discovery phase
    (the port's own fit): two clusters (the same size ranks in every layer)
    printed and handwritten text, the rest background."""
    import numpy as np

    from synthesis_in_style_tpu_torch.segmentation.factor_catalog import load_catalogs

    sem = run / "semantic_segmentation"
    catalog = load_catalogs(sem / "catalogs" / f"{NUM_CLUSTERS}.npz")
    g = torch.Generator().manual_seed(SEED + 3)
    z = torch.randn((BATCH, CONFIG_256["latent_size"]), generator=g).to(DEVICE)
    with torch.no_grad():
        _, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
    layers = CREATION_CONFIG["keys_for_class_determination"] + \
        CREATION_CONFIG["keys_for_finegrained_segmentation"]
    sizes = {}
    for layer in layers:
        assign = catalog[layer].predict(acts[int(layer)]).reshape(-1)
        sizes[layer] = torch.bincount(assign, minlength=NUM_CLUSTERS).cpu().numpy()

    def label_map(printed_rank: int, handwritten_rank: int) -> dict:
        out = {}
        for layer in layers:
            order = np.argsort(-sizes[layer])
            names = ["background"] * NUM_CLUSTERS
            names[order[printed_rank]] = "printed_text"
            names[order[handwritten_rank]] = "handwritten_text"
            out[layer] = {str(int(c)): names[c] for c in range(NUM_CLUSTERS)}
        return out

    # which size ranks become text: the pair that paints most of the probe
    # batch while the drop rule keeps at least 3/4 of it
    from synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation import (
        get_dataset_segmenter,
    )

    map_file = sem / f"merged_classes_{NUM_CLUSTERS}.json"
    map_file.write_text(json.dumps(label_map(0, 1)))
    seg = get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS), CREATION_CONFIG,
                                CONFIG_256["image_size"], sem, DEVICE)
    acts = {str(k): v for k, v in acts.items() if str(k) in seg.catalog}
    best = None
    for p_rank in range(5):
        for h_rank in range(5):
            if p_rank == h_rank:
                continue
            seg.class_label_map = _invert(label_map(p_rank, h_rank))
            idx, drop = seg._build_device_segment_fn()(acts)
            painted = (idx[~drop] > 0).float().mean().item() if (~drop).any() else 0.0
            if int(drop.sum()) <= BATCH // 4 and (best is None or painted > best[0]):
                best = (painted, p_rank, h_rank)
    if best is None:
        raise AssertionError("no label map keeps 3/4 of the probe batch")
    map_file.write_text(json.dumps(label_map(best[1], best[2])))
    log(f"catalog: text classes at cluster size ranks {best[1:]}, probe painted share "
        f"{best[0]:.4f}")


def _invert(label_map: dict) -> dict:
    """{layer: {cluster_id: class}} -> {layer: {class: [cluster_ids]}}."""
    out = {}
    for layer, sub in label_map.items():
        out[layer] = {}
        for cluster, name in sub.items():
            out[layer].setdefault(name, []).append(int(cluster))
    return out


def counters():
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        fused_leaky_relu_bwd_cuda,
        fused_leaky_relu_cuda,
    )
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act_cuda
    from synthesis_in_style_tpu_torch.ops.cuda.segmented_cc import connected_components_cuda

    # segmented_cc counts labellings (one fixpoint each), not kernel launches
    return {"fused_bias_act": fused_leaky_relu_cuda,
            "fused_bias_act_bwd": fused_leaky_relu_bwd_cuda,
            "fused_blur": blur_demod_noise_bias_act_cuda,
            "segmented_cc": connected_components_cuda}


def reference_check(run: Path) -> torch.Tensor:
    """Full-width port on the card against the same port on the CPU (plain
    versions), batch 2, TF32 off. Returns the first CC input of the card's
    back half at the path's batch (for the CC kernel phase)."""
    from synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation import (
        get_dataset_segmenter,
    )
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.segmentation.device_cc import dilate_cross, fill_holes

    ckpt = run / "checkpoints" / "g_ema.pt"
    args = argparse.Namespace(num_clusters=NUM_CLUSTERS)
    z = torch.randn((BATCH, 512), generator=torch.Generator().manual_seed(SEED + 4))
    out = {}
    for device in ("cuda", "cpu"):
        gen = load_generator(ckpt, CONFIG_256, device=device)
        seg = get_dataset_segmenter(args, CREATION_CONFIG, 256, run / "semantic_segmentation",
                                    device)
        zz = z[:2] if device == "cpu" else z
        with torch.no_grad():
            image, acts = gen([zz.to(device)], randomize_noise=False,
                              return_intermediate_activations=True)
        acts = {str(k): v for k, v in acts.items() if str(k) in seg.catalog}
        out[device] = (image, acts, seg)
    image_c, acts_c, seg_c = out["cuda"]
    image_h, acts_h, seg_h = out["cpu"]
    if not torch.isfinite(image_c).all():
        raise AssertionError("non-finite generator output on the card")
    worst = 0.0
    for name, a, b in [("image", image_c[:2], image_h)] + [
        (f"act {k}", acts_c[k][:2], acts_h[k]) for k in sorted(acts_h)
    ]:
        rel = ((a.cpu() - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        if not rel <= 1e-3:  # float32, cuDNN vs CPU convolutions, 14 layers deep
            raise AssertionError(f"{name}: card vs CPU relative error {rel} > 1e-3")
    log(f"generator 256px card vs CPU: max relative error {worst:.3g}")
    # the back half, card vs CPU, on the card's masks (batch 2)
    masks_c = seg_c.compute_masks(acts_c)
    # the two images of the batch that the card's back half paints most
    idx_full, _ = seg_c._build_device_segment_fn().segment_masks(masks_c)
    pick = torch.argsort((idx_full > 0).sum(dim=(1, 2)), descending=True)[:2]
    small = {k: m[pick] for k, m in masks_c.items()}
    idx_c, drop_c = seg_c._build_device_segment_fn().segment_masks(small)
    idx_h, drop_h = seg_h._build_device_segment_fn().segment_masks(
        {k: m.cpu() for k, m in small.items()})
    if not (torch.equal(idx_c.cpu(), idx_h) and torch.equal(drop_c.cpu(), drop_h)):
        raise AssertionError("device_segment: card and CPU differ")
    log(f"device_segment card vs CPU: bit-identical, painted share "
        f"{(idx_h > 0).float().mean().item():.4f}")
    fine = torch.stack([masks_c[(layer, "printed_text")]
                        for layer in CREATION_CONFIG["keys_for_finegrained_segmentation"]])
    return fill_holes(dilate_cross(fine.reshape(-1, 256, 256)))


def drive_path(run: Path, save_to: Path, device_contours: bool = True, workers: int = 0) -> dict:
    """The dataset CLI on the card: build_dataset timed (warm kernels), then
    the train/val split and coco_gt.json."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds

    argv = [str(run / "checkpoints" / "g_ema.pt"), str(run / "creation_config.json"),
            "-n", str(NUM_IMAGES), "-b", str(BATCH), "--num-clusters", str(NUM_CLUSTERS),
            "-s", str(save_to), "-d", DEVICE]
    if device_contours:
        argv.append("--device-contours")
    if workers:
        argv += ["--contour-workers", str(workers)]
    args = cds.build_parser().parse_args(argv)
    _sync()
    t0 = time.perf_counter()
    written = cds.build_dataset(args, CREATION_CONFIG)
    _sync()
    seconds = time.perf_counter() - t0
    args.only_create_train_val_split = True
    cds.main(args)
    return {"written": written, "seconds": seconds}


def stage_times(run: Path, save_to: Path) -> dict:
    """Per-batch wall time of each stage of the path, device work finished
    (synchronize) inside each stage: synthesis, segmentation (front half +
    back half + the transfer of palette indices), PNG writing. Mean of 3
    batches after one warm-up batch."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.utils.dataset_creation import (
        build_latent_and_noise_generator,
        make_generate_fn,
        make_image,
        save_generated_images,
    )

    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device="cuda")
    generate = make_generate_fn(gen)
    seg = cds.get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS),
                                    CREATION_CONFIG, 256, run / "semantic_segmentation", "cuda")
    stream = build_latent_and_noise_generator({"batch_size": BATCH}, seed=2, device="cuda")
    totals = {"synthesis_s": 0.0, "segmentation_s": 0.0, "png_s": 0.0}
    for step in range(4):
        t0 = time.perf_counter()
        acts, images = generate(next(stream))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        labels, drops = seg.finish_segment_on_device(seg.begin_segment_on_device(acts))
        t2 = time.perf_counter()
        save_generated_images(make_image(images), labels, step * BATCH, save_to, 1000)
        t3 = time.perf_counter()
        if step > 0:
            for key, dt in zip(totals, (t1 - t0, t2 - t1, t3 - t2)):
                totals[key] += dt / 3
    return {**totals, "batch": BATCH}


def host_route_phase(run: Path, root: Path, fns: dict) -> dict:
    """The dataset CLI without --device-contours (the host contour route):
    once measured with launch counts from 0 (the generator's two kernels
    must run, the CC kernel must not), once with --contour-workers 2 (the
    same label pixels), coco_gt.json decoded against the val labels; then
    the host route's stages timed per batch, and the host and device back
    halves on one batch of the path's own masks."""
    for fn in fns.values():
        fn.launches = 0
    path = drive_path(run, root / "generated_host", device_contours=False)
    launches = {name: fn.launches for name, fn in fns.items()}
    for name in ("fused_bias_act", "fused_blur"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the host dataset route")
    if launches["segmented_cc"] != 0:
        raise AssertionError("the host dataset route launched the CC kernel")
    n = check_outputs(root / "generated_host")
    annotations = check_coco_gt(root / "generated_host")
    workers = drive_path(run, root / "generated_host_workers", device_contours=False, workers=2)
    same_files = compare_label_pngs(root / "generated_host", root / "generated_host_workers")
    stages, masks = host_stage_times(run, root / "host_stages")
    divergence = host_vs_device(run, masks)
    out = {**path, "images_per_s": path["written"] / path["seconds"], "launches": launches,
           "pngs": n, "coco_annotations": annotations, "workers2_seconds": workers["seconds"],
           "workers2_images_per_s": workers["written"] / workers["seconds"],
           "workers2_byte_identical_files": same_files, "stages": stages,
           "host_vs_device": divergence}
    log(f"host dataset route (no --device-contours, batch {BATCH}): {path['written']} images "
        f"in {path['seconds']:.3f} s = {out['images_per_s']:.2f} images/s; with "
        f"--contour-workers 2 {out['workers2_images_per_s']:.2f} images/s (worker start "
        f"included); launches {launches}")
    log(f"host route per batch of {BATCH}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items() if k != "batch"))
    return out


def check_coco_gt(save_to: Path) -> int:
    """coco_gt.json parses, names the val split's images, and every
    annotation's RLE decodes inside its class colour in that image's label
    half: on pixels of that colour, or pixels they enclose (an annotation
    is a filled external contour, so it covers its region's holes)."""
    from scipy import ndimage

    from synthesis_in_style_tpu_torch.evaluation.coco_gt import rle_area, rle_decode
    from synthesis_in_style_tpu_torch.utils.png import read_png
    from synthesis_in_style_tpu_torch.utils.segmentation_utils import parse_color

    coco = json.loads((save_to / "coco_gt.json").read_text())
    val = json.loads((save_to / "val.json").read_text())
    if [im["file_name"] for im in coco["images"]] != [e["file_name"] for e in val]:
        raise AssertionError("coco_gt.json does not list the val split")
    colors = {c["id"]: parse_color(c["color"]) for c in coco["categories"]}
    half = CONFIG_256["image_size"]
    labels = {im["id"]: read_png(save_to / im["file_name"])[:, half:] for im in coco["images"]}
    on_colour = total = 0
    for ann in coco["annotations"]:
        mask = rle_decode(ann["segmentation"]).astype(bool)
        if not mask.any() or rle_area(ann["segmentation"]) != ann["area"]:
            raise AssertionError(f"annotation {ann['id']}: empty or wrong area")
        cls = (labels[ann["image_id"]] == colors[ann["category_id"]]).all(axis=-1)
        outside = mask & ~ndimage.binary_fill_holes(cls)
        if outside.any() or not (mask & cls).any():
            raise AssertionError(f"annotation {ann['id']}: {int(outside.sum())} pixels outside "
                                 "its class colour")
        on_colour += int((mask & cls).sum())
        total += int(mask.sum())
    log(f"coco_gt.json: {len(coco['images'])} val images, {len(coco['annotations'])} "
        f"annotations, every RLE inside its class colour ({on_colour} of {total} pixels on "
        "it, the rest in the holes they enclose)")
    return len(coco["annotations"])


def compare_label_pngs(a: Path, b: Path) -> int:
    """The same PNG files in both directories with pixel-identical label
    halves; returns how many files are also byte-identical."""
    from synthesis_in_style_tpu_torch.utils.png import read_png

    names = sorted(p.relative_to(a) for p in a.glob("**/*.png"))
    if names != sorted(p.relative_to(b) for p in b.glob("**/*.png")):
        raise AssertionError(f"{a} and {b} hold different PNG files")
    same = 0
    for name in names:
        if (a / name).read_bytes() == (b / name).read_bytes():
            same += 1
        elif not (read_png(a / name)[:, CONFIG_256["image_size"]:]
                  == read_png(b / name)[:, CONFIG_256["image_size"]:]).all():
            raise AssertionError(f"{name}: labels differ between in-process and 2 workers")
    log(f"--contour-workers 2: {len(names)} pairs, labels identical, {same} files "
        "byte-identical")
    return same


def host_stage_times(run: Path, save_to: Path):
    """Per-batch wall time of each stage of the host route (mean of 2 warm
    batches after one warm-up): synthesis, masks (front half and their copy
    to the host), host half in process, host half in 2 worker processes
    (warm), PNG writing. Returns them and the last batch's host masks."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.segmentation.contour_pool import ContourWorkerPool
    from synthesis_in_style_tpu_torch.utils.dataset_creation import (
        build_latent_and_noise_generator,
        make_generate_fn,
        make_image,
        save_generated_images,
    )

    size = CONFIG_256["image_size"]
    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device=DEVICE)
    generate = make_generate_fn(gen)
    seg = cds.get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS),
                                    CREATION_CONFIG, size, run / "semantic_segmentation", DEVICE)
    stream = build_latent_and_noise_generator(
        {"batch_size": BATCH, "latent_size": CONFIG_256["latent_size"]}, seed=2, device=DEVICE)
    keys = ("synthesis_s", "masks_s", "host_half_s", "host_half_2workers_s", "png_s")
    totals = dict.fromkeys(keys, 0.0)
    with ContourWorkerPool(seg, 2) as pool:
        for step in range(3):
            t0 = time.perf_counter()
            acts, images = generate(next(stream))
            _sync()
            t1 = time.perf_counter()
            masks = seg.finish_prepare(seg.begin_prepare(acts))
            t2 = time.perf_counter()
            labels, drops = seg.segment_prepared(
                {k: dict(v) for k, v in masks.items()}, BATCH)
            t3 = time.perf_counter()
            pool_labels, pool_drops = pool.segment_prepared(masks, BATCH)
            t4 = time.perf_counter()
            if not (pool_labels == labels).all() or sorted(pool_drops) != sorted(drops):
                raise AssertionError("host half: 2 workers and in process differ")
            save_generated_images(make_image(images), labels, step * BATCH, save_to, 1000)
            t5 = time.perf_counter()
            if step > 0:
                for key, dt in zip(keys, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                    totals[key] += dt / 2
    return {**totals, "batch": BATCH}, masks


def host_vs_device(run: Path, masks: dict) -> dict:
    """The host and the device back half on the same batch of the path's
    masks: share of pixels whose colour differs (<= 3 %, the envelope the
    JAX package pins between its two routes) and both drop lists."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
    from synthesis_in_style_tpu_torch.segmentation.device_segmenter import run_device_segment

    seg = cds.get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS),
                                    CREATION_CONFIG, CONFIG_256["image_size"],
                                    run / "semantic_segmentation", DEVICE)
    host, host_drops = seg.segment_prepared({k: dict(v) for k, v in masks.items()}, BATCH)
    device, device_drops = run_device_segment(seg, masks, BATCH)
    share = float((host != device).any(axis=-1).mean())
    out = {"pixels_differ": share, "host_drops": sorted(host_drops),
           "device_drops": sorted(device_drops),
           "host_painted": float((host != 0).any(axis=-1).mean()),
           "device_painted": float((device != 0).any(axis=-1).mean())}
    log(f"host vs device back half on one batch of the path's masks: {share:.6f} of pixels "
        f"differ (painted {out['host_painted']:.4f} / {out['device_painted']:.4f}); drops host "
        f"{out['host_drops']}, device {out['device_drops']}")
    if not share <= 0.03:
        raise AssertionError(f"host and device back halves differ on {share:.4%} of pixels")
    return out


def check_outputs(save_to: Path) -> int:
    from synthesis_in_style_tpu_torch.utils.png import read_png

    pngs = sorted(save_to.glob("**/*.png"))
    if len(pngs) < NUM_IMAGES:
        raise AssertionError(f"{len(pngs)} PNGs written, expected >= {NUM_IMAGES}")
    painted = 0
    for png in pngs:
        pair = read_png(png)
        size = CONFIG_256["image_size"]
        if pair.shape != (size, 2 * size, 3):
            raise AssertionError(f"{png}: shape {pair.shape}")
        painted += int((pair[:, size:] != 0).any())
    split = json.loads((save_to / "train.json").read_text()) + \
        json.loads((save_to / "val.json").read_text())
    if len(split) != len(pngs):
        raise AssertionError("train/val split does not cover the PNGs")
    log(f"{len(pngs)} PNG pairs ({size}x{2 * size}), {painted} with painted labels, "
        f"{sum(e['has_printed_text'] for e in split)} has_printed_text")
    return len(pngs)


# ---------------------------------------------------------------------------
# training path


class GradRecorder:
    """Stands in for a GANOptimizer: keeps the gradients, moves nothing."""

    def __init__(self, module):
        self.names = [n for n, _ in module.named_parameters()]
        self.grads = {}

    def step(self, grads):
        self.grads = dict(zip(self.names, grads))


def check_training_iteration(detail) -> float:
    """Every step of one training iteration (D, R1, G, path length, EMA) of
    the full-width 256px G and D at batch 2, float32, TF32 off, with the same
    draws: the card's gradients of every parameter against the CPU's
    (plain versions), max abs difference <= 1e-3 x max|ref|, the largest
    reference gradient of the step.
    The D and G steps must reach every parameter, nonzero in every module."""
    import copy

    from synthesis_in_style_tpu_torch.models.factory import get_discriminator, get_generator
    from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (
        GANTrainState, StyleGAN2Config, d_reg_step, d_step, draw_mix, draw_path, ema_step,
        g_reg_step, g_step,
    )

    g = torch.Generator().manual_seed(SEED + 5)
    gen = get_generator(CONFIG_256).init_weights(g)
    disc = get_discriminator(CONFIG_256).init_weights(g)
    cfg = StyleGAN2Config(freeze_noise_layers=tuple(range(6)))
    real = torch.rand((2, 256, 256, 3), generator=g) * 2 - 1
    draws = {"d_step": draw_mix(g, gen, 2, cfg), "g_step": draw_mix(g, gen, 2, cfg),
             "g_reg_step": draw_path(g, gen, 2, cfg)}

    def to(mix, device):
        return type(mix)(mix.z1.to(device), mix.z2.to(device), mix.inject_index.to(device),
                         [n.to(device) for n in mix.noise])

    grads = {}
    for device in ("cuda", "cpu"):
        state = GANTrainState(copy.deepcopy(gen).to(device), copy.deepcopy(disc).to(device),
                              copy.deepcopy(gen).to(device).requires_grad_(False),
                              GradRecorder(gen), GradRecorder(disc), torch.zeros((), device=device))
        pl_mix, pl_noise = draws["g_reg_step"]
        metrics = {}
        metrics.update(d_step(state, cfg, real.to(device), to(draws["d_step"], device)))
        d_grads = state.d_optimizer.grads
        metrics.update(d_reg_step(state, cfg, real.to(device)))
        r1_grads = state.d_optimizer.grads
        metrics.update(g_step(state, cfg, to(draws["g_step"], device)))
        g_grads = state.g_optimizer.grads
        metrics.update(g_reg_step(state, cfg, to(pl_mix, device), pl_noise.to(device)))
        pl_grads = state.g_optimizer.grads
        ema_step(state, cfg)
        grads[device] = {"d_step": d_grads, "d_reg_step": r1_grads, "g_step": g_grads,
                         "g_reg_step": pl_grads}
        grads[device]["metrics"] = {k: float(v) for k, v in metrics.items()}
    for step in ("d_step", "g_step"):  # these reach every parameter
        modules = {}
        for name, grad in grads["cuda"][step].items():
            if grad is None:
                raise AssertionError(f"{step}: no gradient for {name} on the card")
            module = ".".join(name.split(".")[:2])
            modules[module] = modules.get(module, False) or bool(grad.any())
        dead = sorted(m for m, live in modules.items() if not live)
        if dead:
            raise AssertionError(f"{step}: all-zero gradients on the card in {dead}")
    worst = 0.0
    tol = 1e-3
    for step in ("d_step", "d_reg_step", "g_step", "g_reg_step"):
        pairs = []
        for name, ref in grads["cpu"][step].items():
            got = grads["cuda"][step][name]
            if (ref is None) != (got is None):
                raise AssertionError(f"{step} {name}: gradient on one device only")
            if ref is not None:
                pairs.append((name, got.cpu(), ref))
        # max|ref| over the step's gradients: a parameter that barely moves
        # the loss (R1 through conv_in's bias: only via minibatch stddev)
        # has a gradient that is all rounding
        scale = max(ref.abs().max().item() for _, _, ref in pairs)
        step_worst, tensor_worst = 0.0, 0.0
        for name, got, ref in pairs:
            err = (got - ref).abs().max().item()
            if not err <= tol * scale:
                raise AssertionError(f"{step} {name}: card vs CPU {err} > {tol} x {scale}")
            step_worst = max(step_worst, err / scale)
            ref_max = ref.abs().max().item()
            tensor_worst = max(tensor_worst, err / ref_max if ref_max else 0.0)
        detail.append({"step": step, "max_err_over_max_ref": step_worst,
                       "worst_per_tensor_rel_err": tensor_worst, "tolerance": tol})
        worst = max(worst, step_worst)
    for key, ref in grads["cpu"]["metrics"].items():
        got = grads["cuda"]["metrics"][key]
        if not abs(got - ref) <= 1e-3 * max(1.0, abs(ref)):
            raise AssertionError(f"{key}: card {got} vs CPU {ref}")
    log(f"training iteration 256px batch 2 card vs CPU: gradients max rel err {worst:.3g}; "
        f"metrics {grads['cuda']['metrics']}")
    return worst


TRAIN_CONFIG = Path(__file__).resolve().parent / "configs" / "stylegan" / "stylegan_256px.yaml"
TRAIN_OVERRIDES = {"batch_size": 16, "max_iter": 8, "snapshot_save_iter": 8}
TRAIN_PAGES = 64
STEP_NAMES = ("d_step", "d_reg_step", "g_step", "g_reg_step", "ema_step")


def write_training_pages(root: Path) -> Path:
    """64 synthetic 256px RGB pages (light background, dark strokes) from a
    seeded numpy generator, their train.json, and the shipped 256px config
    with the smoke's batch size and iteration counts, as JSON."""
    import numpy as np
    import yaml

    from synthesis_in_style_tpu_torch.utils.png import write_png

    data = root / "pages"
    data.mkdir()
    rs = np.random.default_rng(SEED)
    names = []
    for i in range(TRAIN_PAGES):
        page = np.full((256, 256, 3), 235, np.uint8) + rs.integers(0, 20, (256, 256, 1), np.uint8)
        for _ in range(12):  # text-like dark bars
            y, x = rs.integers(8, 240), rs.integers(8, 128)
            page[y:y + 4, x:x + rs.integers(32, 120)] = rs.integers(0, 80)
        write_png(data / f"page_{i:03d}.png", page)
        names.append(f"page_{i:03d}.png")
    (data / "train.json").write_text(json.dumps(names))
    config = {**yaml.safe_load(TRAIN_CONFIG.read_text()), **TRAIN_OVERRIDES}
    (data / "config.json").write_text(json.dumps(config))
    return data


def run_training_cli(data: Path, log_dir: Path, step_seconds=None):
    """One run of the training CLI on the card. With `step_seconds` (a
    dict), every step call is bracketed by synchronizes and its seconds
    appended under its name."""
    from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as cli
    from synthesis_in_style_tpu_torch.updaters import stylegan2_updater as upd

    originals = {name: getattr(upd, name) for name in STEP_NAMES}
    if step_seconds is not None:
        def timed(name, fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                step_seconds.setdefault(name, []).append(time.perf_counter() - t0)
                return out
            return run
        for name, fn in originals.items():
            setattr(upd, name, timed(name, fn))
    try:
        argv = [str(data / "config.json"), "--images", str(data / "train.json"),
                "-l", str(log_dir), "-d", "cuda"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = cli.main(cli.resolve_log_dir(cli.build_parser().parse_args(argv)))
        torch.cuda.synchronize()
        return trainer, time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(upd, name, fn)


PORT_KERNELS = ("bias_act_fwd_kernel", "bias_act_bwd_kernel", "blur_tail_kernel",
                "cc_local_kernel", "cc_boundary_kernel", "cc_flatten_kernel")


def profile_call(fn, top: int = 12) -> dict:
    """fn() once under torch.profiler: its wall time, the device's busy
    share of it, the kernels with the most device time, and the port's own
    kernels wherever they rank."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    port = {}
    for e in kernels:
        for name in PORT_KERNELS:
            if name in e.key:
                calls, secs = port.get(name, (0, 0.0))
                port[name] = (calls + e.count, secs + e.self_device_time_total / 1e6)
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_s": e.self_device_time_total / 1e6} for e in kernels[:top]],
            "port_kernels": {k: {"calls": c, "device_s": t} for k, (c, t) in port.items()}}


def profile_iteration(trainer, top: int = 12) -> dict:
    """Two more training iterations: the first fills the loader again, the
    second runs under torch.profiler (`profile_call`)."""
    updater = trainer.updater
    updater.update()
    out = {"iteration": updater.iteration, **profile_call(updater.update, top)}
    updater.iterators["images"].close()
    return out


def check_training_run(trainer, log_dir: Path) -> dict:
    """Finite losses, D and G moved from their seeded init, a snapshot whose
    g_ema loads through the dataset path's load_generator and renders."""
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.models.factory import (
        get_discriminator, get_generator, load_generator,
    )

    (run,) = (log_dir / "stylegan2").iterdir()
    log_lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    losses = {k: v for line in log_lines for k, v in line.items() if k.startswith("train/")}
    if not losses or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"training losses not finite: {losses}")
    config = load_config_from_checkpoint(next((run / "checkpoints").glob("*.pt")))
    init = torch.Generator().manual_seed(int(config.get("seed", 0)))
    fresh_g = get_generator(config).init_weights(init)
    fresh_d = get_discriminator(config).init_weights(init)
    state = trainer.updater.state
    for name, fresh, trained in (("G", fresh_g, state.generator), ("D", fresh_d, state.discriminator)):
        moved = sum(not torch.equal(a, b.cpu())
                    for a, b in zip(fresh.parameters(), trained.parameters()))
        if moved == 0:
            raise AssertionError(f"{name}: no parameter moved")
        log(f"{name}: {moved} of {len(list(fresh.parameters()))} parameter tensors moved")
    snap = run / "checkpoints" / f"iter_{TRAIN_OVERRIDES['max_iter']:08d}.pt"
    gen = load_generator(snap, config, device="cuda")
    with torch.no_grad():
        image, _ = gen([torch.randn((1, 512), device="cuda")], randomize_noise=False)
    if image.shape != (1, 256, 256, 3) or not torch.isfinite(image).all():
        raise AssertionError(f"snapshot g_ema renders {tuple(image.shape)}, finite "
                             f"{bool(torch.isfinite(image).all())}")
    log(f"snapshot {snap.name}: g_ema loads through load_generator and renders a 256px image")
    return losses


# ---------------------------------------------------------------------------
# segmenter path: DocUFCN training on the dataset path's PNG pairs, then
# patch-tiled page inference whose small-region filter runs the CC kernel


REPO_ROOT = Path(__file__).resolve().parent
SEG_CONFIG = REPO_ROOT / "configs" / "segmenter" / "stylegan2_doc_ufcn_segmenter.yaml"
COLOR_MAP = REPO_ROOT / "configs" / "handwriting_colors.json"
SEG_OVERRIDES = {"max_iter": 16, "snapshot_save_iter": 16, "log_iter": 8}
PAGE_H, PAGE_W, NUM_PAGES = 1536, 2048, 4
SWEEP = {"min_confidence": ("0.0", "0.7"), "min_contour_area": ("0", "55")}
DEVICE = "cuda"  # the segmenter phase's device (its CPU rehearsal sets "cpu")


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def write_segmenter_config(root: Path):
    """The shipped DocUFCN config (256px, batch 8, bfloat16) as JSON, with
    16 iterations and a snapshot at 16; returns (path, config)."""
    import yaml

    config = {**yaml.safe_load(SEG_CONFIG.read_text()), **SEG_OVERRIDES}
    path = root / "docufcn_config.json"
    path.write_text(json.dumps(config))
    return path, config


def run_segmenter_training(dataset: Path, config: Path, log_dir: Path):
    """The segmenter training CLI on the card over the dataset path's PNG
    pairs (train.json; one validation pass over val.json at the end)."""
    from synthesis_in_style_tpu_torch.cli import train as cli

    argv = [str(config), "--images", str(dataset / "train.json"),
            "--val-images", str(dataset / "val.json"), "--class-to-color-map", str(COLOR_MAP),
            "-l", str(log_dir), "-ln", "docufcn", "-d", DEVICE]
    args = cli.build_parser().parse_args(argv)
    args.log_dir = str(log_dir / "run")
    _sync()
    t0 = time.perf_counter()
    trainer = cli.main(args)
    _sync()
    return trainer, time.perf_counter() - t0


def check_segmenter_run(trainer, log_dir: Path) -> Path:
    """Finite losses, a validation pass in the log, parameters moved from
    the seeded init, and the snapshot; returns the snapshot's path."""
    run = log_dir / "run"
    lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    losses = [line["loss/softmax"] for line in lines if "loss/softmax" in line]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"segmenter losses not finite: {losses}")
    evals = [line for line in lines if "evaluation/dice_weighted_avg" in line]
    if len(evals) != 1:
        raise AssertionError(f"expected one validation pass, log has {len(evals)}")
    fresh = trainer.updater.network.__class__(num_classes=3).init_weights(
        torch.Generator().manual_seed(0))
    moved = sum(not torch.equal(a, b.cpu()) for a, b in
                zip(fresh.parameters(), trainer.updater.network.parameters()))
    if moved == 0:
        raise AssertionError("DocUFCN: no parameter moved")
    snap = run / "checkpoints" / f"iter_{SEG_OVERRIDES['max_iter']:08d}.pt"
    if not snap.exists():
        raise AssertionError(f"no snapshot {snap}")
    log(f"DocUFCN: {moved} of {len(list(fresh.parameters()))} parameter tensors moved; "
        f"losses {losses}; validation {evals[0]}")
    return snap


def check_doc_ufcn_card_vs_cpu(snap: Path, dataset: Path) -> float:
    """The trained full-width DocUFCN forward (eval) on the card against the
    CPU, TF32 off, on two validation patches: max abs diff <= 1e-3 x
    max|ref|."""
    from synthesis_in_style_tpu_torch.data.segmentation_dataset import SegmentationDataset
    from synthesis_in_style_tpu_torch.models.doc_ufcn import DocUFCN
    from synthesis_in_style_tpu_torch.utils.checkpoint import load_segmenter_snapshot

    data = SegmentationDataset(dataset / "val.json", COLOR_MAP, root=dataset, image_size=256)
    x = torch.stack([data[i]["images"] for i in range(2)]).permute(0, 3, 1, 2).contiguous()
    state = load_segmenter_snapshot(snap)["segmentation_network"]

    def logits(device):
        net = DocUFCN(num_classes=3)
        net.load_state_dict(state)
        with torch.no_grad():
            return net.to(device).eval()(x.to(device)).float().cpu()

    set_tf32(False)
    try:
        card, cpu = logits(DEVICE), logits("cpu")
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.isfinite(card).all():
        raise AssertionError("DocUFCN: non-finite logits on the card")
    rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
    if not rel <= 1e-3:
        raise AssertionError(f"DocUFCN 256px card vs CPU: relative error {rel} > 1e-3")
    log(f"DocUFCN 256px (32/64/128/256) card vs CPU, float32, TF32 off: max relative error "
        f"{rel:.3g}")
    return rel


def write_pages(root: Path):
    """NUM_PAGES synthetic 2048x1536 pages (light paper, lines of dark
    printed bars and thinner handwritten strokes, specks) and their colour
    ground truth, from a seeded numpy generator."""
    import numpy as np

    from synthesis_in_style_tpu_torch.utils.png import write_png

    pages, gt = root / "doc_pages", root / "doc_pages_gt"
    pages.mkdir()
    gt.mkdir()
    rs = np.random.default_rng(SEED + 7)
    for i in range(NUM_PAGES):
        page = np.full((PAGE_H, PAGE_W, 3), 232, np.uint8) + \
            rs.integers(0, 16, (PAGE_H, PAGE_W, 1), np.uint8)
        mask = np.zeros((PAGE_H, PAGE_W, 3), np.uint8)
        for y in range(96, PAGE_H - 96, 48):
            printed = rs.random() < 0.6
            x = int(rs.integers(80, 300))
            while x < PAGE_W - 200:
                w = int(rs.integers(20, 120))
                h = 14 if printed else int(rs.integers(4, 10))
                dy = 0 if printed else int(rs.integers(-6, 7))
                page[y + dy:y + dy + h, x:x + w] = rs.integers(10, 70)
                mask[y + dy:y + dy + h, x:x + w] = (0, 0, 255) if printed else (255, 0, 0)
                x += w + int(rs.integers(8, 30))
        for _ in range(400):  # specks
            y, x = rs.integers(0, PAGE_H - 3), rs.integers(0, PAGE_W - 3)
            page[y:y + 2, x:x + 2] = rs.integers(20, 120)
        write_png(pages / f"page_{i}.png", page)
        write_png(gt / f"page_{i}_gt.png", mask)
    return pages, gt


def run_analyze(pages: Path, gt: Path, snap: Path, out: Path, sweep=SWEEP,
                device_filter: bool = True, extra=()) -> float:
    """The page inference CLI on the card (vote assembly; the device
    component filter, or the host contour filter without `device_filter`)
    over `pages`, every metric; returns its wall seconds."""
    from synthesis_in_style_tpu_torch.cli import analyze_image_segments as cli

    eval_config = out.parent / f"{out.name}_eval.json"
    eval_config.write_text(json.dumps({"checkpoint": str(snap),
                                       "class_to_color_map": str(COLOR_MAP)}))
    argv = [str(pages), "-f", str(eval_config), "-gt", str(gt), "-o", str(out),
            "-cds", "-cio", "-cpr", "-cre", "--min-confidence", *sweep["min_confidence"],
            "--min-contour-area", *sweep["min_contour_area"], "-d", DEVICE, *extra]
    if device_filter:
        argv.append("--use-device-component-filter")
    _sync()
    t0 = time.perf_counter()
    cli.main(cli.parse_and_check_arguments(argv))
    _sync()
    return time.perf_counter() - t0


def check_results(out: Path, sweep=SWEEP) -> dict:
    results = json.loads((out / "results.json").read_text())
    runs = results["runs"]
    want = len(sweep["min_confidence"]) * len(sweep["min_contour_area"])
    if len(runs) != want:
        raise AssertionError(f"results.json has {len(runs)} runs, expected {want}")
    scores = {}
    for run in runs:
        if len(run["confusion_matrices"]) != NUM_PAGES:
            raise AssertionError(f"run {run['hyperparams']}: {len(run['confusion_matrices'])} "
                                 f"pages evaluated")
        key = f"conf {run['hyperparams']['min_confidence']} area " \
              f"{run['hyperparams']['min_contour_area']}"
        scores[key] = {m: run[f"average_{m}_scores"]["weighted_avg"]["score"]
                       for m in ("dice", "iou", "precision", "recall")}
        if not all(0.0 <= v <= 1.0 for v in scores[key].values()):
            raise AssertionError(f"{key}: scores out of range {scores[key]}")
    log(f"results.json: {want} sweep runs x {NUM_PAGES} pages; weighted averages {scores}")
    return scores


def _page_segmenter(snap: Path, device: str, device_filter: bool = True):
    from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import (
        VotingAssemblySegmenter,
    )

    seg = VotingAssemblySegmenter(snap, COLOR_MAP, use_device_component_filter=device_filter,
                                  device=device)
    seg.set_hyperparams({"min_confidence": 0.7, "min_contour_area": 55})
    return seg


def page_path_numbers(snap: Path, pages: Path, detail) -> dict:
    """On the card, at min_confidence 0.7 and min_contour_area 55: pages/s
    of segment_image_classes over the pages (warm, ending in the class
    map's copy to the host), one page under torch.profiler, the CC kernel
    held bit for bit against its plain version on one batch's closed masks
    (the shape and content the page path gives it) and timed there, and one
    page card against CPU (`multi_class_page_parity`)."""
    from PIL import Image

    from synthesis_in_style_tpu_torch.segmentation import analysis_segmenter as pages_module
    from synthesis_in_style_tpu_torch.segmentation.device_cc import connected_components

    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    seg = _page_segmenter(snap, DEVICE)
    seg.segment_image_classes(images[0])
    _sync()
    t0 = time.perf_counter()
    for image in images:
        seg.segment_image_classes(image)
    seconds = time.perf_counter() - t0
    profile = profile_call(lambda: seg.segment_image_classes(images[0]))

    # the CC input of the page path: closed text masks of the first page's
    # batches at min_confidence 0.0 and 0.7, taken where the segmenter hands
    # them to filter_small_components; the batch whose foreground share is
    # nearest one half is held and timed
    captured = []
    original = pages_module.filter_small_components

    def capture(mask, min_area):
        captured.append(mask)
        return original(mask, min_area)

    pages_module.filter_small_components = capture
    try:
        for confidence in (0.0, 0.7):
            seg.set_hyperparams({"min_confidence": confidence})
            seg.segment_image_classes(images[0])
    finally:
        pages_module.filter_small_components = original
        seg.set_hyperparams({"min_confidence": 0.7})
    masks = min(captured, key=lambda m: abs(float(m.float().mean()) - 0.5))
    got = _no_sync(lambda: connected_components(masks, backend="kernel"))
    ref = connected_components(masks, backend="plain")
    if not torch.equal(got, ref):
        raise AssertionError("segmented_cc on the page path's masks: labels differ")
    own = torch.arange(masks[0].numel(), device=masks.device).view(masks.shape[1:])
    components = int((masks & (ref == own)).sum())  # roots: labelled with their own index
    cc = {"case": "page path masks (2 classes x 8 patches), connectivity 4",
          "shape": list(masks.shape), "max_abs_err": 0,
          "foreground_share": float(masks.float().mean()), "components": components,
          "ms": bench_ms(lambda: _no_sync(lambda: connected_components(
              masks, backend="kernel")), iters=50, warmup=2),
          "plain_ms": bench_ms(lambda: connected_components(masks, backend="plain"),
                               iters=2, warmup=1),
          **bound(masks.numel() * 5, masks.numel() * 4)}
    detail.append(cc)
    log(f"segmented_cc {cc}")

    parity = multi_class_page_parity(images[0])
    return {"pages": len(images), "seconds": seconds, "pages_per_s": len(images) / seconds,
            "profile": profile, "cc": cc, **parity}


PARITY_SEED = SEED + 11


def seeded_page_network(page) -> "torch.nn.Module":
    """A full-width DocUFCN (32/64/128/256, 3 classes) from a seeded
    torch.Generator whose class map is not one class: random init, running
    statistics set by one train-mode pass over (up to) 8 patches of the
    page, and
    the classifier scaled so its confidences pass 0.7 on the CPU."""
    import numpy as np

    from synthesis_in_style_tpu_torch.models.doc_ufcn import DocUFCN

    net = DocUFCN(num_classes=3, encoder_dropout=0.0, decoder_dropout=0.0)
    net.init_weights(torch.Generator().manual_seed(PARITY_SEED))
    arr = np.asarray(page.convert("RGB"), np.float32)
    corners = [(y, x) for y in range(0, arr.shape[0] - 255, 256)
               for x in range(0, arr.shape[1] - 255, 256)][:8]
    patches = torch.stack([torch.from_numpy(arr[y:y + 256, x:x + 256]) for y, x in corners])
    norms = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0  # the running statistics become this batch's
    with torch.no_grad():
        net.train()(((patches / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2))
        for m in norms:
            m.momentum = 0.1
        net.classifier.weight.mul_(PARITY_LOGIT_SCALE)
    return net.eval()


# on page 0 this gives class shares of 0.18 / 0.62 / 0.20 on the CPU at 0.7 / 55
PARITY_LOGIT_SCALE = 8.0


def multi_class_page_parity(page) -> dict:
    """One page (0.7 / 55, device filter) card against CPU with TF32 off,
    on `seeded_page_network`'s weights: two classes or more must each hold
    >= 1 % of the CPU's class map, then >= 99.9 % of class ids equal and
    >= 99.9 % of confidences within 1e-3."""
    from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import (
        VotingAssemblySegmenter,
    )

    net = seeded_page_network(page)

    def segment(device):
        seg = VotingAssemblySegmenter(
            None, COLOR_MAP, network=copy.deepcopy(net), device=device,
            config={"image_size": 256, "batch_size": SEG_OVERRIDES.get("batch_size", 8)},
            use_device_component_filter=True)
        seg.set_hyperparams({"min_confidence": 0.7, "min_contour_area": 55})
        return seg.segment_image(page)

    set_tf32(False)
    try:
        cpu = segment("cpu")
        shares = [float((cpu.argmax(-1) == k).mean()) for k in range(cpu.shape[-1])]
        if sum(share >= 0.01 for share in shares) < 2:
            raise AssertionError(f"parity network: class shares {shares}, need two >= 1 %")
        card = segment(DEVICE)
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    # the class map is segment_image_classes' argmax (numpy's and torch's
    # both take the first maximum); a confidence may differ where the
    # threshold or the area filter cuts differently by a rounding
    agree = float((card.argmax(-1) == cpu.argmax(-1)).mean())
    close = float((abs(card - cpu).max(-1) <= 1e-3).mean())
    if not (agree >= 0.999 and close >= 0.999):
        raise AssertionError(f"page card vs CPU: {agree:.6f} of class ids and {close:.6f} of "
                             f"confidences (within 1e-3) agree")
    log(f"page {page.width}x{page.height} card vs CPU (TF32 off, seeded multi-class DocUFCN): "
        f"class shares {[round(v, 4) for v in shares]}; class map {agree:.6f} of pixels agree, "
        f"confidences within 1e-3 at {close:.6f} (max abs diff {float(abs(card - cpu).max()):.3g})")
    return {"card_vs_cpu_agreement": agree, "card_vs_cpu_confidences_within_1e-3": close,
            "card_vs_cpu_class_shares": shares}


def host_filter_numbers(snap: Path, pages: Path, root: Path) -> dict:
    """Pages/s of segment_image_classes at 0.7 / 55 with the host contour
    filter (warm), and one page through the analyze CLI with every drawing
    flag: its images exist and are not empty."""
    from PIL import Image

    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    seg = _page_segmenter(snap, DEVICE, device_filter=False)
    seg.segment_image_classes(images[0])
    _sync()
    t0 = time.perf_counter()
    for image in images:
        seg.segment_image_classes(image)
    seconds = time.perf_counter() - t0

    one = root / "one_page"
    one.mkdir()
    shutil.copy(sorted(pages.glob("*.png"))[0], one / "page_0.png")
    out = root / "analyze_vis"
    vis_seconds = run_analyze(one, pages.parent / "doc_pages_gt", snap, out,
                              {"min_confidence": ("0.7",), "min_contour_area": ("55",)},
                              device_filter=False, extra=VIS_FLAGS)
    files = {p.name: p.stat().st_size for p in out.glob("*.png")}
    stem = "page_0_min_confidence_0_7_min_contour_area_55_patch_overlap_0__0_0"
    for suffix in ("segmentation", "overlay", "bboxes"):
        if not files.get(f"{stem}_{suffix}.png"):
            raise AssertionError(f"-vis wrote no {stem}_{suffix}.png: {sorted(files)}")
    log(f"host contour filter: {len(images) / seconds:.3f} pages/s ({PAGE_W}x{PAGE_H}, "
        f"0.7 / 55, segment_image_classes, warm); -vis with every drawing flag on one page "
        f"in {vis_seconds:.3f} s wrote {len(files)} images")
    return {"pages": len(images), "seconds": seconds, "pages_per_s": len(images) / seconds,
            "vis_seconds": vis_seconds, "vis_files": len(files)}


VIS_FLAGS = ("-vis", "--extract-bboxes", "--draw-patches", "--draw-bboxes-on-segmentation",
             "--overlay-segmentation")


def segmenter_breakdown(trainer, top: int = 12) -> dict:
    """The two halves of a segmenter iteration, apart: the training loader
    alone (a fresh pass: seconds to its first batch, which its workers'
    start sets, then images/s over up to 18 more batches), and the training
    step alone on one batch already on the card (10 synchronized steps,
    then one under torch.profiler)."""
    from synthesis_in_style_tpu_torch.updaters.segmentation_updater import standard_train_step

    updater = trainer.updater
    loader = updater.iterators["images"]._loader
    t0 = time.perf_counter()
    batches = iter(loader)
    batch = next(batches)
    first_s = time.perf_counter() - t0
    n = min(18, len(loader) - 1)
    t0 = time.perf_counter()
    for _ in range(n):
        next(batches)
    loader_s = time.perf_counter() - t0
    del batches
    size = batch["images"].shape[0]
    on_card = {"images": batch["images"].to(updater.device).permute(0, 3, 1, 2),
               "segmented": batch["segmented"].to(updater.device)}

    def step():
        standard_train_step(updater.network, updater.optimizer, on_card, updater.class_weights,
                            updater.compute_dtype)

    step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    _sync()
    step_s = (time.perf_counter() - t0) / 10
    out = {"loader_first_batch_s": first_s, "loader_batches": n,
           "loader_images_per_s": n * size / loader_s, "step_s": step_s,
           "step_images_per_s": size / step_s, "step_profile": profile_call(step, top)}
    log(f"segmenter iteration apart: loader first batch {first_s:.3f} s, then "
        f"{out['loader_images_per_s']:.2f} images/s over {n} batches; step alone "
        f"{step_s:.4f} s = {out['step_images_per_s']:.2f} images/s")
    return out


def segmenter_phase(root: Path, dataset: Path, fns: dict, cc_detail: list) -> dict:
    """DocUFCN training on `dataset`'s PNG pairs (warm-up run, then a
    measured run with launch counts from 0), then page inference with its
    snapshot (warm-up, then the measured sweep), then the page path's
    numbers; logs and returns them."""
    seg_config, seg_settings = write_segmenter_config(root)
    run_segmenter_training(dataset, seg_config, root / "seg_warmup")
    for fn in fns.values():
        fn.launches = 0
    trainer, cli_seconds = run_segmenter_training(dataset, seg_config, root / "seg")
    launches = {name: fn.launches for name, fn in fns.items()}
    snap = check_segmenter_run(trainer, root / "seg")
    iters = trainer.updater.iteration
    breakdown = segmenter_breakdown(trainer)
    doc_ufcn_rel = check_doc_ufcn_card_vs_cpu(snap, dataset)
    pages, pages_gt = write_pages(root)
    run_analyze(pages, pages_gt, snap, root / "analyze_warmup",
                {"min_confidence": ("0.7",), "min_contour_area": ("55",)})
    for fn in fns.values():
        fn.launches = 0
    analyze_seconds = run_analyze(pages, pages_gt, snap, root / "analyze")
    page_launches = {name: fn.launches for name, fn in fns.items()}
    page_scores = check_results(root / "analyze")
    page = page_path_numbers(snap, pages, cc_detail)
    host_sweep = {"min_confidence": ("0.7",), "min_contour_area": ("55",)}
    for fn in fns.values():
        fn.launches = 0
    host_cli_seconds = run_analyze(pages, pages_gt, snap, root / "analyze_host", host_sweep,
                                   device_filter=False)
    host_launches = {name: fn.launches for name, fn in fns.items()}
    check_results(root / "analyze_host", host_sweep)
    host_page = host_filter_numbers(snap, pages, root)

    batch = seg_settings["batch_size"]
    out = {"iterations": iters, "batch": batch, "loop_seconds": trainer.seconds,
           "cli_seconds": cli_seconds, "images_per_s": iters * batch / trainer.seconds,
           "launches": launches, **breakdown,
           "doc_ufcn_card_vs_cpu_rel_err": doc_ufcn_rel, "analyze_cli_seconds": analyze_seconds,
           "analyze_cli_pages": NUM_PAGES * len(SWEEP["min_confidence"])
           * len(SWEEP["min_contour_area"]),
           "page_launches": page_launches, "page_scores": page_scores, "page": page,
           "host_filter_cli_seconds": host_cli_seconds, "host_filter_launches": host_launches,
           "host_filter": host_page}
    log(f"segmenter training path (DocUFCN 32/64/128/256, 256px, batch {batch}, bf16, "
        f"{iters} iterations): {out['images_per_s']:.2f} training images/s "
        f"(train loop {trainer.seconds:.3f} s incl. the validation pass, whole CLI "
        f"{cli_seconds:.3f} s, warm); launches {launches}")
    log(f"page inference path ({PAGE_W}x{PAGE_H}, patches 256, batch {batch}, vote "
        f"assembly, min_confidence 0.7, min_contour_area 55): {page['pages_per_s']:.3f} pages/s "
        f"(segment_image_classes, warm); analyze CLI {out['analyze_cli_pages']} page "
        f"passes in {analyze_seconds:.3f} s; launches {page_launches}")
    log(f"page inference with the host contour filter: {host_page['pages_per_s']:.3f} pages/s "
        f"against the device filter's {page['pages_per_s']:.3f}; analyze CLI {NUM_PAGES} page "
        f"passes in {host_cli_seconds:.3f} s; launches {host_launches}")
    for name, prof in (("segmenter training step", breakdown["step_profile"]),
                       ("page", page["profile"])):
        log(f"profiled {name}: wall {prof['wall_s']:.4f} s, device busy "
            f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
            "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s"
                      for k in prof["top_kernels"]))
    return out


# ---------------------------------------------------------------------------
# cluster discovery: create_semantic_segmentation, the k-means fit card vs
# CPU, select_cluster_config and auto_label_clusters

DISCOVERY_SAMPLES = 100  # the CLI's own -n and -b
DISCOVERY_BATCH = 10
DISCOVERY_RANGE = (6, 9)  # -c 6 9: k = 6, 7, 8
DISCOVERY_WARMUP = ("-n", "10", "-c", "6", "7")
FIT_LAYER = "8"  # 64px, 512 channels
SELECT_KS = ("6", "7", "8")
SELECT_SAMPLES, SELECT_BATCH = 32, 8
STATS_LAYER, STATS_K = "12", 8  # 256px, 128 channels


def run_discovery(run: Path, destination: str, extra=()) -> dict:
    """The discovery CLI on DEVICE, timed end to end; its summary, with
    each fit's report under "fits"."""
    from synthesis_in_style_tpu_torch.cli import create_semantic_segmentation as css

    argv = [str(run / "checkpoints" / "g_ema.pt"), "-n", str(DISCOVERY_SAMPLES),
            "-b", str(DISCOVERY_BATCH), "-c", *map(str, DISCOVERY_RANGE),
            "--destination", destination, "-d", DEVICE, *extra]
    _sync()
    t0 = time.perf_counter()
    fits = []
    report = css.main(css.build_parser().parse_args(argv), fits)
    _sync()
    return {**report, "fits": fits, "cli_s": time.perf_counter() - t0}


def check_discovery_artifacts(sem: Path, num_layers: int) -> dict:
    """catalogs/<k>.npz hold `num_layers` unit-norm centres_ arrays with
    matching counts_; cluster_labels (int32 NHW), cluster_arrays (uint8
    NCHW) and cluster_images/<k>.png have the JAX CLI's shapes."""
    import numpy as np
    from PIL import Image

    size, n = CONFIG_256["image_size"], DISCOVERY_SAMPLES
    shapes = {}
    for k in range(*DISCOVERY_RANGE):
        with np.load(sem / "catalogs" / f"{k}.npz") as cat, \
                np.load(sem / "cluster_labels" / f"{k}.npz") as labels, \
                np.load(sem / "cluster_arrays" / f"{k}.npz") as arrays:
            layers = [name[len("centers_"):] for name in cat.files if name.startswith("centers_")]
            if len(layers) != num_layers or sorted(cat.files) != sorted(
                    [f"centers_{l}" for l in layers] + [f"counts_{l}" for l in layers]):
                raise AssertionError(f"catalogs/{k}.npz holds {cat.files}")
            if labels.files != layers or arrays.files != layers:
                raise AssertionError(f"k={k}: layers {labels.files} / {arrays.files} / {layers}")
            for layer in layers:
                centers, counts = cat[f"centers_{layer}"], cat[f"counts_{layer}"]
                norms = np.linalg.norm(centers, axis=1)
                if centers.shape[0] != k or counts.shape != (k,) or \
                        not np.allclose(norms, 1.0, atol=1e-4):
                    raise AssertionError(f"k={k} layer {layer}: centres {centers.shape}, counts "
                                         f"{counts.shape}, norms {norms}")
                lab, arr = labels[layer], arrays[layer]
                h = lab.shape[1]
                if lab.dtype != np.int32 or lab.shape != (n, h, h) or lab.max() >= k or \
                        arr.dtype != np.uint8 or arr.shape != (n, 3, h, h):
                    raise AssertionError(f"k={k} layer {layer}: labels {lab.dtype} {lab.shape}, "
                                         f"arrays {arr.dtype} {arr.shape}")
                shapes[layer] = (h, centers.shape[1])
        with Image.open(sem / "cluster_images" / f"{k}.png") as png:
            if png.size != (n * size, (num_layers + 1) * size) or png.mode != "RGB":
                raise AssertionError(f"cluster_images/{k}.png: {png.size} {png.mode}")
    return shapes


def _layer_activations(run: Path, layer: str) -> torch.Tensor:
    """(DISCOVERY_SAMPLES * h * w, C) activations of one layer on DEVICE,
    from the run's generator and its own seeded z stream."""
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.utils.dataset_creation import (
        build_latent_and_noise_generator,
        make_generate_fn,
    )

    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device=DEVICE)
    generate = make_generate_fn(gen)
    stream = build_latent_and_noise_generator({**CONFIG_256, "batch_size": DISCOVERY_BATCH},
                                              seed=SEED + 5, device=DEVICE)
    acts = [generate(next(stream))[0][int(layer)]
            for _ in range(DISCOVERY_SAMPLES // DISCOVERY_BATCH)]
    x = torch.cat(acts)
    return x.reshape(-1, x.shape[-1])


def fit_card_vs_cpu(run: Path, k: int = 8) -> dict:
    """One layer fitted on the card and on the CPU with the same seed (TF32
    off): equal n_steps_, >= 99.9 % of nearest-centre labels equal, centres
    within 1e-3 cosine; then one epoch on the card with every host sync an
    error."""
    from synthesis_in_style_tpu_torch.segmentation import kmeans

    torch.backends.cuda.matmul.allow_tf32 = False
    x = _layer_activations(run, FIT_LAYER)
    x_cpu = x.cpu()
    fits, seconds = {}, {}
    for name, data in (("card", x), ("cpu", x_cpu)):
        _sync()
        t0 = time.perf_counter()
        fits[name] = kmeans.MiniBatchSphericalKMeans(k, seed=SEED).fit(data)
        seconds[name] = time.perf_counter() - t0
    card, cpu = fits["card"], fits["cpu"]
    if card.n_steps_ != cpu.n_steps_:
        raise AssertionError(f"fit steps: card {card.n_steps_}, CPU {cpu.n_steps_}")
    agree = (card.predict(x).cpu() == cpu.predict(x_cpu)).double().mean().item()
    cosine = (card.cluster_centers_ * cpu.cluster_centers_).sum(axis=1).min()
    if agree < 0.999 or cosine < 1.0 - 1e-3:
        raise AssertionError(f"fit card vs CPU: labels {agree:.6f} equal, min centre cosine "
                             f"{cosine:.6f}")

    # one epoch, draws moved to the card beforehand, under the sync check
    bs = min(card.batch_size, x.shape[0])
    steps = -(-x.shape[0] // bs)
    g = torch.Generator().manual_seed(SEED)
    perm = kmeans._permutation(x.shape[0], g)
    perm = torch.cat([perm, perm[: steps * bs - x.shape[0]]]).to(x.device)
    new_idx = kmeans._reassignment_draws(steps, bs, k, g).to(x.device)
    centers = torch.as_tensor(card.cluster_centers_, device=x.device)
    counts = torch.zeros(k, device=x.device)
    _sync()
    t0 = time.perf_counter()
    _no_sync(lambda: kmeans._fit_epoch(x, perm, centers, counts, new_idx, 0, 0.01, bs=bs,
                                       reassign_every=10))
    _sync()
    epoch_s = time.perf_counter() - t0
    # the same epoch once more under the profiler: the device's busy share
    prof = profile_call(lambda: kmeans._fit_epoch(x, perm, centers, counts, new_idx, 0, 0.01,
                                                  bs=bs, reassign_every=10), top=6)
    out = {"layer": FIT_LAYER, "k": k, "points": int(x.shape[0]), "dim": int(x.shape[1]),
           "n_steps": card.n_steps_, "labels_equal": agree, "min_centre_cosine": float(cosine),
           "card_fit_s": seconds["card"], "cpu_fit_s": seconds["cpu"],
           "no_sync_epoch_steps": steps, "no_sync_epoch_s": epoch_s,
           "no_sync_epoch_ms_per_step": epoch_s / steps * 1e3, "epoch_profile": prof}
    log(f"k-means fit card vs CPU (layer {FIT_LAYER}, {out['points']} x {out['dim']}, k={k}): "
        f"{card.n_steps_} steps on both, labels {agree:.6f} equal, min centre cosine "
        f"{cosine:.7f}; card {seconds['card']:.3f} s, CPU {seconds['cpu']:.3f} s; one epoch of "
        f"{steps} steps with no host sync {epoch_s:.3f} s; profiled: wall {prof['wall_s']:.4f} s, "
        f"device busy {prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top "
        "kernels: " + "; ".join(f"{t['name']} x{t['calls']} {t['device_s']:.4f} s"
                                for t in prof["top_kernels"]))
    return out


def run_selection(run: Path, sem: Path) -> dict:
    """select_cluster_config and auto_label_clusters on DEVICE (appearance
    mode); every output exists and parses."""
    import numpy as np

    from synthesis_in_style_tpu_torch.scripts import auto_label_clusters
    from synthesis_in_style_tpu_torch.scripts import select_cluster_config as scc

    ckpt = str(run / "checkpoints" / "g_ema.pt")
    _sync()
    t0 = time.perf_counter()
    scc.main([ckpt, str(sem), "--ks", *SELECT_KS, "-n", str(SELECT_SAMPLES),
              "-b", str(SELECT_BATCH), "-d", DEVICE])
    _sync()
    select_s = time.perf_counter() - t0
    auto_label_clusters.main([ckpt, str(sem), "-k", SELECT_KS[-1], "-n", str(SELECT_SAMPLES),
                              "-b", str(SELECT_BATCH), "-d", DEVICE])
    _sync()
    label_s = time.perf_counter() - t0 - select_s
    creation = json.loads((sem / "creation_config_sel.json").read_text())
    report = json.loads((sem / "selection_report_sel.json").read_text())
    merged = json.loads((sem / "merged_classes_sel.json").read_text())
    auto = json.loads((sem / f"merged_classes_{SELECT_KS[-1]}.json").read_text())
    with np.load(sem / "catalogs" / "sel.npz") as cat:
        chosen = sorted(name[len("centers_"):] for name in cat.files
                        if name.startswith("centers_"))
    layers = creation["keys_for_class_determination"] + \
        creation["keys_for_finegrained_segmentation"]
    if sorted(set(layers)) != chosen or sorted(merged) != chosen or not report["rows"] or \
            len(auto) != len(report["rows"]) // len(SELECT_KS):
        raise AssertionError(f"selection outputs disagree: {layers}, {chosen}, {sorted(merged)}")
    log(f"select_cluster_config --ks {' '.join(SELECT_KS)} -n {SELECT_SAMPLES}: "
        f"{select_s:.3f} s, cd layers {report['cd_layers']}, fg layers {report['fg_layers']}; "
        f"auto_label_clusters -k {SELECT_KS[-1]}: {label_s:.3f} s")
    return {"select_s": select_s, "auto_label_s": label_s, "cd_layers": report["cd_layers"],
            "fg_layers": report["fg_layers"]}


def check_selection_segmenter(run: Path, sem: Path) -> float:
    """The dataset CLI's segmenter built from the selection's outputs, its
    front half (nearest-centre labels, class masks) on one batch of 2 from
    the run's generator; returns the share of pixels it labels as text."""
    from synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation import (
        get_dataset_segmenter,
    )
    from synthesis_in_style_tpu_torch.models.factory import load_generator

    creation = json.loads((sem / "creation_config_sel.json").read_text())
    layers = creation["keys_for_class_determination"] + \
        creation["keys_for_finegrained_segmentation"]
    seg = get_dataset_segmenter(argparse.Namespace(num_clusters="sel"), creation,
                                CONFIG_256["image_size"], sem, DEVICE)
    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device=DEVICE)
    z = torch.randn((2, CONFIG_256["latent_size"]),
                    generator=torch.Generator().manual_seed(SEED + 6)).to(DEVICE)
    with torch.no_grad():
        _, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
    masks = seg.compute_masks({str(k): v for k, v in acts.items() if str(k) in seg.catalog})
    if sorted({layer for layer, _ in masks}) != sorted(set(layers)):
        raise AssertionError(f"masks of the selection's segmenter: {sorted(masks)}")
    text = [m for (_, name), m in masks.items() if name != "background"]
    share = float(torch.stack(text).float().mean()) if text else 0.0
    log(f"the selection's segmenter labels {share:.4f} of one batch of 2 as text")
    return share


def stats_card_vs_cpu(run: Path, sem: Path) -> float:
    """One (layer, k) statistics table of select_cluster_config on the card
    and on the CPU from the same activations: within 1e-4 of max|table|."""
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.scripts import select_cluster_config as scc
    from synthesis_in_style_tpu_torch.segmentation.factor_catalog import load_catalogs

    args = scc.build_parser().parse_args(["ckpt", str(sem), "--ks", str(STATS_K)])
    centers = load_catalogs(sem / "catalogs" / f"{STATS_K}.npz")[STATS_LAYER].cluster_centers
    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device=DEVICE)
    z = torch.randn((SELECT_BATCH, CONFIG_256["latent_size"]),
                    generator=torch.Generator().manual_seed(SEED + 7)).to(DEVICE)
    with torch.no_grad():
        img, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
    lum = torch.clamp((img.float() + 1.0) / 2.0, 0.0, 1.0).mean(dim=-1)
    acts = {STATS_LAYER: acts[int(STATS_LAYER)]}
    run_len = scc.run_length(CONFIG_256["image_size"], args.run_len_frac)
    tables = {}
    for device in (DEVICE, "cpu"):
        a = {k: v.to(device) for k, v in acts.items()}
        feats = scc.layer_features(lum.to(device), a, args, run_len)
        h = int(a[STATS_LAYER].shape[1])
        tables[device] = scc.stats_table(a[STATS_LAYER], feats[h], centers, STATS_K).cpu()
    ref = tables["cpu"]
    rel = ((tables[DEVICE] - ref).abs().max() / ref.abs().max()).item()
    if not rel <= 1e-4:
        raise AssertionError(f"statistics table card vs CPU: relative error {rel}")
    log(f"statistics table (layer {STATS_LAYER}, k={STATS_K}) card vs CPU: max relative "
        f"error {rel:.3g}")
    return rel


def discovery_phase(run: Path, fns: dict) -> dict:
    """Cluster discovery on the run's generator: the CLI once small to warm
    up, then at -n 100 -b 10 -c 6 9 with launch counts from 0 (the
    generator's two kernels must run, CC must not); its artifacts; the fit
    card vs CPU; selection and labelling; one statistics table card vs
    CPU."""
    run_discovery(run, "discovery_warmup", DISCOVERY_WARMUP)
    for fn in fns.values():
        fn.launches = 0
    report = run_discovery(run, "semantic_segmentation")
    launches = {name: fn.launches for name, fn in fns.items()}
    for name in ("fused_bias_act", "fused_blur"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the discovery path")
    if launches["segmented_cc"] or launches["fused_bias_act_bwd"]:
        raise AssertionError(f"discovery launched CC or the backward: {launches}")
    sem = run / "semantic_segmentation"
    shapes = check_discovery_artifacts(sem, len(report["fits"]) // len(range(*DISCOVERY_RANGE)))
    fits = report["fits"]
    steps = sum(f["n_steps"] for f in fits)
    fit_sum = sum(f["fit_s"] for f in fits)
    log(f"discovery CLI (-n {DISCOVERY_SAMPLES} -b {DISCOVERY_BATCH} -c "
        f"{DISCOVERY_RANGE[0]} {DISCOVERY_RANGE[1]}, {len(shapes)} layers): generation "
        f"{report['generation_s']:.3f} s, to the device {report['to_device_s']:.3f} s, fits "
        f"{report['fit_s']:.3f} s ({steps} steps, "
        f"{fit_sum / steps * 1e3:.3f} ms per step), render and write {report['write_s']:.3f} s, "
        f"whole CLI {report['cli_s']:.3f} s; activations {report['activation_bytes']} bytes; "
        f"launches {launches}")
    for f in fits:
        log(f"  fit layer {f['layer']:>2} ({shapes[f['layer']][0]}px x {shapes[f['layer']][1]}) "
            f"k={f['k']}: {f['fit_s']:.4f} s, {f['n_steps']} steps, inertia {f['inertia']:.6f}")
    card_vs_cpu = fit_card_vs_cpu(run)
    for fn in fns.values():
        fn.launches = 0
    selection = run_selection(run, sem)
    # read before the segmenter check's own generator forward
    selection_launches = {name: fn.launches for name, fn in fns.items()}
    selection["selected_text_share"] = check_selection_segmenter(run, sem)
    stats_rel = stats_card_vs_cpu(run, sem)
    return {**{k: v for k, v in report.items() if k != "fits"}, "fits": fits,
            "fit_steps": steps, "fit_ms_per_step": fit_sum / steps * 1e3,
            "layer_shapes": shapes, "launches": launches, "fit_card_vs_cpu": card_vs_cpu,
            "selection": selection, "selection_launches": selection_launches,
            "stats_card_vs_cpu_rel_err": stats_rel}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--detail", type=Path, default=None,
                        help="write every measured row to this JSON file")
    cli = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from synthesis_in_style_tpu_torch.ops.cuda import build  # noqa: E402

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    set_tf32(False)  # parity phases compare in full float32
    detail = {name: [] for name in ("fused_bias_act", "fused_bias_act_edges",
                                    "fused_bias_act_path_shapes", "fused_bias_act_bwd",
                                    "fused_blur", "segmented_cc", "autograd",
                                    "training_iteration")}
    kernels = {"fused_bias_act": check_fused_bias_act(detail["fused_bias_act"]),
               "fused_bias_act_bwd": check_fused_bias_act_bwd(detail["fused_bias_act_bwd"]),
               "fused_blur": check_fused_blur(detail["fused_blur"])}
    edge_err = check_fused_bias_act_edges(detail["fused_bias_act_edges"])
    kernels["fused_bias_act"]["max_abs_err"] = max(kernels["fused_bias_act"]["max_abs_err"],
                                                   edge_err)
    check_autograd_functions(detail["autograd"])
    check_training_iteration(detail["training_iteration"])
    fns = counters()

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        run = make_run_dir(root)
        # cluster discovery with PyTorch's defaults (TF32 cuDNN convolutions,
        # float32 matmuls); its catalog feeds the dataset phase
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        discovery = discovery_phase(run, fns)
        set_tf32(False)
        from synthesis_in_style_tpu_torch.models.factory import load_generator

        gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device="cuda")
        write_catalog(run, gen)
        del gen
        (run / "creation_config.json").write_text(json.dumps(CREATION_CONFIG))
        path_masks = reference_check(run)
        kernels["segmented_cc"] = check_segmented_cc(detail["segmented_cc"], path_masks)

        # the paths run with PyTorch's defaults: TF32 cuDNN convolutions,
        # float32 matmuls
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        drive_path(run, root / "warmup")
        for fn in fns.values():
            fn.launches = 0
        path = drive_path(run, root / "generated_images")
        dataset_launches = {name: fn.launches for name, fn in fns.items()}
        n = check_outputs(root / "generated_images")
        stages = stage_times(run, root / "stages")
        log(f"per batch of {BATCH}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in stages.items() if k != "batch"))
        host_route = host_route_phase(run, root, fns)

        pages = write_training_pages(root)
        run_training_cli(pages, root / "train_warmup")
        for fn in fns.values():
            fn.launches = 0
        fns["fused_bias_act"].shapes.clear()
        trainer, train_wall = run_training_cli(pages, root / "train")
        training_launches = {name: fn.launches for name, fn in fns.items()}
        training_shapes = dict(fns["fused_bias_act"].shapes)
        losses = check_training_run(trainer, root / "train")
        iters = trainer.updater.iteration
        step_seconds = {}
        run_training_cli(pages, root / "train_timed", step_seconds)
        iteration_profile = profile_iteration(trainer)

        # the segmenter path on the dataset path's PNG pairs
        segmenter = segmenter_phase(root, root / "generated_images", fns,
                                    detail["segmented_cc"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    path_shapes = check_fused_bias_act_path_shapes(detail["fused_bias_act_path_shapes"],
                                                   training_shapes, iters)
    kernels["fused_bias_act"]["max_abs_err"] = max(
        [kernels["fused_bias_act"]["max_abs_err"]]
        + [r["max_abs_err"] for r in detail["fused_bias_act_path_shapes"]])
    for path_name, launches, needed in (
            ("discovery", discovery["launches"], ("fused_bias_act", "fused_blur")),
            ("selection", discovery["selection_launches"], ("fused_bias_act", "fused_blur")),
            ("dataset", dataset_launches, ("fused_bias_act", "fused_blur", "segmented_cc")),
            ("training", training_launches, ("fused_bias_act", "fused_bias_act_bwd",
                                             "fused_blur")),
            ("page_inference", segmenter["page_launches"], ("segmented_cc",))):
        for name in needed:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {path_name} path")
    log(f"dataset path: {path['written']} images in {path['seconds']:.3f} s = "
        f"{path['written'] / path['seconds']:.2f} images/s (batch {BATCH}, build_dataset "
        f"wall time, warm); launches {dataset_launches}; {n} PNG pairs checked")
    batch = TRAIN_OVERRIDES["batch_size"]
    training = {"iterations": iters, "batch": batch, "loop_seconds": trainer.seconds,
                "cli_seconds": train_wall, "iterations_per_s": iters / trainer.seconds,
                "images_per_s": iters * batch / trainer.seconds, "launches": training_launches,
                "losses": losses,
                "step_seconds_mean": {k: sum(v) / len(v) for k, v in step_seconds.items()},
                "step_calls": {k: len(v) for k, v in step_seconds.items()},
                "profile": iteration_profile, "fused_bias_act_shapes": path_shapes}
    log(f"training path (256px, batch {batch}, bf16, {iters} iterations): "
        f"{training['iterations_per_s']:.3f} iterations/s = {training['images_per_s']:.2f} "
        f"training images/s (train loop {trainer.seconds:.3f} s, whole CLI {train_wall:.3f} s, "
        f"warm); launches {training_launches}")
    log("seconds per step kind (mean per call, synchronized): " + ", ".join(
        f"{k} {v:.4f} x{training['step_calls'][k]}"
        for k, v in training["step_seconds_mean"].items()))
    prof = training["profile"]
    log(f"profiled iteration {prof['iteration']}: wall {prof['wall_s']:.4f} s, device busy "
        f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
        "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s" for k in prof["top_kernels"]))
    log("the port's kernels in that iteration: " + "; ".join(
        f"{k} x{v['calls']} {v['device_s']:.6f} s" for k, v in prof["port_kernels"].items()))

    page_cc = segmenter["page"]["cc"]
    kernels["segmented_cc"].update({"page_ms": page_cc["ms"], "page_plain_ms": page_cc["plain_ms"],
                                    "page_bound_ms": page_cc["bound_ms"]})

    sources = {"fused_bias_act": ("csrc/fused_bias_act.cu", "ops/pallas/fused_bias_act.py:61"),
               "fused_bias_act_bwd": ("csrc/fused_bias_act.cu", "ops/pallas/fused_bias_act.py:87"),
               "fused_blur": ("csrc/fused_blur.cu", "ops/pallas/fused_blur.py:223"),
               "segmented_cc": ("csrc/segmented_cc.cu", "ops/pallas/segmented_cc.py:158")}
    rows = []
    for name, (src, tpu) in sources.items():
        k = kernels[name]
        by_path = {"discovery": discovery["launches"][name],
                   "selection": discovery["selection_launches"][name],
                   "dataset": dataset_launches[name], "training": training_launches[name],
                   "segmenter_training": segmenter["launches"][name],
                   "page_inference": segmenter["page_launches"][name],
                   "dataset_host": host_route["launches"][name],
                   "page_host_filter": segmenter["host_filter_launches"][name]}
        rows.append({"name": name, "route": "cuda",
                     "source": f"synthesis_in_style_tpu_torch/{src}",
                     "replaces": f"synthesis_in_style_tpu/{tpu}",
                     "launches": sum(by_path.values()), "launches_by_path": by_path,
                     "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
                     **{key: k[key] for key in ("bf16_ms", "bf16_device_ms", "bf16_bound_ms",
                                                "page_ms", "page_plain_ms", "page_bound_ms")
                        if key in k}})
        if "bf16_ms" in k:
            log(f"{name} at the main shape: float32 {k['ms']:.4f} ms (device "
                f"{k['device_ms']}) against a bound of {k['bound_ms']:.4f} "
                f"({k['ms'] / k['bound_ms']:.2f}x); bfloat16 {k['bf16_ms']:.4f} ms (device "
                f"{k['bf16_device_ms']}) against {k['bf16_bound_ms']:.4f} "
                f"({k['bf16_ms'] / k['bf16_bound_ms']:.2f}x)")
    if cli.detail is not None:
        cli.detail.parent.mkdir(parents=True, exist_ok=True)
        cli.detail.write_text(json.dumps(
            {"card": smi, "kernels": rows, "detail": detail,
             "path": {**path, "launches": dataset_launches, "stages": stages},
             "host_route": host_route, "discovery": discovery,
             "training": training, "segmenter": segmenter}, indent=1))
    log(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
