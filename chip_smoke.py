"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--detail PATH]

1. Builds the three hand-written kernels from synthesis_in_style_tpu_torch/csrc
   (nvcc, one process per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the dataset path gives it, with TF32 off for both:
   fused bias-act at (16, 512) and (16, 256, 256, 128) in float32 and
   bfloat16; the fused blur tail at the six upsample shapes of the 256px
   generator; connected components on random masks, on a 1-px snake and on
   masks of the real path at (32, 256, 256), 4- and 8-connected, bit-identical.
   Each kernel is timed beside its plain version and its bound.
3. Holds the whole port at full 256px width against itself on the CPU (the
   plain versions) for a batch of 2: generator image and activations, and the
   device back half bit for bit.
4. Drives the dataset CLI (`create_dataset_for_segmentation --device-contours`)
   with a randomly initialised 256px StyleGAN2 (seeded torch.Generator), a
   synthetic catalog (centres from that generator's activations) and label
   map, batch 16, 32 images; once to warm up, once measured, with every
   kernel's launch count set to 0 just before and read just after. cuDNN runs
   this phase with PyTorch's defaults (TF32 convolutions).

The last lines are the card's name and power limit, a JSON line of per-kernel
numbers, and {"ok": true, "device": {...}}. Any failed phase raises, and the
script exits non-zero; without a CUDA device it exits 2 before any phase.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

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


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
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


def check_fused_bias_act(detail):
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        fused_leaky_relu_cuda,
        fused_leaky_relu_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for shape in ((16, 512), (16, 256, 256, 128)):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
            got = fused_leaky_relu_cuda(x, b).float()
            ref = fused_leaky_relu_plain(x, b).float()
            err = (got - ref).abs().max().item()
            limit = tol * max(1.0, ref.abs().max().item())
            if not err <= limit:
                raise AssertionError(f"fused_bias_act {shape} {dtype}: err {err} > {limit}")
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "tolerance": limit,
                   "ms": bench_ms(lambda: fused_leaky_relu_cuda(x, b)),
                   "plain_ms": bench_ms(lambda: fused_leaky_relu_plain(x, b)),
                   # add, compare, two multiplies per element
                   **bound(2 * x.numel() * x.element_size() + b.numel() * b.element_size(),
                           4 * x.numel())}
            detail.append(row)
            worst = max(worst, err)
            log(f"fused_bias_act {row}")
    main = next(r for r in detail if r["shape"] == [16, 256, 256, 128] and r["dtype"] == "float32")
    return {**{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "max_abs_err": worst}


BLUR_SHAPES = ((8, 512), (16, 512), (32, 512), (64, 512), (128, 256), (256, 128))


def check_fused_blur(detail):
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import (
        blur_demod_noise_bias_act_cuda,
        blur_demod_noise_bias_act_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = 0.0
    for res, c in BLUR_SHAPES:
        x = torch.randn((BATCH, res + 1, res + 1, c), generator=g, device="cuda")
        demod = torch.rand((BATCH, c), generator=g, device="cuda") + 0.5
        noise = torch.randn((1, res, res), generator=g, device="cuda")
        bias = torch.randn((c,), generator=g, device="cuda")
        args = (x, demod, noise, bias)
        got = blur_demod_noise_bias_act_cuda(*args)
        ref = blur_demod_noise_bias_act_plain(*args)
        err = (got - ref).abs().max().item()
        if not err <= 1e-4:  # float32; the 16 taps are summed in another order
            raise AssertionError(f"fused_blur {res}x{res}x{c}: err {err} > 1e-4")
        out_bytes = got.numel() * 4
        in_bytes = (x.numel() + demod.numel() + noise.numel() + bias.numel()) * 4
        row = {"out": [BATCH, res, res, c], "max_abs_err": err, "tolerance": 1e-4,
               "ms": bench_ms(lambda: blur_demod_noise_bias_act_cuda(*args)),
               "plain_ms": bench_ms(lambda: blur_demod_noise_bias_act_plain(*args)),
               # 16 multiply-adds, then demod, noise, bias, compare, two multiplies
               **bound(in_bytes + out_bytes, 38 * got.numel())}
        detail.append(row)
        worst = max(worst, err)
        log(f"fused_blur {row}")
    main = detail[-1]  # the 256x256x128 layer, the largest
    return {**{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "max_abs_err": worst}


def _snake(h: int, w: int) -> torch.Tensor:
    mask = torch.zeros((h, w), dtype=torch.bool)
    for row in range(0, h, 2):
        mask[row, :] = True
        if row + 1 < h:
            mask[row + 1, w - 1 if (row // 2) % 2 == 0 else 0] = True
    return mask


def check_segmented_cc(detail, path_masks: torch.Tensor):
    """path_masks: (32, 256, 256) bool, the first CC input of the real back
    half (dilated, hole-filled fine-layer masks)."""
    from synthesis_in_style_tpu_torch.segmentation.device_cc import connected_components

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [(f"random{d}", torch.rand((32, 256, 256), generator=g, device="cuda") < d)
             for d in (0.2, 0.45, 0.6)]
    cases.append(("snake", _snake(256, 256).cuda()[None].expand(32, -1, -1).contiguous()))
    cases.append(("path", path_masks))
    for name, mask in cases:
        for conn in (4, 8):
            got = connected_components(mask, connectivity=conn, backend="kernel")
            ref = connected_components(mask, connectivity=conn, backend="plain")
            if not torch.equal(got, ref):
                raise AssertionError(f"segmented_cc {name} conn {conn}: labels differ")
            log(f"segmented_cc {name} conn {conn}: bit-identical, "
                f"{int((got >= 0).sum())} fg px, {len(torch.unique(got)) - 1} components")
    mask = path_masks
    row = {"case": "path masks, connectivity 8", "shape": list(mask.shape), "max_abs_err": 0,
           "ms": bench_ms(lambda: connected_components(mask, connectivity=8, backend="kernel"),
                          iters=5, warmup=1),
           "plain_ms": bench_ms(lambda: connected_components(mask, connectivity=8,
                                                             backend="plain"),
                                iters=2, warmup=1),
           # the mask read once (1 B/px), the labels written once (4 B/px); a
           # one-pass labelling compares each pixel with its 8 neighbours
           **bound(mask.numel() * 5, mask.numel() * 8)}
    detail.append(row)
    log(f"segmented_cc {row}")
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}


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
    """catalogs/<k>.npz: per layer, a few Lloyd steps from centres sampled
    among real activation pixels of the generator; merged_classes_<k>.json:
    two clusters (the same size ranks in every layer) printed and handwritten
    text, the rest background."""
    import numpy as np

    from synthesis_in_style_tpu_torch.segmentation.kmeans import assign_euclidean

    sem = run / "semantic_segmentation"
    (sem / "catalogs").mkdir(parents=True)
    g = torch.Generator().manual_seed(SEED + 3)
    z = torch.randn((BATCH, 512), generator=g).cuda()
    with torch.no_grad():
        _, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
    layers = CREATION_CONFIG["keys_for_class_determination"] + \
        CREATION_CONFIG["keys_for_finegrained_segmentation"]
    arrays, sizes = {}, {}
    for layer in layers:
        flat = acts[int(layer)].reshape(-1, acts[int(layer)].shape[-1])
        flat = flat[torch.randperm(len(flat), generator=g)[:65536].cuda()]
        centers = flat[torch.randperm(len(flat), generator=g)[:NUM_CLUSTERS].cuda()]
        for _ in range(10):
            assign = assign_euclidean(flat, centers)
            for i in range(NUM_CLUSTERS):
                if (assign == i).any():
                    centers[i] = flat[assign == i].mean(0)
        arrays[f"centers_{layer}"] = centers.cpu().numpy()
        sizes[layer] = torch.bincount(assign, minlength=NUM_CLUSTERS).cpu().numpy()
    np.savez(sem / "catalogs" / f"{NUM_CLUSTERS}.npz", **arrays)

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
                                256, sem, "cuda")
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
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import fused_leaky_relu_cuda
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act_cuda
    from synthesis_in_style_tpu_torch.ops.cuda.segmented_cc import cc_sweeps_cuda

    return {"fused_bias_act": fused_leaky_relu_cuda, "fused_blur": blur_demod_noise_bias_act_cuda,
            "segmented_cc": cc_sweeps_cuda}


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


def drive_path(run: Path, save_to: Path) -> dict:
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds

    argv = [str(run / "checkpoints" / "g_ema.pt"), str(run / "creation_config.json"),
            "-n", str(NUM_IMAGES), "-b", str(BATCH), "--num-clusters", str(NUM_CLUSTERS),
            "--device-contours", "-s", str(save_to), "-d", "cuda"]
    args = cds.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = cds.build_dataset(args, CREATION_CONFIG)
    torch.cuda.synchronize()
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


def check_outputs(save_to: Path) -> int:
    from synthesis_in_style_tpu_torch.utils.png import read_png

    pngs = sorted(save_to.glob("**/*.png"))
    if len(pngs) < NUM_IMAGES:
        raise AssertionError(f"{len(pngs)} PNGs written, expected >= {NUM_IMAGES}")
    painted = 0
    for png in pngs:
        pair = read_png(png)
        if pair.shape != (256, 512, 3):
            raise AssertionError(f"{png}: shape {pair.shape}")
        painted += int((pair[:, 256:] != 0).any())
    split = json.loads((save_to / "train.json").read_text()) + \
        json.loads((save_to / "val.json").read_text())
    if len(split) != len(pngs):
        raise AssertionError("train/val split does not cover the PNGs")
    log(f"{len(pngs)} PNG pairs (256x512), {painted} with painted labels, "
        f"{sum(e['has_printed_text'] for e in split)} has_printed_text")
    return len(pngs)


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
    detail = {"fused_bias_act": [], "fused_blur": [], "segmented_cc": []}
    kernels = {"fused_bias_act": check_fused_bias_act(detail["fused_bias_act"]),
               "fused_blur": check_fused_blur(detail["fused_blur"])}

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        run = make_run_dir(root)
        from synthesis_in_style_tpu_torch.models.factory import load_generator

        gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device="cuda")
        write_catalog(run, gen)
        del gen
        (run / "creation_config.json").write_text(json.dumps(CREATION_CONFIG))
        path_masks = reference_check(run)
        kernels["segmented_cc"] = check_segmented_cc(detail["segmented_cc"], path_masks)

        set_tf32(True)  # the path runs with PyTorch's default cuDNN TF32 convolutions
        torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default for matmuls
        drive_path(run, root / "warmup")
        fns = counters()
        for fn in fns.values():
            fn.launches = 0
        path = drive_path(run, root / "generated_images")
        launches = {name: fn.launches for name, fn in fns.items()}
        n = check_outputs(root / "generated_images")
        stages = stage_times(run, root / "stages")
        log(f"per batch of {BATCH}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in stages.items() if k != "batch"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log(f"path: {path['written']} images in {path['seconds']:.3f} s = "
        f"{path['written'] / path['seconds']:.2f} images/s (batch {BATCH}, build_dataset "
        f"wall time, warm); launches {launches}; {n} PNG pairs checked")

    sources = {"fused_bias_act": ("csrc/fused_bias_act.cu", "ops/pallas/fused_bias_act.py:61"),
               "fused_blur": ("csrc/fused_blur.cu", "ops/pallas/fused_blur.py:223"),
               "segmented_cc": ("csrc/segmented_cc.cu", "ops/pallas/segmented_cc.py:158")}
    rows = []
    for name, (src, tpu) in sources.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"synthesis_in_style_tpu_torch/{src}",
                     "replaces": f"synthesis_in_style_tpu/{tpu}",
                     "launches": launches[name], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    if cli.detail is not None:
        cli.detail.parent.mkdir(parents=True, exist_ok=True)
        cli.detail.write_text(json.dumps({"card": smi, "kernels": rows, "detail": detail,
                                          "path": {**path, "launches": launches, "stages": stages}}, indent=1))
    log(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
