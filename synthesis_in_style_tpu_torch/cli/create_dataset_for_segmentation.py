"""Synthesize a labelled segmentation dataset from a trained generator
(counterpart of synthesis_in_style_tpu/cli/create_dataset_for_segmentation.py).

Same flags, same output layout: sharded [image|label] PNG pairs, a 90/10
train/val split in `train.json` / `val.json` with per-image `has_<class>`
flags, and `coco_gt.json` for the validation split. Synthesis, cluster
assignment and the class masks run on `--device` (default cuda). The back
half runs on the host by default (OpenCV-free contour tracing, polygon
merge and drop rules, optionally in `--contour-workers` processes), or on
the device with `--device-contours`. The loop is pipelined: batch i+1's
synthesis and masks are dispatched before batch i's host half runs.

Not ported yet (they raise NotImplementedError, see ROADMAP.md): --quantize
and segmenter_type dataset_gan.

Usage:
  python -m synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation \\
      <checkpoint> <config.json> -n 1000 -b 16 --num-clusters 17 [--contour-workers 4]
"""

from __future__ import annotations

import argparse
import json
import random
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.evaluation.coco_gt import (
    COCOGtCreator,
    determine_classes_in_image,
    iter_through_images_in,
)
from synthesis_in_style_tpu_torch.models.factory import load_generator
from synthesis_in_style_tpu_torch.segmentation.dataset_segmenter import (
    BlackWhiteHandwrittenPrintedTextDatasetSegmenter,
)
from synthesis_in_style_tpu_torch.utils.dataset_creation import (
    build_latent_and_noise_generator,
    compute_mean_latent,
    get_base_dirs,
    make_generate_fn,
    make_image,
    save_generated_images,
)
from synthesis_in_style_tpu_torch.utils.png import read_png


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to synthesis_in_style_tpu_torch yet (see ROADMAP.md)"
    )


def check_supported(args: argparse.Namespace, creation_config: dict) -> None:
    """Raise on every option this port does not implement yet."""
    if getattr(args, "quantize", False) or creation_config.get("quantize", False):
        raise _not_ported("--quantize")
    if creation_config["segmenter_type"] != "black_white_handwritten_printed":
        raise _not_ported(f"segmenter_type {creation_config['segmenter_type']!r}")


def get_dataset_segmenter(
    args: argparse.Namespace,
    creation_config: dict,
    image_size: int,
    semantic_segmentation_base_dir: Path,
    device,
) -> BlackWhiteHandwrittenPrintedTextDatasetSegmenter:
    if "only_keep_overlapping" not in creation_config:
        raise KeyError('The key "only_keep_overlapping" must be specified in the config file.')
    return BlackWhiteHandwrittenPrintedTextDatasetSegmenter(
        base_dir=semantic_segmentation_base_dir,
        image_size=image_size,
        class_to_color_map=creation_config["class_to_color_map"],
        device=device,
        keys_to_merge=creation_config["keys_to_merge"],
        only_keep_overlapping=creation_config["only_keep_overlapping"],
        keys_for_class_determination=creation_config["keys_for_class_determination"],
        keys_for_finegrained_segmentation=creation_config["keys_for_finegrained_segmentation"],
        num_clusters=args.num_clusters,
        min_class_contour_area=creation_config["min_class_contour_area"],
        clip_to_class_regions=creation_config.get("clip_to_class_regions", False),
        fine_mask_dilation=creation_config.get("fine_mask_dilation", 0),
    )


def build_dataset(
    args: argparse.Namespace,
    creation_config: Dict,
    original_config_path: Optional[Path] = None,
) -> int:
    """Synthesize batches, segment them (host contour half, or the device
    one with --device-contours), drop the images the drop rules flag, and
    save the rest as PNG pairs until `num_images` are written. Returns the
    number written."""
    check_supported(args, creation_config)
    device = torch.device(args.device)
    config = load_config_from_checkpoint(args.checkpoint, original_config_path)
    config["batch_size"] = args.batch_size
    image_save_base_dir, semantic_segmentation_base_dir = get_base_dirs(args)

    gen = load_generator(args.checkpoint, config, device=device)
    mean_latent = compute_mean_latent(gen) if args.truncate else None
    generate = make_generate_fn(gen, truncation_latent=mean_latent,
                                gray_fetch=bool(getattr(args, "gray_fetch", False)))
    segmenter = get_dataset_segmenter(
        args, creation_config, config["image_size"], semantic_segmentation_base_dir, device
    )
    latent_stream = build_latent_and_noise_generator(
        config, seed=creation_config["seed"], device=device
    )

    use_device_contours = bool(getattr(args, "device_contours", False))
    contour_pool = None
    if not use_device_contours and getattr(args, "contour_workers", 0) > 0:
        from synthesis_in_style_tpu_torch.segmentation.contour_pool import ContourWorkerPool

        contour_pool = ContourWorkerPool(segmenter, args.contour_workers)
    contour_half = (contour_pool.segment_prepared if contour_pool is not None
                    else segmenter.segment_prepared)
    generated = 0
    pending = None  # (images, masks, batch_size) of the batch in flight

    def process(pending_batch) -> None:
        nonlocal generated
        images_dev, masks, batch_size = pending_batch
        if use_device_contours:
            label_images, image_ids_to_drop = segmenter.finish_segment_on_device(masks)
        else:
            label_images, image_ids_to_drop = contour_half(
                segmenter.finish_prepare(masks), batch_size)
        images = make_image(images_dev)
        if images.ndim == 3:  # --gray-fetch: replicate to RGB on the host
            images = np.repeat(images[..., None], 3, axis=-1)
        images = np.delete(images, image_ids_to_drop, axis=0)
        label_images = np.delete(label_images, image_ids_to_drop, axis=0)
        if len(label_images) > 0:
            save_generated_images(images, label_images, generated, image_save_base_dir,
                                  args.num_images)
        generated += len(label_images)
        print(f"\rCreating images: {min(generated, args.num_images)}/{args.num_images}",
              end="", flush=True)

    try:
        while generated < args.num_images or pending is not None:
            # the batch in flight counts toward num_images, so the pipeline
            # dispatches no extra batch; if drops shrink it, the loop
            # condition dispatches more
            in_flight = pending[2] if pending is not None else 0
            new_pending = None
            if generated + in_flight < args.num_images:
                z = next(latent_stream)
                activations, images = generate(z)
                images = _start_copy(images)  # ahead of the masks' copy and its event
                if use_device_contours:
                    masks = segmenter.begin_segment_on_device(activations)
                else:
                    masks = segmenter.begin_prepare(activations)
                new_pending = (images, masks, int(z.shape[0]))
            if pending is not None:
                process(pending)
            pending = new_pending
        print()
    finally:
        # the spawned workers are reaped also when the loop raises
        if contour_pool is not None:
            contour_pool.shutdown()
    return generated


def _start_copy(images: torch.Tensor):
    """Start the copy of a batch of uint8 images to the host without
    waiting (on the card: into pinned memory, ordered before the next
    batch's synthesis). `process` reads it only after waiting for the
    batch's masks, which were queued after it."""
    if images.device.type != "cuda":
        return images
    host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
    host.copy_(images, non_blocking=True)
    return host


def create_dataset_json_data(
    image_paths: List[Path], image_root: Path, class_to_color_map: Dict
) -> Tuple[List[dict], bool]:
    """[{file_name, has_<class>...}] for the given PNG pairs; (partial list,
    False) if reading one failed."""
    dataset_data = []
    try:
        for image_path in image_paths:
            data = {"file_name": str(image_path.relative_to(image_root))}
            data.update(determine_classes_in_image(read_png(image_path), class_to_color_map))
            dataset_data.append(data)
    except (OSError, ValueError):
        print(traceback.format_exc())
        return dataset_data, False
    return dataset_data, True


def main(args: argparse.Namespace) -> None:
    with open(args.config) as f:
        creation_config = json.load(f)

    if not args.only_create_train_val_split:
        build_dataset(args, creation_config, original_config_path=args.original_config_path)

    image_save_base_dir, _ = get_base_dirs(args)
    generated_images = list(iter_through_images_in(image_save_base_dir))
    random.seed(creation_config["seed"])
    random.shuffle(generated_images)

    split_index = int(len(generated_images) * 0.9)
    color_map = creation_config["class_to_color_map"]
    validation_images = generated_images[split_index:]
    for name, paths in (("train.json", generated_images[:split_index]),
                        ("val.json", validation_images)):
        gt, success = create_dataset_json_data(paths, image_save_base_dir, color_map)
        with (image_save_base_dir / (name if success else name + ".part")).open("w") as f:
            json.dump(gt, f)

    coco_creator = COCOGtCreator(color_map, image_root=image_save_base_dir)
    coco_gt = coco_creator.create_coco_gt_from_image_paths(validation_images)
    with (image_save_base_dir / "coco_gt.json").open("w") as f:
        json.dump(coco_gt, f)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate a synthetic dataset using a trained StyleGAN "
        "model and the labelled intermediate layers specified in a config file."
    )
    parser.add_argument("checkpoint", help="Path to trained generator checkpoint (.pt or .npz)")
    parser.add_argument("config", help="path to json config for generation")
    parser.add_argument("-op", "--original-config-path", type=Path, default=None)
    parser.add_argument("-n", "--num-images", type=int, default=100)
    parser.add_argument("-s", "--save-to", default=None)
    parser.add_argument("-b", "--batch-size", default=10, type=int)
    parser.add_argument("--only-create-train-val-split", action="store_true", default=False)
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--truncate", action="store_true", default=False)
    parser.add_argument("--quantize", action="store_true", default=False,
                        help="not ported yet: raises NotImplementedError")
    parser.add_argument("--gray-fetch", action="store_true", default=False,
                        help="fetch one luminance channel from the device and "
                        "replicate it to RGB on the host")
    parser.add_argument("--contour-workers", type=int, default=0,
                        help="worker processes for the host contour half (0 = in "
                        "process); ignored with --device-contours")
    parser.add_argument("--device-contours", action="store_true", default=False,
                        help="run the rasterized contour back half on the device: only "
                        "palette indices and drop flags reach the host; its areas are "
                        "pixel counts where the host route measures polygon areas")
    parser.add_argument(
        "--num-clusters",
        type=lambda s: int(s) if s.lstrip("-").isdigit() else s,
        default=-1,
    )
    parser.add_argument("--classifier-path", default=None)
    parser.add_argument("-ssd", "--semantic-segmentation-base-dir", type=Path, default=None)
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to synthesize and segment on (default cuda)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
