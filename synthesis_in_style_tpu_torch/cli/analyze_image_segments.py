"""Patch-tiled page inference, hyperparameter sweep and metric evaluation
(counterpart of synthesis_in_style_tpu/cli/analyze_image_segments.py).

The same flags, sweep (min_confidence x min_contour_area x patch overlap),
ground-truth loading (`<gt_dir>/<stem>_gt.png` colour masks) and
`results.json` layout as the JAX CLI (per-image confusion matrices, per-image
and global dice / IoU / precision / recall, the abort / append / overwrite
protocol), plus `-d/--device` (default cuda). Pages are segmented with the
summed-vote assembly. A `min_contour_area` above 0 runs the JAX package's
host small-contour filter (polygon areas, on the OpenCV-free tracer of
utils/contour_ops.py), or with `--use-device-component-filter` the device
filter (pixel areas; on the card the union-find CC kernel). `-vis` writes
the JAX CLI's images: `<stem>_<config>_segmentation.png` (with
`--show-confidence` shading, `--draw-patches` grey patch outlines and
`--draw-bboxes-on-segmentation` red boxes), `_overlay.png`
(`--overlay-segmentation`), `_bboxes.png` (`--extract-bboxes`, `-b`, `-c`)
and the `_bbox_NNNN.png` / `_contour_NNNN.png` crops (`-b`, `-c`).

`--fused-page-inference` runs each page as one page program (a CUDA graph
per page tiling on the card; the device component filter whenever the area
is above 0). With it, `--pages-per-batch N` (N > 1, no `-vis`) is
throughput mode: pages load in chunks of 4N and are segmented N to a graph
replay, pages of other sizes padded to a bucket of `--bucket-quantum`
pixels (0: the patch size; negative: exact tilings only).
`--serving-dtype bfloat16` runs the network in bfloat16. The config file's
`fused_page_inference`, `pages_per_batch` and `serving_dtype` keys set the
same.

`--quantize` (or `quantize: true` in the config file) serves a DocUFCN with
static w8a8 int8, calibrated on the first page; it excludes
`--serving-dtype bfloat16`.

Usage:
  python -m synthesis_in_style_tpu_torch.cli.analyze_image_segments <image_dir> \\
      -f eval_config.json -gt gt_dir -o out -cds -cio --min-confidence 0.5 0.7 \\
      --min-contour-area 0 55 [--use-device-component-filter] [-vis ...] [-d cuda] \\
      [--fused-page-inference --pages-per-batch 4] [--serving-dtype bfloat16]
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from synthesis_in_style_tpu_torch.data.json_dataset import is_image
from synthesis_in_style_tpu_torch.evaluation.metrics import (
    calculate_confusion_matrix,
    calculate_metric,
)
from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import VotingAssemblySegmenter
from synthesis_in_style_tpu_torch.utils.contour_ops import (
    bounding_rect,
    draw_contour_filled,
    draw_rectangle,
    find_contours,
)
from synthesis_in_style_tpu_torch.utils.png import write_png
from synthesis_in_style_tpu_torch.utils.segmentation_utils import (
    segmentation_image_to_class_image,
)
from synthesis_in_style_tpu_torch.visualization.utils import network_output_to_color_image

def create_hyperparam_configs(args) -> tuple:
    overlap = list(itertools.product(args.absolute_patch_overlap, args.patch_overlap_factor))
    combos = list(itertools.product(args.min_confidence, args.min_contour_area, overlap))
    names = ("min_confidence", "min_contour_area", "patch_overlap")
    return tuple({k: v for k, v in zip(names, combo)} for combo in combos)


def prepare_results(handle_existing: str, output_json_path: Path, model_config: dict,
                    segmenter_config: dict, class_to_color_map: dict) -> dict:
    if output_json_path.exists() and handle_existing != "overwrite":
        assert handle_existing != "abort", (
            f"{output_json_path} already exists and --handle-existing is set to 'abort'"
        )
        with open(output_json_path) as old_json:
            results = json.load(old_json)
        assert results["general_config"]["experiment_config"] == model_config, (
            "The previously saved experiment config does not match the current one. Use a "
            "new output dir instead of setting --handle-existing to append."
        )
        return results
    return {
        "general_config": {
            "experiment_config": model_config,
            "model_config": {k: v for k, v in segmenter_config.items()
                             if isinstance(v, (str, int, float, bool, list, dict, type(None)))},
            "class_to_color_map": class_to_color_map,
        },
        "runs": [],
    }


def get_string_representation_of_config(hyperparam_config: Dict) -> str:
    return "_".join(re.sub(r"[,\s.]", "_", re.sub(r"[()]", "", f"{k}_{v}"))
                    for k, v in hyperparam_config.items())


def load_ground_truth_classes(image_path: Path, ground_truth_dir: Path,
                              class_to_color_map: dict) -> np.ndarray:
    """`<ground_truth_dir>/<stem>_gt.png` colour mask -> (H, W) class ids."""
    from PIL import Image

    gt_path = Path(ground_truth_dir) / f"{image_path.stem}_gt.png"
    assert gt_path.exists(), (
        f"The following ground truth image does not exist: {gt_path}. Is it a png?"
    )
    gt = np.asarray(Image.open(gt_path).convert("RGB"))
    return segmentation_image_to_class_image(gt, class_to_color_map)


def resize_image(image, new_dimensions):
    """Resize to [height, width]; -1 keeps the aspect ratio (Lanczos)."""
    from PIL import Image

    assert any(size > 0 for size in new_dimensions), (
        "One of the given resize dimensions has to be greater than 0."
    )
    if new_dimensions[0] == -1:
        new_dimensions = (int(new_dimensions[1] * image.height / image.width), new_dimensions[1])
    elif new_dimensions[1] == -1:
        new_dimensions = (new_dimensions[0], int(new_dimensions[0] * image.width / image.height))
    return image.resize((new_dimensions[1], new_dimensions[0]), Image.LANCZOS)


def visualize_segmentation(assembled_prediction: np.ndarray, image, segmenter, args,
                           class_to_color_map: dict, image_prefix: str) -> None:
    """The colour render (optionally confidence-shaded), with patch outlines
    and bounding boxes drawn as asked, the overlay, the page with the boxes
    of every external contour of each non-background class, and their
    crops, written as the JAX CLI names them."""
    colored = network_output_to_color_image(
        assembled_prediction[None], class_to_color_map,
        show_confidence_in_segmentation=args.show_confidence)[0]
    out_dir = Path(args.output_dir)
    base = np.asarray(image.convert("RGB"))

    if args.overlay_segmentation:
        overlay = (0.5 * base + 0.5 * colored).astype(np.uint8)
        write_png(out_dir / f"{image_prefix}_overlay.png", overlay)

    render = colored.copy()
    if args.draw_patches:
        for bbox in segmenter.calculate_bboxes_for_patches(*image.size):
            draw_rectangle(render, (bbox.left, bbox.top),
                           (min(bbox.right, render.shape[1] - 1),
                            min(bbox.bottom, render.shape[0] - 1)), (128, 128, 128))

    if args.extract_bboxes or args.save_bboxes or args.save_contours:
        predicted = np.argmax(assembled_prediction, axis=-1).astype(np.uint8)
        annotated = base.copy()
        box_id = 0
        for class_id in range(1, assembled_prediction.shape[-1]):
            mask = (predicted == class_id).astype(np.uint8)
            for contour in find_contours(mask, "simple"):
                x, y, w, h = bounding_rect(contour)
                draw_rectangle(annotated, (x, y), (x + w, y + h), (255, 0, 0))
                if args.draw_bboxes_on_segmentation:
                    draw_rectangle(render, (x, y), (x + w, y + h), (255, 0, 0))
                if args.save_bboxes:
                    write_png(out_dir / f"{image_prefix}_bbox_{box_id:04d}.png",
                              np.ascontiguousarray(base[y: y + h, x: x + w]))
                if args.save_contours:
                    crop_mask = np.zeros(mask.shape, np.uint8)
                    draw_contour_filled(crop_mask, contour, 1)
                    crop = base * crop_mask[:, :, None]
                    write_png(out_dir / f"{image_prefix}_contour_{box_id:04d}.png",
                              np.ascontiguousarray(crop[y: y + h, x: x + w]))
                box_id += 1
        write_png(out_dir / f"{image_prefix}_bboxes.png", annotated)

    write_png(out_dir / f"{image_prefix}_segmentation.png", render)


def main(args: argparse.Namespace) -> None:
    from PIL import Image, UnidentifiedImageError

    with open(args.config_file) as f:
        model_config = json.load(f)
    serving_dtype = args.serving_dtype or model_config.get("serving_dtype")
    if serving_dtype not in (None, "float32", "f32") and (
            args.quantize or model_config.get("quantize")):
        raise ValueError("--serving-dtype and --quantize are mutually exclusive")
    segmenter = VotingAssemblySegmenter(
        model_config["checkpoint"],
        class_to_color_map=model_config["class_to_color_map"],
        original_config_path=args.original_config_path,
        max_image_size=int(model_config.get("max_image_size", 0)) or None,
        use_device_component_filter=(args.use_device_component_filter or bool(
            model_config.get("use_device_component_filter", False))),
        fused_page_inference=(args.fused_page_inference
                              or bool(model_config.get("fused_page_inference", False))),
        quantized=bool(args.quantize or model_config.get("quantize", False)),
        serving_dtype=serving_dtype,
        device=args.device,
    )
    class_to_color_map = segmenter.class_to_color_map
    class_names = list(class_to_color_map.keys())
    num_classes = segmenter.config.get("num_classes", len(class_to_color_map))
    assert len(class_to_color_map) == num_classes, (
        "Number of classes in color map and segmenter differs."
    )

    hyperparam_configs = create_hyperparam_configs(args)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    output_json_path = args.output_dir / "results.json"
    scores_to_calculate = {
        "dice": args.calculate_dice_score,
        "iou": args.calculate_iou,
        "precision": args.calculate_precision,
        "recall": args.calculate_recall,
    }
    evaluate = any(scores_to_calculate.values())
    if evaluate:
        results = prepare_results(args.handle_existing, output_json_path, model_config,
                                  segmenter.config, class_to_color_map)
    else:
        print("No metrics specified, no evaluation will be run")

    image_paths = [f for f in args.image_dir.glob("**/*") if is_image(f)]
    assert len(image_paths) > 0, "There are no images in the given directory."
    pages_per_batch = args.pages_per_batch or int(model_config.get("pages_per_batch", 0))
    throughput = (pages_per_batch > 1 and not args.visualize_segmentation
                  and segmenter.fused_page_inference)

    def load_one(image_path: Path) -> Optional["Image.Image"]:
        try:
            image = Image.open(image_path)
        except UnidentifiedImageError:
            print(f"File {image_path} is not an image.")
            return None
        if args.resize:
            image = resize_image(image, args.resize)
        if args.convert_to_black_white:
            image = image.convert("L")
        return image

    def segmented_pages():
        """(path, image, class map, assembled confidences with -vis) of each
        page. Throughput mode loads 4 x pages_per_batch pages at a time (the
        host keeps no more) and segments them pages_per_batch to a replay."""
        if throughput:
            chunk_size = 4 * pages_per_batch
            bucket_quantum = None if args.bucket_quantum < 0 else args.bucket_quantum
            for start in range(0, len(image_paths), chunk_size):
                chunk = [(path, image) for path in image_paths[start: start + chunk_size]
                         for image in (load_one(path),) if image is not None]
                predictions = segmenter.segment_images(
                    [image for _, image in chunk], pages_per_batch, output="classes",
                    bucket_quantum=bucket_quantum)
                for (path, image), predicted in zip(chunk, predictions):
                    yield path, image, predicted, None
            return
        for path in image_paths:
            image = load_one(path)
            if image is None:
                continue
            if args.visualize_segmentation:
                assembled = segmenter.segment_image(image)
                yield path, image, np.argmax(assembled, axis=-1), assembled
            else:
                yield path, image, segmenter.segment_image_classes(image), None

    for hyperparam_config in hyperparam_configs:
        segmenter.set_hyperparams(hyperparam_config)
        if evaluate:
            results["runs"].append(defaultdict(dict))
        global_confusion_matrix = np.zeros((num_classes, num_classes))
        for image_path, image, predicted, assembled_prediction in segmented_pages():
            if args.visualize_segmentation:
                prefix = f"{image_path.stem}_{get_string_representation_of_config(hyperparam_config)}"
                try:
                    visualize_segmentation(assembled_prediction, image, segmenter, args,
                                           class_to_color_map, prefix)
                except Exception as e:  # noqa: BLE001 - the JAX CLI skips such an image too
                    print(f"The visualization produced an error:\n'{e}'\n"
                          f"The visualization for {image_path} will be skipped.\n")
            if not evaluate:
                continue
            try:
                gt = load_ground_truth_classes(image_path, args.ground_truth_dir,
                                               class_to_color_map)
                assert predicted.shape == gt.shape, (
                    "Shapes of prediction and ground truth do not match")
                cm = calculate_confusion_matrix(gt, predicted, num_classes)
                results["runs"][-1]["confusion_matrices"][image_path.stem] = [
                    float(v) for v in cm.reshape(-1)]
                global_confusion_matrix += cm
                for metric, do_calc in scores_to_calculate.items():
                    if do_calc:
                        results["runs"][-1][f"detailed_{metric}_scores"][image_path.stem] = \
                            calculate_metric(cm, class_names, metric)
            except Exception as e:  # noqa: BLE001 - the JAX CLI skips such an image too
                print(f"The confusion matrix calculation produced an error:\n'{e}'\n"
                      f"The calculation for {image_path} will be skipped.\n")
        if evaluate:
            _finalize_run(results, global_confusion_matrix, scores_to_calculate, class_names,
                          hyperparam_config, output_json_path)


def _finalize_run(results, global_confusion_matrix, scores_to_calculate, class_names,
                  hyperparam_config, output_json_path) -> None:
    """Global scores of one sweep config, and results.json rewritten."""
    for metric, do_calc in scores_to_calculate.items():
        if do_calc:
            results["runs"][-1][f"average_{metric}_scores"] = calculate_metric(
                global_confusion_matrix, class_names, metric)
    results["runs"][-1]["hyperparams"] = hyperparam_config
    with open(output_json_path, "w") as out_json:
        json.dump(results, out_json, indent=4)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Analyze the given images using the specified segmentation model.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("image_dir", type=Path)
    parser.add_argument("-cds", "--calculate-dice-score", action="store_true", default=False)
    parser.add_argument("-cio", "--calculate-iou", action="store_true", default=False)
    parser.add_argument("-cpr", "--calculate-precision", action="store_true", default=False)
    parser.add_argument("-cre", "--calculate-recall", action="store_true", default=False)
    parser.add_argument("-vis", "--visualize-segmentation", action="store_true", default=False)
    parser.add_argument("-f", "--config-file", default="config.json", type=Path)
    parser.add_argument("-op", "--original-config-path", type=Path, default=None)
    parser.add_argument("-gt", "--ground-truth-dir", type=Path, default=None)
    parser.add_argument("-o", "--output-dir", default="images", type=Path)
    parser.add_argument("--handle-existing", default="abort",
                        choices=["abort", "append", "overwrite"])
    parser.add_argument("--resize", nargs=2, type=int, default=None)
    parser.add_argument("-bw", "--convert-to-black-white", action="store_true", default=False)
    parser.add_argument("--absolute-patch-overlap", nargs="+", type=int, default=[0])
    parser.add_argument("--patch-overlap-factor", nargs="+", type=float, default=[0.0])
    parser.add_argument("--min-confidence", nargs="+", type=float, default=[0.7])
    parser.add_argument("--min-contour-area", nargs="+", type=int, default=[55])
    for flag in ("--extract-bboxes", "--draw-patches", "--draw-bboxes-on-segmentation"):
        parser.add_argument(flag, action="store_true", default=False)
    parser.add_argument("-b", "--save-bboxes", action="store_true", default=False)
    parser.add_argument("-c", "--save-contours", action="store_true", default=False)
    parser.add_argument("--show-confidence", action="store_true", default=False)
    parser.add_argument("--overlay-segmentation", action="store_true", default=False)
    parser.add_argument("--fused-page-inference", action="store_true", default=False,
                        help="Run each page as one page program (a CUDA graph per page "
                        "tiling on the card: patch cutting, forward, device component "
                        "filter, voting assembly). Implies the device component filter.")
    parser.add_argument("--quantize", action="store_true", default=False,
                        help="Static w8a8 int8 serving of the patch forward (DocUFCN "
                        "only): scales calibrated on the first page, int8 tensors "
                        "between layers. Also 'quantize: true' in the config file.")
    parser.add_argument("--use-device-component-filter", action="store_true", default=False,
                        help="Run the small-component postprocess on the device "
                        "(union-find connected components) instead of the host "
                        "contour filter. Pixel-area semantics.")
    parser.add_argument("--pages-per-batch", type=int, default=0,
                        help="Throughput mode (with --fused-page-inference, ignored with "
                        "-vis): N pages to one graph replay, class maps argmaxed on the "
                        "device. Pages of different sizes batch together (see "
                        "--bucket-quantum).")
    parser.add_argument("--bucket-quantum", type=int, default=0,
                        help="Canvas-size quantum (px) for batching pages of different "
                        "sizes into one page program; 0 = the patch size, negative = exact "
                        "tilings only. Each page's result equals its own tiling's.")
    parser.add_argument("--serving-dtype", default=None, choices=["float32", "bfloat16"],
                        help="Compute dtype of the network (default float32); bfloat16 "
                        "casts its parameters and BatchNorm statistics once. Mutually "
                        "exclusive with --quantize.")
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to run the segmenter on (default cuda)")
    return parser


def parse_and_check_arguments(argv=None):
    args = build_parser().parse_args(argv)
    assert args.calculate_dice_score or args.visualize_segmentation, (
        "Setting neither --calculate-dice-score nor --visualize-segmentation will result in "
        "no output."
    )
    if args.calculate_dice_score:
        assert args.ground_truth_dir is not None, (
            "If --calculate-dice-score is set --ground-truth-dir has to be set as well."
        )
    return args


if __name__ == "__main__":
    print("Starting execution")
    main(parse_and_check_arguments())
