"""One timed end-to-end capstone chain on the port: cluster discovery ->
measured cluster-config selection -> labelled synthesis -> DocUFCN training
-> sweep evaluation, each leg one of the port's CLIs in a subprocess with its
wall-clock seconds recorded (counterpart of
synthesis_in_style_tpu/scripts/run_capstone_chain.py).

    python -m synthesis_in_style_tpu_torch.scripts.run_capstone_chain \\
        <gan_snapshot.pt> <work_dir> --fixture <fixture_dir> [-d cuda] \\
        [--num-pairs 1024] [--ks 4 6 8 10 12] [--epochs 20] \\
        [--class-weights 1 4 10] [--num-augmentations 2] \\
        [--use-device-component-filter]

`-d` is passed to every leg. The GAN's config is the one stored beside its
snapshot (`load_config_from_checkpoint`: `<run>/config/config.json` or
`.yaml`); the segmenter snapshot evaluated is the newest `iter_*.pt` of the
newest segmenter run. `--use-device-component-filter` runs the sweep's
small-region filter on the device (the CC kernel) instead of the host
contour filter, the JAX chain's (and analyze CLI's) default.

Writes `<work_dir>/chain_report.json`: `legs` ({name: {seconds,
returncode}}), `total_seconds` and `best_dice` (background, printed_text,
handwritten_text and weighted_avg dice of the sweep's best run), beside
`checkpoint`, `num_pairs` and `results_json`.
"""

from __future__ import annotations

import argparse
import json
import shlex
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

from synthesis_in_style_tpu_torch.core.config import (
    load_config_file,
    load_config_from_checkpoint,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import latest_snapshot

PACKAGE = "synthesis_in_style_tpu_torch"


def run_leg(name: str, cmd: list, report: dict, log_dir: Path) -> None:
    """Run one leg with its output in `<log_dir>/<name>.log`; record its
    seconds and return code; a failed leg ends the chain."""
    print(f"=== {name}: {' '.join(map(str, cmd))}", flush=True)
    log = log_dir / f"{name}.log"
    start = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run([str(c) for c in cmd], stdout=f, stderr=subprocess.STDOUT)
    elapsed = time.perf_counter() - start
    report["legs"][name] = {"seconds": elapsed, "returncode": proc.returncode}
    print(f"=== {name}: {elapsed:.1f}s rc={proc.returncode}", flush=True)
    if proc.returncode != 0:
        print(log.read_text()[-4000:], flush=True)
        raise SystemExit(f"{name} failed (see {log})")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint", help="GAN snapshot (.pt) of the port")
    parser.add_argument("work_dir")
    parser.add_argument("--fixture", required=True,
                        help="fixture dir with eval/images and eval/gt "
                        "(scripts/make_capstone_fixture.py layout)")
    parser.add_argument("--ks", nargs="+", type=int, default=[4, 6, 8, 10, 12, 14, 16])
    parser.add_argument("--num-discovery-samples", type=int, default=64)
    parser.add_argument("--num-pairs", type=int, default=1024)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--class-weights", nargs=3, type=float, default=[1.0, 4.0, 10.0])
    parser.add_argument("--num-augmentations", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seg-config",
                        default="configs/segmenter/stylegan2_doc_ufcn_segmenter.yaml")
    parser.add_argument("--select-args", default="",
                        help="extra args passed to select_cluster_config, as ONE quoted "
                        "string (shlex-split), e.g. --select-args '--num-cd-layers 3'")
    parser.add_argument("--min-confidence", nargs="+", type=float, default=[0.0, 0.5, 0.7])
    parser.add_argument("--min-contour-area", nargs="+", type=int, default=[0, 55])
    parser.add_argument("--use-device-component-filter", action="store_true", default=False,
                        help="the sweep's small-region filter on the device (CC kernel)")
    parser.add_argument("--skip-discovery", action="store_true",
                        help="reuse <work_dir>/sem/catalogs from a prior run")
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device of every leg (default cuda)")
    return parser


def main(argv=None, interpreter: Optional[Sequence[str]] = None) -> int:
    """Run the chain. `interpreter` is the command that runs `-m <module>
    <args>` for each leg (default: this Python)."""
    args = build_parser().parse_args(argv)
    work = Path(args.work_dir)
    work.mkdir(parents=True, exist_ok=True)
    sem = work / "sem"
    report = {"checkpoint": str(args.checkpoint), "legs": {}, "num_pairs": args.num_pairs}
    py = [*(interpreter or [sys.executable]), "-m"]
    device = ["-d", args.device]
    t0 = time.perf_counter()

    if not args.skip_discovery:
        run_leg("cluster_discovery", py + [
            f"{PACKAGE}.cli.create_semantic_segmentation", args.checkpoint,
            "--destination", sem, "-n", args.num_discovery_samples,
            "-c", min(args.ks), max(args.ks) + 1, *device,
        ], report, work)

    run_leg("select_config", py + [
        f"{PACKAGE}.scripts.select_cluster_config", args.checkpoint, sem, "--ks", *args.ks,
        "-n", args.num_discovery_samples, "--out-tag", "sel", *device,
    ] + shlex.split(args.select_args), report, work)

    dataset_dir = work / "dataset"
    run_leg("labelled_synthesis", py + [
        f"{PACKAGE}.cli.create_dataset_for_segmentation", args.checkpoint,
        sem / "creation_config_sel.json", "-n", args.num_pairs, "-s", dataset_dir,
        "-ssd", sem, "--num-clusters", "sel", "-b", 16, *device,
    ], report, work)

    # derived segmenter config: the GAN's image size, the class weights,
    # augmentation on (appearance-coded classes survive it)
    seg_config = load_config_file(args.seg_config)
    gan_config = load_config_from_checkpoint(args.checkpoint)
    seg_config.update({
        "epochs": args.epochs,
        "image_size": int(gan_config["image_size"]),
        "class_weights": list(args.class_weights),
        "num_augmentations": args.num_augmentations,
        "batch_size": args.batch_size,
        "snapshot_save_iter": 10_000_000,  # final snapshot only
    })
    seg_config_path = work / "seg_config.json"
    seg_config_path.write_text(json.dumps(seg_config, indent=2))
    run_leg("segmenter_training", py + [
        f"{PACKAGE}.cli.train", seg_config_path,
        "--images", dataset_dir / "train.json", "--val-images", dataset_dir / "val.json",
        "--class-to-color-map", "configs/handwriting_colors.json",
        "-l", (work / "seg_logs").resolve(), "-ln", "docufcn", *device,
    ], report, work)

    runs = sorted((work / "seg_logs" / "docufcn").iterdir())
    snapshot = latest_snapshot(runs[-1] / "checkpoints")
    eval_config = {"checkpoint": str(snapshot),
                   "class_to_color_map": "configs/handwriting_colors.json",
                   "max_image_size": 0}
    (work / "eval_config.json").write_text(json.dumps(eval_config))
    run_leg("sweep_eval", py + [
        f"{PACKAGE}.cli.analyze_image_segments", Path(args.fixture) / "eval" / "images",
        "-f", work / "eval_config.json", "-gt", Path(args.fixture) / "eval" / "gt",
        "-o", work / "eval_out", "-cds", "-cio",
        "--min-confidence", *args.min_confidence,
        "--min-contour-area", *args.min_contour_area,
        "--handle-existing", "overwrite", *device,
    ] + (["--use-device-component-filter"] if args.use_device_component_filter else []),
        report, work)

    results = json.loads((work / "eval_out" / "results.json").read_text())
    best = max(results["runs"],
               key=lambda run: run["average_dice_scores"]["weighted_avg"]["score"])
    report["total_seconds"] = time.perf_counter() - t0
    report["best_dice"] = {name: best["average_dice_scores"][name]["score"]
                           for name in ("background", "printed_text", "handwritten_text",
                                        "weighted_avg")}
    report["results_json"] = str(work / "eval_out" / "results.json")
    (work / "chain_report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
