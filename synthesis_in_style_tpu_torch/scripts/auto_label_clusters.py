"""Heuristic cluster auto-labelling, a scriptable stand-in for the human
labeller (counterpart of synthesis_in_style_tpu/scripts/auto_label_clusters.py).

For each (layer, cluster) of `catalogs/<k>.npz` it samples N images through
the generator on `--device` (default cuda), assigns clusters, upsamples the
cluster ids to image size by index (`arange(size) * h // size`) and sums per
cluster, in float64: luminance, dark pixels, dark pixels with the class
feature, pixels. Clusters whose pixels are mostly dark become text, split
into `left_class` / `right_class` by `--mode`:

* ``appearance`` (default): the printed-like share of the cluster's ink,
  printed-like meaning the horizontal-run box mean exceeds the vertical one
  by `--printed-margin` (centred, zero-padded windows of odd length);
* ``side``: the left-half share of its ink (layout-coded fixtures).

Writes `merged_classes_<k>.json`, which the dataset CLI reads.

    python -m synthesis_in_style_tpu_torch.scripts.auto_label_clusters \\
        <checkpoint> <semantic_segmentation_dir> -k 12 [-n 32] [-d cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.models.factory import load_generator
from synthesis_in_style_tpu_torch.scripts.select_cluster_config import printed_like, run_length
from synthesis_in_style_tpu_torch.segmentation.factor_catalog import load_catalogs
from synthesis_in_style_tpu_torch.utils.dataset_creation import build_latent_and_noise_generator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint")
    parser.add_argument("sem_dir")
    parser.add_argument("-k", "--num-clusters", type=int, required=True)
    parser.add_argument("-n", "--num-samples", type=int, default=32)
    parser.add_argument("-b", "--batch-size", type=int, default=8)
    parser.add_argument("--dark-threshold", type=float, default=0.55,
                        help="luminance (in [0,1]) below which a pixel counts as ink")
    parser.add_argument("--dark-fraction", type=float, default=0.4,
                        help="min fraction of a cluster's pixels that must be dark for it "
                        "to be a text cluster")
    parser.add_argument("--left-threshold", type=float, default=0.6,
                        help="dark pixels left-half fraction above which a text cluster is "
                        "`left_class`")
    parser.add_argument("--mode", choices=("appearance", "side"), default="appearance",
                        help="class split: stroke appearance (default) or the left/right "
                        "position prior")
    parser.add_argument("--run-len-frac", type=float, default=0.07)
    parser.add_argument("--printed-margin", type=float, default=0.35)
    parser.add_argument("--printed-frac-threshold", type=float, default=0.55)
    parser.add_argument("--left-class", default="printed_text")
    parser.add_argument("--right-class", default="handwritten_text")
    parser.add_argument("--background-class", default="background")
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to synthesize and count on (default cuda)")
    return parser


def cluster_stats(gen, stream, catalogs, args, size: int) -> dict:
    """{layer: (k, 4) float64 numpy} per-cluster sums of [luminance,
    dark & class feature, dark, 1] over `num_samples` generated images."""
    k = args.num_clusters
    run_len = run_length(size, args.run_len_frac)
    device = next(gen.parameters()).device
    stats = {layer: torch.zeros((k, 4), dtype=torch.float64, device=device)
             for layer in catalogs}
    xfrac = (torch.arange(size, device=device) + 0.5) / size
    done = 0
    while done < args.num_samples:
        z = next(stream)
        with torch.no_grad():
            img, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
        lum = torch.clamp((img.float() + 1) / 2, 0, 1).mean(dim=-1)
        dark = lum < args.dark_threshold
        if args.mode == "appearance":
            class_feat = printed_like(dark.to(torch.float32), run_len, args.printed_margin)
        else:
            class_feat = (xfrac < 0.5).expand_as(lum)
        feats = torch.stack([lum.double(), (dark & class_feat).double(), dark.double(),
                             torch.ones_like(lum, dtype=torch.float64)], dim=-1).reshape(-1, 4)
        for layer, cat in catalogs.items():
            a = acts[int(layer)]
            h, w = a.shape[1:3]
            ids = cat.predict(a)
            yi = (torch.arange(size, device=device) * h // size).clamp(0, h - 1)
            xi = (torch.arange(size, device=device) * w // size).clamp(0, w - 1)
            ids_big = ids[:, yi][:, :, xi]
            stats[layer].index_add_(0, ids_big.reshape(-1), feats)
        done += img.shape[0]
    return {layer: s.cpu().numpy() for layer, s in stats.items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    sem_dir = Path(args.sem_dir)
    k = args.num_clusters
    config = load_config_from_checkpoint(Path(args.checkpoint), None)
    config["batch_size"] = args.batch_size
    gen = load_generator(Path(args.checkpoint), config, device=device)
    catalogs = load_catalogs(sem_dir / "catalogs" / f"{k}.npz")
    stream = build_latent_and_noise_generator(config, seed=7, device=device)
    stats = cluster_stats(gen, stream, catalogs, args, config["image_size"])

    class_threshold = (
        args.printed_frac_threshold if args.mode == "appearance" else args.left_threshold
    )
    feat_name = "printed" if args.mode == "appearance" else "dark_left"
    label_map = {}
    for layer, s in stats.items():
        label_map[layer] = {}
        for cl in range(k):
            n = s[cl, 3]
            dark_frac = s[cl, 2] / n if n else 0.0
            class_frac = s[cl, 1] / max(1.0, s[cl, 2])
            if dark_frac > args.dark_fraction:
                name = args.left_class if class_frac >= class_threshold else args.right_class
            else:
                name = args.background_class
            label_map[layer][str(cl)] = name
            print(f"layer {layer} cluster {cl}: dark={dark_frac:.2f} "
                  f"{feat_name}={class_frac:.2f} -> {name}")

    out = sem_dir / f"merged_classes_{k}.json"
    out.write_text(json.dumps(label_map))
    print("wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
