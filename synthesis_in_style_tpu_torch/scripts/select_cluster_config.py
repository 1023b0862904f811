"""Purity-scored cluster-config selection (counterpart of
synthesis_in_style_tpu/scripts/select_cluster_config.py): sweep the fitted
k grid, score every (layer, k) for class separability and ink coverage, and
write the layer-role creation config that a human would otherwise choose in
the labeller.

Per (layer, k), a (k, 6) table of per-cluster sums of
[1, dark, dark & left, luminance, left, dark & printed_like] is accumulated
over `-n` generated samples on `--device` (default cuda), in float64. In
`--class-mode appearance` (the default) the per-pixel features come from the
full-resolution page: a pixel is printed-like when the dark share of its
horizontal run window exceeds that of its vertical one by `--printed-margin`
(a centred, zero-padded box filter of odd length `run_len`); they are then
average-pooled to the layer's grid, which keeps the per-cluster sums exact.
`--class-mode side` resizes the luminance to the layer's grid (linear,
antialiased, as `jax.image.resize` does) and splits by page half. The host
then scores the tables as the JAX script does:

* class determination: ink-weighted class purity of the text clusters,
  gated on a printed and a handwritten text cluster both existing;
* fine-grained: ink F-beta (recall-weighted) of the text clusters.

Outputs in the semantic-segmentation directory: `catalogs/<tag>.npz` (each
chosen layer at its best k), `merged_classes_<tag>.json`,
`creation_config_<tag>.json` (for the dataset CLI with
`--num-clusters <tag>`) and `selection_report_<tag>.json`.

    python -m synthesis_in_style_tpu_torch.scripts.select_cluster_config \\
        <checkpoint> <semantic_segmentation_dir> --ks 3 4 6 8 10 12 14 16 \\
        [-n 64] [--out-tag sel] [--num-cd-layers 2] [--num-fg-layers 2]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.models.factory import load_generator
from synthesis_in_style_tpu_torch.segmentation.factor_catalog import load_catalogs, save_catalogs
from synthesis_in_style_tpu_torch.segmentation.kmeans import assign_euclidean
from synthesis_in_style_tpu_torch.utils.dataset_creation import build_latent_and_noise_generator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint")
    parser.add_argument("sem_dir")
    parser.add_argument("--ks", nargs="+", type=int, required=True,
                        help="cluster counts to score (catalogs/<k>.npz must exist for each)")
    parser.add_argument("-n", "--num-samples", type=int, default=64)
    parser.add_argument("-b", "--batch-size", type=int, default=8)
    parser.add_argument("--dark-threshold", type=float, default=0.55)
    parser.add_argument("--dark-fraction", type=float, default=0.4,
                        help="min dark fraction for an INK (fine-grained) text cluster")
    parser.add_argument("--cd-dark-fraction", type=float, default=0.15,
                        help="min dark fraction for a REGION (class-determination) text "
                        "cluster: coarse clusters over sparse handwriting mix strokes with "
                        "paper, so regions need a lower bar than ink")
    parser.add_argument("--left-threshold", type=float, default=0.6)
    parser.add_argument("--class-mode", choices=("appearance", "side"), default="appearance",
                        help="how text clusters split into the two classes: 'appearance' "
                        "(default) by the horizontal-minus-vertical run box filter that "
                        "separates straight printed strokes from curvy handwriting; 'side' "
                        "by page half (printed left, handwriting right), for layout-coded "
                        "fixtures")
    parser.add_argument("--run-len-frac", type=float, default=0.07,
                        help="appearance mode: box-filter window as a fraction of image size")
    parser.add_argument("--printed-margin", type=float, default=0.35,
                        help="appearance mode: a dark pixel is printed-like when "
                        "horiz_run - vert_run exceeds this")
    parser.add_argument("--printed-frac-threshold", type=float, default=0.55,
                        help="appearance mode: a text cluster is printed when its "
                        "printed-like share of ink is >= this, else handwritten")
    parser.add_argument("--left-class", default="printed_text")
    parser.add_argument("--right-class", default="handwritten_text")
    parser.add_argument("--background-class", default="background")
    parser.add_argument("--num-cd-layers", type=int, default=2)
    parser.add_argument("--num-fg-layers", type=int, default=3)
    parser.add_argument("--fg-beta", type=float, default=2.0,
                        help="F-beta weight of the fine-grained ink score (recall-weighted)")
    parser.add_argument("--min-cd-resolution", type=int, default=16,
                        help="class-determination candidates need at least this "
                        "feature-map resolution")
    parser.add_argument("--min-fg-resolution-frac", type=float, default=0.5,
                        help="fine-grained candidates need resolution >= frac * image_size")
    parser.add_argument("--out-tag", default="sel")
    parser.add_argument("--min-class-contour-area", type=int, default=4)
    parser.add_argument("--fine-mask-dilation", type=int, default=2,
                        help="px halo around fine ink masks in the rendered labels")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to synthesize and count on (default cuda)")
    return parser


def score_stats(
    stats: np.ndarray,  # (k, 5|6): [n, n_dark, n_dark_left, lum_sum, n_left, (n_dark_printed_like)]
    dark_fraction: float,
    left_threshold: float,
    fg_beta: float = 2.0,
    region: bool = False,
    mode: str = "side",
) -> dict:
    """Host scoring of one (layer, k) table. `mode="appearance"`: the class
    coordinate is the printed-like share of the cluster's ink (column 5 /
    column 1) for region and ink semantics alike; `region` then only picks
    the caller's laxer dark-fraction threshold. `mode="side"` with
    `region=True`: a text cluster's side is judged by its area (n_left / n),
    since the dataset path paints a cluster's whole extent."""
    n = stats[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        dark_frac = np.where(n > 0, stats[:, 1] / np.maximum(n, 1), 0.0)
        if mode == "appearance":
            left_frac = stats[:, 5] / np.maximum(stats[:, 1], 1.0)
        elif region:
            left_frac = stats[:, 4] / np.maximum(n, 1.0)
        else:
            left_frac = stats[:, 2] / np.maximum(stats[:, 1], 1.0)
    text = dark_frac > dark_fraction
    weight = (
        np.where(text, n, 0.0)
        if region and mode != "appearance"
        else np.where(text, stats[:, 1], 0.0)
    )
    text_dark = weight
    purity_per = 2.0 * np.abs(left_frac - 0.5)
    total_text_dark = text_dark.sum()
    purity = (
        float((text_dark * purity_per).sum() / total_text_dark)
        if total_text_dark > 0 else 0.0
    )
    left_text = text & (left_frac >= left_threshold)
    right_text = text & (left_frac <= 1.0 - left_threshold)
    both_sides = bool(left_text.any() and right_text.any())
    cd_score = purity if both_sides else purity * 0.1

    total_dark = stats[:, 1].sum()
    captured = text_dark.sum()
    recall = float(captured / total_dark) if total_dark > 0 else 0.0
    text_n = np.where(text, n, 0.0).sum()
    precision = float(captured / text_n) if text_n > 0 else 0.0
    b2 = fg_beta * fg_beta
    fg_score = (
        (1 + b2) * precision * recall / (b2 * precision + recall)
        if precision + recall > 0 else 0.0
    )
    return {
        "cd_score": cd_score,
        "fg_score": fg_score,
        "purity": purity,
        "both_sides": both_sides,
        "ink_recall": recall,
        "ink_precision": precision,
        "dark_frac": dark_frac,
        "left_frac": left_frac,
        "text": text,
    }


def labels_from_stats(scored: dict, k: int, args) -> dict:
    """Per-cluster class names: text clusters are `left_class` when their
    class coordinate clears the threshold (the printed-like share in
    appearance mode, the left share in side mode), else `right_class`."""
    threshold = (
        args.printed_frac_threshold
        if getattr(args, "class_mode", "side") == "appearance"
        else args.left_threshold
    )
    out = {}
    for cl in range(k):
        if scored["text"][cl]:
            out[str(cl)] = (
                args.left_class
                if scored["left_frac"][cl] >= threshold
                else args.right_class
            )
        else:
            out[str(cl)] = args.background_class
    return out


def run_length(size: int, run_len_frac: float) -> int:
    """The box filter's (odd) window length at image size `size`."""
    return max(5, int(round(size * run_len_frac)) | 1)


def printed_like(dark: torch.Tensor, run_len: int, margin: float) -> torch.Tensor:
    """(B, S, S) float {0, 1} dark map -> bool map of the pixels whose
    horizontal run share exceeds their vertical one by more than `margin`:
    centred box means of length `run_len` (odd) with zero padding, as
    `reduce_window` with (run_len // 2, run_len // 2) padding divided by
    run_len, or cv2.filter2D with BORDER_CONSTANT."""
    x = dark[:, None]
    half = run_len // 2
    hrun = F.avg_pool2d(x, (1, run_len), stride=1, padding=(0, half), count_include_pad=True)
    vrun = F.avg_pool2d(x, (run_len, 1), stride=1, padding=(half, 0), count_include_pad=True)
    return ((hrun - vrun) > margin)[:, 0]


def appearance_features(lum: torch.Tensor, args, run_len: int) -> torch.Tensor:
    """(B, S, S) luminance -> (B, S, S, 6) full-resolution per-pixel
    features [1, dark, dark & left, lum, left, dark & printed_like]."""
    b, s = lum.shape[0], lum.shape[1]
    dark = (lum < args.dark_threshold).to(torch.float32)
    printed = printed_like(dark, run_len, args.printed_margin).to(torch.float32) * dark
    left = (torch.arange(s, device=lum.device) < s // 2).to(torch.float32).expand(b, s, s)
    return torch.stack([torch.ones_like(dark), dark, dark * left, lum, left, printed], dim=-1)


def pooled_features(feats_full: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, S, 6) -> (B*h*h, 6): means over f x f blocks, f = S // h."""
    f = feats_full.shape[1] // h
    pooled = F.avg_pool2d(feats_full.permute(0, 3, 1, 2), f, stride=f)
    return pooled.permute(0, 2, 3, 1).reshape(-1, 6)


def side_features(lum: torch.Tensor, h: int, w: int, args) -> torch.Tensor:
    """(B, S, S) luminance -> (B*h*w, 6) features on the layer's grid:
    [1, dark, dark & left, lum, left, 0] of the linearly resized, antialiased
    luminance (torch's antialiased bilinear is jax.image.resize's "linear"
    within 2.4e-7 at these integer factors)."""
    b = lum.shape[0]
    small = F.interpolate(lum[:, None], size=(h, w), mode="bilinear", antialias=True,
                          align_corners=False)[:, 0]
    dark = (small < args.dark_threshold).to(torch.float32)
    left = (torch.arange(w, device=lum.device) < w // 2).to(torch.float32).expand(b, h, w)
    return torch.stack([torch.ones_like(dark), dark, dark * left, small, left,
                        torch.zeros_like(dark)], dim=-1).reshape(-1, 6)


def stats_table(acts: torch.Tensor, feats: torch.Tensor, centers, k: int) -> torch.Tensor:
    """(k, 6) float64 per-cluster sums of `feats` (B*h*w, 6) over the
    nearest-centre labels of `acts` (B, h, w, C)."""
    ids = assign_euclidean(acts.reshape(-1, acts.shape[-1]),
                           torch.as_tensor(centers, device=acts.device))
    table = torch.zeros((k, 6), dtype=torch.float64, device=acts.device)
    return table.index_add_(0, ids, feats.to(torch.float64))


def layer_features(lum: torch.Tensor, acts: Dict[str, torch.Tensor], args, run_len: int
                   ) -> Dict[int, torch.Tensor]:
    """{layer resolution: (B*h*w, 6) features} for every resolution among
    `acts`, in the script's class mode."""
    sizes = sorted({int(a.shape[1]) for a in acts.values()})
    if args.class_mode == "appearance":
        full = appearance_features(lum, args, run_len)
        return {h: pooled_features(full, h) for h in sizes}
    return {h: side_features(lum, h, h, args) for h in sizes}


def accumulate_stats(gen, stream, catalogs_per_k, layer_ids, args, size: int):
    """Generate until `num_samples`; return ({(layer, k): (k, 6) float64
    numpy table}, {layer: resolution})."""
    run_len = run_length(size, args.run_len_frac)
    acc: Dict[tuple, torch.Tensor] = {}
    resolutions: Dict[str, int] = {}
    done = 0
    while done < args.num_samples:
        z = next(stream)
        with torch.no_grad():
            img, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
        lum = torch.clamp((img.float() + 1.0) / 2.0, 0.0, 1.0).mean(dim=-1)
        acts = {str(k): v for k, v in acts.items() if str(k) in layer_ids}
        resolutions = {layer: int(acts[layer].shape[1]) for layer in layer_ids}
        feats = layer_features(lum, acts, args, run_len)
        for layer in layer_ids:
            a = acts[layer]
            for k in args.ks:
                s = stats_table(a, feats[int(a.shape[1])],
                                catalogs_per_k[k][layer].cluster_centers, k)
                key = (layer, k)
                acc[key] = s if key not in acc else acc[key] + s
        done += z.shape[0]
    return {key: s.cpu().numpy() for key, s in acc.items()}, resolutions


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    sem_dir = Path(args.sem_dir)
    config = load_config_from_checkpoint(Path(args.checkpoint), None)
    config["batch_size"] = args.batch_size
    gen = load_generator(Path(args.checkpoint), config, device=device)
    size = config["image_size"]

    catalogs_per_k = {
        k: load_catalogs(sem_dir / "catalogs" / f"{k}.npz") for k in args.ks
    }
    layer_ids = sorted(catalogs_per_k[args.ks[0]], key=int)
    stream = build_latent_and_noise_generator(config, seed=args.seed, device=device)
    acc, resolutions = accumulate_stats(gen, stream, catalogs_per_k, layer_ids, args, size)

    # host scoring: REGION semantics (cd threshold) and INK semantics (fg
    # threshold) scored separately per (layer, k)
    rows = []
    scored_cd_all = {}
    scored_fg_all = {}
    class_threshold = (
        args.printed_frac_threshold
        if args.class_mode == "appearance" else args.left_threshold
    )
    for (layer, k), stats in acc.items():
        scored_cd = score_stats(stats, args.cd_dark_fraction, class_threshold, args.fg_beta,
                                region=True, mode=args.class_mode)
        scored_fg = score_stats(stats, args.dark_fraction, class_threshold, args.fg_beta,
                                mode=args.class_mode)
        scored_cd_all[(layer, k)] = scored_cd
        scored_fg_all[(layer, k)] = scored_fg
        rows.append({
            "layer": layer, "k": k, "resolution": resolutions[layer],
            "cd_score": round(scored_cd["cd_score"], 4),
            "fg_score": round(scored_fg["fg_score"], 4),
            "purity": round(scored_cd["purity"], 4),
            "both_sides": scored_cd["both_sides"],
            "ink_recall": round(scored_fg["ink_recall"], 4),
            "ink_precision": round(scored_fg["ink_precision"], 4),
        })
    rows.sort(key=lambda r: (int(r["layer"]), r["k"]))
    for r in rows:
        print(
            f"layer {r['layer']:>2} (res {r['resolution']:>3}) k={r['k']:>2}: "
            f"cd={r['cd_score']:.3f} (purity {r['purity']:.3f}, "
            f"both={r['both_sides']}) fg={r['fg_score']:.3f} "
            f"(R {r['ink_recall']:.2f} P {r['ink_precision']:.2f})",
            flush=True,
        )

    # selection: best k per layer per role, then the top layers per role
    best_cd = {}
    best_fg = {}
    for layer in layer_ids:
        cd_scored = [(k, scored_cd_all[(layer, k)]) for k in args.ks]
        fg_scored = [(k, scored_fg_all[(layer, k)]) for k in args.ks]
        bk_cd = max(cd_scored, key=lambda kv: kv[1]["cd_score"])
        bk_fg = max(fg_scored, key=lambda kv: kv[1]["fg_score"])
        best_cd[layer] = (bk_cd[0], bk_cd[1]["cd_score"])
        best_fg[layer] = (bk_fg[0], bk_fg[1]["fg_score"])

    cd_candidates = [
        layer for layer in layer_ids
        if args.min_cd_resolution <= resolutions[layer] <= size // 2
    ]
    fg_candidates = [
        layer for layer in layer_ids
        if resolutions[layer] >= args.min_fg_resolution_frac * size
    ]
    cd_layers = sorted(cd_candidates, key=lambda l: -best_cd[l][1])[: args.num_cd_layers]
    fg_layers = sorted(fg_candidates, key=lambda l: -best_fg[l][1])[: args.num_fg_layers]
    print(f"class-determination layers: {[(l, best_cd[l]) for l in cd_layers]}", flush=True)
    print(f"fine-grained layers: {[(l, best_fg[l]) for l in fg_layers]}", flush=True)

    # compose the per-layer-best-k catalog and label map: cd layers take
    # REGION labels at their best cd k; pure fg layers take INK labels at
    # their best fg k (a layer in both roles keeps the cd choice: the
    # dataset path reads one label map per layer)
    tag = args.out_tag
    composed = {}
    label_map = {}
    for layer in cd_layers + [l for l in fg_layers if l not in cd_layers]:
        if layer in cd_layers:
            k = best_cd[layer][0]
            scored = scored_cd_all[(layer, k)]
        else:
            k = best_fg[layer][0]
            scored = scored_fg_all[(layer, k)]
        composed[layer] = catalogs_per_k[k][layer]
        label_map[layer] = labels_from_stats(scored, k, args)
        n = acc[(layer, k)][:, 0]
        for cl in range(k):
            print(
                f"  chosen layer {layer} k={k} cluster {cl}: "
                f"area={n[cl] / max(1.0, n.sum()):.4f} "
                f"dark={scored['dark_frac'][cl]:.2f} "
                f"class_frac={scored['left_frac'][cl]:.2f} -> "
                f"{label_map[layer][str(cl)]}",
                flush=True,
            )
    save_catalogs(composed, sem_dir / "catalogs" / f"{tag}.npz")
    (sem_dir / f"merged_classes_{tag}.json").write_text(json.dumps(label_map))

    creation_config = {
        "class_to_color_map": {
            args.background_class: "#000000",
            args.left_class: "#0000FF",
            args.right_class: "#FF0000",
        },
        "keys_for_class_determination": [str(l) for l in cd_layers],
        "keys_for_finegrained_segmentation": [str(l) for l in fg_layers],
        "keys_to_merge": {},
        "segmenter_type": "black_white_handwritten_printed",
        "only_keep_overlapping": False,
        # purity-selected regions are side-consistent by construction, so
        # each class's paint is clipped to its own region mask
        "clip_to_class_regions": True,
        "fine_mask_dilation": args.fine_mask_dilation,
        "min_class_contour_area": args.min_class_contour_area,
        "seed": 1,
    }
    out_cfg = sem_dir / f"creation_config_{tag}.json"
    out_cfg.write_text(json.dumps(creation_config, indent=2))
    print(f"wrote catalogs/{tag}.npz, merged_classes_{tag}.json, {out_cfg}", flush=True)
    report = {
        "rows": rows,
        "cd_layers": [str(l) for l in cd_layers],
        "fg_layers": [str(l) for l in fg_layers],
        "per_layer_best_cd": {l: best_cd[l] for l in cd_layers},
        "per_layer_best_fg": {l: best_fg[l] for l in fg_layers},
    }
    (sem_dir / f"selection_report_{tag}.json").write_text(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
