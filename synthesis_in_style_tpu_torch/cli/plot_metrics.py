"""Boxplots of a page-inference sweep's results (counterpart of
synthesis_in_style_tpu/cli/plot_metrics.py), drawn with PIL
(`utils/plots.boxplot`): per hyperparameter the average scores of every
class grouped by its value (`<score>_by_<hyperparameter>.png`), and the
per-image weighted averages over the runs (`<score>_per_image.png`).

  python -m synthesis_in_style_tpu_torch.cli.plot_metrics results.json figures/ [-c]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from synthesis_in_style_tpu_torch.evaluation.results_analysis import (
    add_mean_iou,
    extract_score_name,
    get_calculated_score_key_filters,
    get_tabular_results,
    group_results_by_hyperparam_values,
    preprocess_results,
)
from synthesis_in_style_tpu_torch.utils.plots import PALETTE, boxplot


def plot_average_results(results: dict, score_key: str, out_dir: Path) -> None:
    """One figure per hyperparameter: a box per (value, class), the classes
    side by side within each value's group."""
    tabular, score_class_names, hyperparam_names = get_tabular_results(results, score_key)
    score_name = extract_score_name(score_key)
    num_hp, num_classes = len(hyperparam_names), len(score_class_names)
    for hp_id, hp_name in enumerate(hyperparam_names):
        hp_values = [str(v) for v in tabular[:, hp_id]]
        groups, positions, colours = [], [], []
        for class_id in range(num_classes):
            column = tabular[:, num_hp + class_id]
            by_value, _ = group_results_by_hyperparam_values(hp_values, column)
            groups += by_value
            positions += [class_id + i * (num_classes + 1) for i in range(len(by_value))]
            colours += [PALETTE[class_id % len(PALETTE)]] * len(by_value)
        labels = sorted(set(hp_values))
        boxplot(groups, out_dir / f"{score_name}_by_{hp_name}.png", positions=positions,
                colours=colours,
                tick_positions=[i * (num_classes + 1) + num_classes / 2 - 0.5
                                for i in range(len(labels))],
                tick_labels=labels, x_label=hp_name, y_label=score_name,
                title=f"{score_name} by {hp_name}")


def plot_results_per_image(results: dict, score_key: str, out_dir: Path) -> None:
    """A box per image of its weighted-average score over the runs."""
    detailed_key = score_key.replace("average", "detailed")
    if detailed_key not in results["runs"][0]:
        return
    score_name = extract_score_name(score_key)
    per_image = {}
    for run in results["runs"]:
        for image_name, scores in run[detailed_key].items():
            per_image.setdefault(image_name, []).append(scores["weighted_avg"]["score"])
    boxplot(list(per_image.values()), out_dir / f"{score_name}_per_image.png",
            tick_positions=range(1, len(per_image) + 1), tick_labels=list(per_image),
            y_label=score_name)


def main(args: argparse.Namespace) -> None:
    with open(args.results_path) as f:
        results = json.load(f)
    preprocess_results(results)
    if args.calculate_mean_iou:
        add_mean_iou(results)
    args.figure_out_dir.mkdir(parents=True, exist_ok=True)
    for score_key in get_calculated_score_key_filters(results, "average"):
        plot_average_results(results, score_key, args.figure_out_dir)
        plot_results_per_image(results, score_key, args.figure_out_dir)
    print(f"figures written to {args.figure_out_dir}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Plots various metrics for the results of a segmentation model")
    parser.add_argument("results_path", type=Path)
    parser.add_argument("figure_out_dir", type=Path)
    parser.add_argument("-c", "--calculate-mean-iou", action="store_true", default=False)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
