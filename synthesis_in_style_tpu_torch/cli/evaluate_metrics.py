"""Print a page-inference sweep's results as tables (counterpart of
synthesis_in_style_tpu/cli/evaluate_metrics.py): per class the best
hyperparameters, per hyperparameter the best-median value, the
configuration of the best mIoU, or the runs of one given configuration.
Plain markdown tables; no pandas.

  python -m synthesis_in_style_tpu_torch.cli.evaluate_metrics results.json -p [-c]
  python -m synthesis_in_style_tpu_torch.cli.evaluate_metrics results.json \\
      -r min_confidence 0.7 min_contour_area 55 patch_overlap 0.0
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from synthesis_in_style_tpu_torch.evaluation.results_analysis import (
    Table,
    add_mean_iou,
    extract_score_name,
    get_best_median_configs,
    get_best_results,
    get_calculated_score_key_filters,
    get_dataframe_from_results,
    get_result_for_given_config,
    get_tabular_results,
    preprocess_results,
)


def print_table(table: Table, title: str = "") -> None:
    if title:
        print(title)
    print(table.to_markdown() + "\n")


def print_result_tables(results: dict) -> None:
    """Best results and best medians for every average score, then the
    configuration of the best mIoU with all its metrics."""
    best_miou_params = None
    network = results["general_config"]["model_config"].get("network", "model")
    for score_key_filter in get_calculated_score_key_filters(results, "average"):
        tabular, score_class_names, hyperparam_names = get_tabular_results(
            results, score_key_filter)
        print(f"# {network} - {extract_score_name(score_key_filter)}\n")
        print("## Best Results\n")
        best_results = get_best_results(results, score_key_filter)
        print_table(best_results)

        if score_key_filter == "average_iou_scores":
            row = next(r for r in best_results.records() if r["class"] == "weighted_avg")
            best_miou_params = [
                "min_confidence", str(float(row["min_confidence"])),
                "min_contour_area", str(int(row["min_contour_area"])),
                "patch_overlap", str(float(row["patch_overlap"])),
            ]

        print("## Median Results for each Hyperparameter\n")
        for hp_name, table in get_best_median_configs(
                tabular, hyperparam_names, score_class_names,
                extract_score_name(score_key_filter)).items():
            print_table(table, title=f"### {hp_name}")

    if best_miou_params is not None:
        print("# Config for best mIoU\n")
        table = get_dataframe_from_results(get_result_for_given_config(best_miou_params, results))
        table = table.rename(columns={"iou_weighted_avg": "mIoU",
                                      "iou_weighted_text_avg": "mIoU_text_only"}).T
        print_table(table.head(3))
        print("# All Metrics for best mIoU\n")
        print_table(table.tail(len(table) - 3))


def main(args: argparse.Namespace) -> None:
    with open(args.results_path) as f:
        results = json.load(f)
    preprocess_results(results)
    if args.calculate_mean_iou:
        add_mean_iou(results)
    if args.print_tables:
        print_result_tables(results)
    elif args.get_result_for_config is not None:
        matching = get_result_for_given_config(args.get_result_for_config, results)
        if not matching:
            print("No matching config found.")
        else:
            print_table(get_dataframe_from_results(matching))
    else:
        raise NotImplementedError


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Takes the evaluation results of a trained classifier and prints the formatted results")
    parser.add_argument("results_path", type=Path)
    parser.add_argument("-c", "--calculate-mean-iou", action="store_true", default=False)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("-p", "--print-tables", action="store_true", default=False)
    group.add_argument("-r", "--get-result-for-config", nargs="+", default=None)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
