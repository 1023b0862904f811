"""Recompute a sweep's metrics on a subset of its images (counterpart of
synthesis_in_style_tpu/cli/extract_results_subset.py): per-image entries
outside the subset are dropped and every average score is rebuilt from the
stored per-image confusion matrices.

  python -m synthesis_in_style_tpu_torch.cli.extract_results_subset \\
      results.json subset.txt -o subset_results.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from synthesis_in_style_tpu_torch.evaluation.results_analysis import (
    recompute_metrics,
    remove_not_in_subset,
)


def main(args: argparse.Namespace) -> Path:
    """Write the subset's results; returns where."""
    with open(args.results_path) as f:
        results = json.load(f)
    with open(args.subset_path) as f:
        subset = [line.rsplit(".", 1)[0].strip() for line in f.readlines()]

    remove_not_in_subset(results, subset)
    recompute_metrics(results)

    out = args.output_path or args.results_path.with_name("subset_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=4)
    print(f"wrote {out}")
    return Path(out)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Recompute evaluation metrics on a subset of the evaluated images")
    parser.add_argument("results_path", type=Path)
    parser.add_argument("subset_path", type=Path,
                        help="text file with one image (file)name per line")
    parser.add_argument("-o", "--output-path", type=Path, default=None)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
