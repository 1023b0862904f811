"""Post-processing of a page-inference sweep's `results.json` (counterpart
of synthesis_in_style_tpu/evaluation/results_analysis.py): the runs as a
numeric table, per-class best and best-median hyperparameters, the lookup
of one configuration, the unweighted mIoU, and a subset's metrics rebuilt
from the stored per-image confusion matrices.

Where the JAX module returns a pandas DataFrame, this one returns a
`Table`: rows under ordered column names, with row labels, printable as a
markdown table. The port does not depend on pandas."""

from __future__ import annotations

import itertools
import operator
import statistics
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from synthesis_in_style_tpu_torch.evaluation.metrics import calculate_metric


class Table:
    """Rows of values under ordered column names; `index` labels the rows
    (0, 1, ... by default)."""

    def __init__(self, columns: Sequence[str], rows: Sequence[Sequence[Any]],
                 index: Optional[Sequence[Any]] = None):
        self.columns = list(columns)
        self.rows = [list(r) for r in rows]
        self.index = list(index) if index is not None else list(range(len(self.rows)))

    @classmethod
    def from_columns(cls, data: Dict[str, list]) -> "Table":
        """A table from {column: values}, as `pandas.DataFrame(data=...)`."""
        columns = list(data)
        lengths = {len(v) for v in data.values()}
        assert len(lengths) <= 1, "all columns must have the same length"
        return cls(columns, list(zip(*data.values())) if columns else [])

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> list:
        i = self.columns.index(name)
        return [r[i] for r in self.rows]

    def records(self) -> List[dict]:
        return [dict(zip(self.columns, r)) for r in self.rows]

    def rename(self, columns: Dict[str, str]) -> "Table":
        return Table([columns.get(c, c) for c in self.columns], self.rows, self.index)

    @property
    def T(self) -> "Table":  # noqa: N802 - pandas' name
        return Table(self.index, [list(col) for col in zip(*self.rows)] if self.rows
                     else [[] for _ in self.columns], self.columns)

    def head(self, n: int) -> "Table":
        return Table(self.columns, self.rows[:n], self.index[:n])

    def tail(self, n: int) -> "Table":
        n = max(0, n)
        return Table(self.columns, self.rows[len(self.rows) - n:], self.index[len(self.rows) - n:])

    def to_markdown(self) -> str:
        """A pipe table with the row labels in the first column."""
        def fmt(v: Any) -> str:
            if isinstance(v, (bool, np.bool_)):
                return str(bool(v))
            if isinstance(v, (float, np.floating)):
                return f"{float(v):g}"
            return str(v)

        cells = [[""] + [str(c) for c in self.columns]]
        cells += [[fmt(i)] + [fmt(v) for v in row] for i, row in zip(self.index, self.rows)]
        widths = [max(len(row[j]) for row in cells) for j in range(len(cells[0]))]
        lines = ["| " + " | ".join(c.ljust(w) for c, w in zip(cells[0], widths)) + " |",
                 "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
        lines += ["| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |"
                  for row in cells[1:]]
        return "\n".join(lines)


def get_calculated_score_key_filters(results: dict, score_key: str = "average") -> List[str]:
    return [key for key in results["runs"][0].keys() if score_key in key]


def extract_score_name(score_key_filter: str) -> str:
    parts = score_key_filter.split("_")
    assert len(parts) == 3, (
        "score keys must consist of three parts delimited by '_' ('average_dice_score)")
    return parts[1]


def calculate_mean_iou(scores: dict) -> float:
    """The unweighted mean IoU over the three document classes."""
    return (scores["background"]["score"] + scores["printed_text"]["score"]
            + scores["handwritten_text"]["score"]) / 3.0


def add_mean_iou(results: dict) -> None:
    """Replace the weighted average IoU with the unweighted mIoU, for every
    run and every image."""
    for run in results["runs"]:
        run["average_iou_scores"]["weighted_avg"]["score"] = calculate_mean_iou(
            run["average_iou_scores"])
        for scores in run["detailed_iou_scores"].values():
            scores["weighted_avg"]["score"] = calculate_mean_iou(scores)


def preprocess_results(results: dict) -> None:
    """Flatten the (absolute, factor) patch_overlap pair to its factor."""
    for run in results["runs"]:
        overlap = run["hyperparams"].get("patch_overlap")
        if isinstance(overlap, (list, tuple)):
            assert overlap[0] == 0, "Code assumes that patch overlap is given as float."
            run["hyperparams"]["patch_overlap"] = overlap[1]


def group_results_by_hyperparam_values(hyperparam_values: list, results) -> Tuple[list, list]:
    """The results grouped by their hyperparameter value (sorted), and the
    values."""
    grouped = [list(el) for _, el in itertools.groupby(
        sorted(zip(hyperparam_values, results)), operator.itemgetter(0))]
    return [[el[1] for el in g] for g in grouped], [g[0][0] for g in grouped]


def get_tabular_results(results: dict, score_key: str):
    """(runs x (hyperparameters + classes) float array, class names,
    hyperparameter names)."""
    hyperparam_names = tuple(results["runs"][0]["hyperparams"].keys())
    score_class_names = tuple(results["runs"][0][score_key].keys())
    table = np.zeros((len(results["runs"]), len(hyperparam_names) + len(score_class_names)))
    for run_id, run in enumerate(results["runs"]):
        table[run_id] = tuple(run["hyperparams"].values()) + tuple(
            v["score"] for v in run[score_key].values())
    return table, score_class_names, hyperparam_names


def get_best_results(results: dict, score_key: str) -> Table:
    """Per class, its best score and that run's hyperparameters."""
    best: Dict[str, dict] = {}
    for run in results["runs"]:
        for class_name, v in run[score_key].items():
            if v["score"] > best.get(class_name, {score_key: 0.0})[score_key]:
                best[class_name] = {score_key: v["score"], **run["hyperparams"]}
    table = defaultdict(list)
    for class_name, metrics in best.items():
        table["class"].append(class_name)
        for k, v in metrics.items():
            table[k].append(v)
    return Table.from_columns(table)


def get_best_median_configs(tabular_results, hyperparam_names, score_class_names,
                            score_name) -> Dict[str, Table]:
    """Per hyperparameter, per class, the value with the best median score."""
    best_median: Dict[str, dict] = defaultdict(dict)
    num_hp = len(hyperparam_names)
    for hp_id, hp_name in enumerate(hyperparam_names):
        hp_values = [str(v) for v in tabular_results[:, hp_id]]
        for class_id, class_name in enumerate(score_class_names):
            column = tabular_results[:, num_hp + class_id]
            groups, labels = group_results_by_hyperparam_values(hp_values, column)
            medians = [(label, statistics.median(g)) for label, g in zip(labels, groups)]
            best_median[hp_name][class_name] = sorted(medians, key=lambda x: x[1],
                                                      reverse=True)[0]
    tables = {}
    for hp_name, metrics in best_median.items():
        table = defaultdict(list)
        for class_name, (value, median) in metrics.items():
            table["class"].append(class_name)
            table["hyperarameter value"].append(value)
            table[f"best median {score_name} score"].append(median)
        tables[hp_name] = Table.from_columns(table)
    return tables


def are_configs_matching(hyperparam_config: dict, run_config: dict) -> bool:
    for k, v in hyperparam_config.items():
        assert k in run_config, f"{k} is not present in the hyperparameter config of the results"
        if not run_config[k] == type(run_config[k])(v):
            return False
    return True


def get_result_for_given_config(raw_config: List[str], results: dict) -> List[dict]:
    """The runs matching `name value name value ...`, each as its
    hyperparameters and every average score as `<metric>_<class>`."""
    hyperparam_config = dict(zip(raw_config[::2], raw_config[1::2]))
    matching = []
    for run in results["runs"]:
        if are_configs_matching(hyperparam_config, run["hyperparams"]):
            merged = dict(run["hyperparams"])
            for score_key in filter(lambda x: "average" in x, run.keys()):
                name = extract_score_name(score_key)
                merged.update({f"{name}_{k}": v["score"] for k, v in run[score_key].items()})
            matching.append(merged)
    return matching


def get_dataframe_from_results(matching_results: List[dict]) -> Table:
    """A table of `get_result_for_given_config`'s rows."""
    table = defaultdict(list)
    for result in matching_results:
        for k, v in result.items():
            table[k].append(v)
    return Table.from_columns(table)


# a subset's metrics (extract_results_subset)

def remove_not_in_subset(results: dict, subset: List[str]) -> None:
    metrics = ["confusion_matrices"] + get_calculated_score_key_filters(results, "detailed")
    for run in results["runs"]:
        for metric in metrics:
            for key in list(run[metric].keys()):
                if key not in subset:
                    run[metric].pop(key, None)


def compute_confusion_matrix(run: dict, num_classes: int) -> np.ndarray:
    matrices = [np.asarray(v).reshape((num_classes, num_classes))
                for v in run["confusion_matrices"].values()]
    return np.stack(matrices, axis=0).sum(axis=0)


def recompute_metrics(results: dict) -> None:
    """Every run's average scores from the sum of its confusion matrices."""
    keys = get_calculated_score_key_filters(results, "average")
    class_names = [name for name in results["runs"][0][keys[0]].keys()
                   if "weighted" not in name]
    for run in results["runs"]:
        cm = compute_confusion_matrix(run, len(class_names))
        for key in keys:
            run[key] = calculate_metric(cm, class_names, extract_score_name(key))
