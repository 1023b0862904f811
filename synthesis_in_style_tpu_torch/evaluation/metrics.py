"""Confusion-matrix segmentation metrics (counterpart of
synthesis_in_style_tpu/evaluation/metrics.py): dice, IoU, precision and
recall per class, with ground-truth-frequency-weighted averages; a class
absent from both prediction and ground truth scores 1.0."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def calculate_confusion_matrix(ground_truth, prediction, num_classes: int) -> np.ndarray:
    """(H, W) or (B, H, W) integer class maps (numpy or tensors, on any
    device) -> (C, C) float64 matrix, rows ground truth, columns prediction.
    Counts are exact: one int64 bincount of the joint index."""
    gt = torch.as_tensor(ground_truth).reshape(-1).long()
    pred = torch.as_tensor(prediction).reshape(-1).long().to(gt.device)
    counts = torch.bincount(gt * num_classes + pred, minlength=num_classes * num_classes)
    return counts.cpu().numpy().reshape(num_classes, num_classes).astype(np.float64)


def _nan_to_one(value: float) -> float:
    return 1.0 if np.isnan(value) else float(value)


def calculate_dice_score(confusion_matrix: np.ndarray, class_idx: int) -> float:
    tp = confusion_matrix[class_idx, class_idx]
    predicted = confusion_matrix[:, class_idx].sum()
    actual = confusion_matrix[class_idx, :].sum()
    with np.errstate(invalid="ignore"):
        return _nan_to_one(2 * tp / (predicted + actual))


def calculate_iou(confusion_matrix: np.ndarray, class_idx: int) -> float:
    tp = confusion_matrix[class_idx, class_idx]
    predicted = confusion_matrix[:, class_idx].sum()
    actual = confusion_matrix[class_idx, :].sum()
    with np.errstate(invalid="ignore"):
        return _nan_to_one(tp / (predicted + actual - tp))


def calculate_precision(confusion_matrix: np.ndarray, class_idx: int) -> float:
    tp = confusion_matrix[class_idx, class_idx]
    predicted = confusion_matrix[:, class_idx].sum()
    with np.errstate(invalid="ignore", divide="ignore"):
        return _nan_to_one(tp / predicted)


def calculate_recall(confusion_matrix: np.ndarray, class_idx: int) -> float:
    tp = confusion_matrix[class_idx, class_idx]
    actual = confusion_matrix[class_idx, :].sum()
    with np.errstate(invalid="ignore", divide="ignore"):
        return _nan_to_one(tp / actual)


IMPLEMENTED_METRICS = {
    "dice": calculate_dice_score,
    "iou": calculate_iou,
    "precision": calculate_precision,
    "recall": calculate_recall,
}


def calculate_metric(confusion_matrix: np.ndarray, class_names: List[str],
                     metric: str = "dice") -> Dict[str, Dict[str, float]]:
    """Per-class scores, their ground-truth-weighted average, and the
    weighted average over the classes whose name contains 'text'."""
    assert metric in IMPLEMENTED_METRICS, (
        f"Metric to calculate must be in {', '.join(IMPLEMENTED_METRICS)}"
    )
    confusion_matrix = np.asarray(confusion_matrix, np.float64)
    scores: Dict[str, Dict[str, float]] = {
        "weighted_avg": {"score": 0.0},
        "weighted_text_avg": {"score": 0.0},
    }
    total_text_weight = 0.0
    total = confusion_matrix.sum()
    for class_idx, name in enumerate(class_names):
        score = IMPLEMENTED_METRICS[metric](confusion_matrix, class_idx)
        weight = confusion_matrix[class_idx, :].sum() / total if total else 0.0
        if "text" in name:
            total_text_weight += weight
        scores["weighted_avg"]["score"] += score * weight
        scores[name] = {"score": score, "weight": weight}
    for name in class_names:
        if "text" in name:
            if total_text_weight > 0:
                scores["weighted_text_avg"]["score"] += (
                    scores[name]["score"] * scores[name]["weight"] / total_text_weight
                )
            else:
                scores["weighted_text_avg"]["score"] = 1.0
    return scores
