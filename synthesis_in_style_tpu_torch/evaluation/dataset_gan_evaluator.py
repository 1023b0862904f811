"""DatasetGAN ensemble evaluation (counterpart of
synthesis_in_style_tpu/evaluation/dataset_gan_evaluator.py): the dice
coefficient of the ensemble's vote over validation pixel batches. As in the
JAX package (and the reference), the dice is taken over the class ids cast
to float, not per class."""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch


def calculate_dice_coefficient(pred: torch.Tensor, gt: torch.Tensor,
                               smooth: float = 1e-5) -> float:
    """dice = (2 |pred . gt| + s) / (|pred| + |gt| + s) per batch row, mean
    over the rows."""
    pred, gt = torch.as_tensor(pred).float(), torch.as_tensor(gt).float()
    assert pred.shape == gt.shape, "The shapes of prediction and groundtruth do not match."
    n = pred.shape[0]
    pred_flat, gt_flat = pred.reshape(n, -1), gt.reshape(n, -1)
    intersection = (pred_flat * gt_flat).sum(dim=1)
    union = pred_flat.sum(dim=1) + gt_flat.sum(dim=1)
    return float(((2 * intersection + smooth) / (union + smooth)).mean())


def make_dataset_gan_eval_fn(ensemble, val_batches_fn: Callable[[], Iterable[Dict]]):
    """eval_fn(trainer) -> {"Dice Score": mean dice over the batches} ({}
    without batches). `val_batches_fn()` yields {"activations": (B, F),
    "label": (B,)} tensors."""

    def eval_fn(trainer) -> Dict[str, float]:
        dice, num_batches = 0.0, 0
        for batch in val_batches_fn():
            preds = ensemble.predict_classes(batch["activations"])
            dice += calculate_dice_coefficient(preds[None], batch["label"].to(preds.device)[None])
            num_batches += 1
        if num_batches == 0:
            return {}
        return {"Dice Score": dice / num_batches}

    return eval_fn
