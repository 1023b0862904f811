"""Segmentation losses (counterpart of
synthesis_in_style_tpu/losses/segmentation.py): weighted cross-entropy and
multi-class Dice, on (B, C, H, W) logits and (B, H, W) integer labels,
computed in float32 whatever the logits' dtype."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from synthesis_in_style_tpu_torch.parallel import distributed


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over pixels; with class weights, the
    weighted mean sum(w[label] * ce) / sum(w[label]). In a launched
    multi-process run the weighted mean's normalizer is the processes' mean
    of sum(w[label]), so the mean of the processes' losses is the global
    batch's."""
    log_probs = F.log_softmax(logits.float(), dim=1)
    nll = -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
    if class_weights is None:
        return nll.mean()
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)[labels.long()]
    return (w * nll).sum() / (distributed.global_sum(w.sum()) / distributed.get_world_size())


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
              apply_softmax: bool = True, smooth: float = 1e-5) -> torch.Tensor:
    """Soft multi-class Dice: 1 - dice per class, averaged over all classes
    (background included). The sums run over the global batch in a launched
    multi-process run (with their gradients)."""
    probs = logits.float()
    if apply_softmax:
        probs = torch.softmax(probs, dim=1)
    one_hot = F.one_hot(labels.long(), num_classes).permute(0, 3, 1, 2).float()
    axes = (0, 2, 3)
    intersect = distributed.global_sum((probs * one_hot).sum(axes))
    denom = distributed.global_sum(one_hot.square().sum(axes) + probs.square().sum(axes))
    dice = (2.0 * intersect + smooth) / (denom + smooth)
    return (1.0 - dice).mean()
