"""Nearest-centre assignment (counterpart of `assign_euclidean` in
synthesis_in_style_tpu/segmentation/kmeans.py). The k-means fit is not
ported yet (ROADMAP.md)."""

from __future__ import annotations

from typing import Optional

import torch


def assign_euclidean(
    x: torch.Tensor, centers: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 for x (N, C), centers (K, C), as one product:
    ||x||^2 is constant per row, so score = -2 x.c + ||c||^2. With `valid`
    (K,) bool, invalid centres never win. Ties go to the lowest index."""
    centers = centers.to(device=x.device, dtype=x.dtype)
    scores = -2.0 * (x @ centers.t()) + (centers * centers).sum(dim=1)[None, :]
    if valid is not None:
        scores = torch.where(valid[None, :], scores, torch.full_like(scores, float("inf")))
    return torch.argmin(scores, dim=1)
