"""Rasterized on-device back half of cluster-based label synthesis
(counterpart of synthesis_in_style_tpu/segmentation/device_segmenter.py).

  polygon (host route)          rasterized equivalent (here)
  --------------------------    -------------------------------------------
  dilate + findContours         dilate_cross + connected_components(8)
  drawContours(..., FILLED)     fill_holes
  fixpoint pairwise merge       connected components of the filled union
  "absorbed >= 2 originals"     per-union-component count of source roots
  contour/region overlap        per-component sums of region masks
  bounding-rect drop rule       per-component bbox extents
  render (contour and cluster)  per-pixel class lookup via component labels

Every connected_components call runs the union-find CC kernel when the masks
lie on the card (12 calls per batch for two text classes).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from synthesis_in_style_tpu_torch.segmentation.device_cc import (
    component_bboxes,
    component_sums,
    connected_components,
    dilate_cross,
    fill_holes,
)


def _merge_layers(
    layer_masks: torch.Tensor,  # (L, B, H, W) bool: one class, all source layers
    only_keep_overlapping: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-layer contour merge, rasterized. Returns (labels (B, H, W) int32
    of merged filled components, originals_per_component (B, H*W) float32,
    image_valid (B,) bool: False where any layer is empty)."""
    l, b, h, w = layer_masks.shape
    flat_lb = layer_masks.reshape(l * b, h, w)
    filled = fill_holes(dilate_cross(flat_lb))
    layer_cc = connected_components(filled, connectivity=8)

    union = filled.reshape(l, b, h, w).any(dim=0)
    union_cc = connected_components(fill_holes(union), connectivity=8)

    # one root pixel per source-layer component; counting roots per union
    # component counts the original contours it absorbed (per layer, so that
    # same-pixel roots of two layers both count)
    seeds = torch.arange(h * w, dtype=torch.int32, device=layer_masks.device).reshape(1, h, w)
    roots = (layer_cc == seeds).reshape(l, b, h, w)
    originals = component_sums(union_cc, roots[0])
    for i in range(1, l):
        originals = originals + component_sums(union_cc, roots[i])
    if only_keep_overlapping:
        originals = torch.where(originals >= 2, originals, torch.zeros_like(originals))

    image_valid = layer_masks.any(dim=3).any(dim=2).all(dim=0)  # (B,)
    return union_cc, originals, image_valid


def _lookup(per_component: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """per_component (B, H*W) indexed by per-pixel label ids (B, H*W)."""
    return torch.gather(per_component, 1, idx)


def device_segment(
    coarse: torch.Tensor,  # (Lc, K, B, H, W) bool: text classes in class-id order
    fine_printed: torch.Tensor,  # (Lf, B, H, W) bool: fine layers, printed class
    raw_fine_printed: torch.Tensor,  # (B, H, W) bool: undilated last fine layer
    *,
    only_keep_overlapping: bool,
    min_area: int,
    max_extent: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full rasterized back half. Returns ((B, H, W) uint8 palette indices:
    0 = background, text class ci -> ci + 1) and (B,) bool drop flags."""
    lc, k, b, h, w = coarse.shape
    ones = torch.ones((b, h, w), dtype=torch.bool, device=coarse.device)

    # ---- coarse text regions per class ----
    regions = []
    for ci in range(k):
        labels, originals, valid = _merge_layers(coarse[:, ci], only_keep_overlapping)
        areas = component_sums(labels, ones)
        keep = (originals > 0) & (areas >= min_area)  # (B, H*W)
        flat = labels.reshape(b, h * w).long()
        kept = _lookup(keep, torch.where(flat >= 0, flat, torch.zeros_like(flat)))
        region = ((flat >= 0) & kept).reshape(b, h, w)
        regions.append(region & valid[:, None, None])

    # ---- fine-grained printed components ----
    fine_cc, fine_originals, fine_valid = _merge_layers(fine_printed, True)
    fine_flat = fine_cc.reshape(b, h * w).long()
    fine_idx = torch.where(fine_flat >= 0, fine_flat, torch.zeros_like(fine_flat))

    # ---- classification: overlap of each fine component with each class ----
    overlaps = torch.stack([component_sums(fine_cc, regions[i]) for i in range(k)], dim=-1)
    best_overlap, _ = overlaps.max(dim=-1)
    best_class = overlaps.argmax(dim=-1)  # ties -> lowest class id
    assigned = best_overlap > 0

    fine_areas = component_sums(fine_cc, ones)
    component_kept = (
        (fine_originals > 0) & assigned & (fine_areas >= min_area) & fine_valid[:, None]
    )  # (B, H*W)

    # ---- image drop rule ----
    boxes = component_bboxes(fine_cc)  # (B, H*W, 4)
    heights = boxes[..., 2] - boxes[..., 0] + 1
    widths = boxes[..., 3] - boxes[..., 1] + 1
    drop = torch.zeros((b,), dtype=torch.bool, device=coarse.device)
    for ci in range(k):
        of_class = component_kept & (best_class == ci)
        tall = (of_class & (heights > max_extent)).any(dim=1)
        wide = (of_class & (widths > max_extent)).any(dim=1)
        drop = drop | (tall & wide)

    # ---- render ----
    pixel_kept = _lookup(component_kept, fine_idx)
    pixel_class = _lookup(best_class, fine_idx)
    paint = (fine_flat >= 0) & pixel_kept & raw_fine_printed.reshape(b, h * w)
    color_idx = torch.where(paint, pixel_class + 1, torch.zeros_like(pixel_class))
    return color_idx.to(torch.uint8).reshape(b, h, w), drop


def run_device_segment(
    segmenter, predicted_clusters, batch_size: int
) -> Tuple[np.ndarray, List[int]]:
    """Adapter: BlackWhite segmenter + {layer: {class: (B, H, W) bool}} masks
    -> device_segment, returning ((B, H, W, 3) uint8 colour masks, drop ids)."""
    class_names = [n for n in segmenter.class_to_color_map if n != "background"]
    device = segmenter.device

    def as_tensor(m):
        return torch.as_tensor(np.asarray(m) if not torch.is_tensor(m) else m,
                               device=device).bool()

    coarse = torch.stack([
        torch.stack([as_tensor(predicted_clusters[layer][cls]) for cls in class_names])
        for layer in segmenter.keys_for_class_determination
    ])
    fine_layers = segmenter.keys_for_finegrained_segmentation
    fine_printed = torch.stack(
        [as_tensor(predicted_clusters[layer]["printed_text"]) for layer in fine_layers]
    )
    raw_fine = as_tensor(predicted_clusters[fine_layers[-1]]["printed_text"])
    palette = np.stack(
        [np.asarray(segmenter.class_to_color_map["background"])]
        + [np.asarray(segmenter.class_to_color_map[c]) for c in class_names]
    ).astype(np.uint8)
    idx, drop = device_segment(
        coarse, fine_printed, raw_fine,
        only_keep_overlapping=bool(segmenter.only_keep_overlapping),
        min_area=int(segmenter.min_class_contour_area),
        max_extent=int(segmenter.image_size * 0.95),
    )
    drop_ids = [int(i) for i in np.flatnonzero(drop.cpu().numpy())]
    return palette[idx.cpu().numpy()], drop_ids
