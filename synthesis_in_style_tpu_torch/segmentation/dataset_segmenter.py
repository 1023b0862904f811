"""Dataset segmenters: generator activations -> labelled colour masks
(counterpart of synthesis_in_style_tpu/segmentation/dataset_segmenter.py,
device-contour route only).

The front half (`compute_masks`) assigns every activation pixel of each
catalog layer to its nearest centre, ORs the clusters of each class into a
mask and upsamples it to image size. The back half is the rasterized
`device_segment`. Both run on the segmenter's device; only (B, H, W) uint8
palette indices and (B,) drop flags reach the host. The host contour route
(OpenCV polygons) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
from collections import defaultdict
from functools import reduce
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from synthesis_in_style_tpu_torch.segmentation.device_segmenter import device_segment
from synthesis_in_style_tpu_torch.segmentation.factor_catalog import (
    FactorCatalog,
    load_catalogs,
)
from synthesis_in_style_tpu_torch.utils.segmentation_utils import resolve_color_map

Masks = Dict[Tuple[str, str], torch.Tensor]


class BaseDatasetSegmenter:
    def __init__(self, base_dir: Path, image_size: int, class_to_color_map: Dict,
                 device: Union[str, torch.device] = "cuda"):
        self.base_dir = Path(base_dir)
        self.image_size = image_size
        self.device = torch.device(device)
        self.class_to_color_map = resolve_color_map(class_to_color_map)


def resize_nearest(mask: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h, w) bool -> (B, size, size) nearest upscale. Only integer factors
    are taken: there nearest resampling picks source pixel i // f in every
    convention, so this matches jax.image.resize(..., "nearest")."""
    h, w = mask.shape[-2:]
    if size % h or size % w:
        raise ValueError(f"mask {h}x{w} does not scale to {size} by an integer factor")
    out = F.interpolate(mask[:, None].to(torch.uint8), size=(size, size), mode="nearest")
    return out[:, 0].bool()


class BaseClusterBasedDatasetSegmenter(BaseDatasetSegmenter):
    def __init__(
        self,
        *args,
        keys_for_class_determination: List[str],
        keys_for_finegrained_segmentation: List[str],
        num_clusters: Union[int, str],
        min_class_contour_area: float,
        only_keep_overlapping: bool = True,
        clip_to_class_regions: bool = False,
        fine_mask_dilation: int = 0,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if clip_to_class_regions or fine_mask_dilation:
            raise NotImplementedError(
                "clip_to_class_regions and fine_mask_dilation belong to the host "
                "contour route, which is not ported yet (see ROADMAP.md)"
            )
        self.keys_for_class_determination = keys_for_class_determination
        self.keys_for_finegrained_segmentation = keys_for_finegrained_segmentation
        self.keys_for_generation = (
            self.keys_for_class_determination + self.keys_for_finegrained_segmentation
        )
        self.num_clusters = num_clusters
        self.catalog = self.load_catalog()
        self.min_class_contour_area = min_class_contour_area
        self.only_keep_overlapping = only_keep_overlapping
        self.class_label_map = self.load_class_label_map()

    def adjust_catalog(self, catalog: Dict[str, FactorCatalog]) -> Dict[str, FactorCatalog]:
        return {key: cat for key, cat in catalog.items() if key in self.keys_for_generation}

    def load_catalog(self) -> Dict[str, FactorCatalog]:
        npz_path = self.base_dir / "catalogs" / f"{self.num_clusters}.npz"
        if npz_path.exists():
            return self.adjust_catalog(load_catalogs(npz_path))
        pkl_path = npz_path.with_suffix(".pkl")
        if pkl_path.exists():
            raise NotImplementedError(
                f"{pkl_path}: reference pickle catalogs are not ported yet; convert "
                "it to npz with the JAX package (see ROADMAP.md)"
            )
        raise FileNotFoundError(f"no catalog at {npz_path}")

    def load_class_label_map(self) -> Dict[str, Dict[str, List[int]]]:
        """`merged_classes_<k>.json` ({layer: {cluster_id: class}}) inverted to
        {layer: {class: [cluster_ids]}}."""
        map_file = self.base_dir / f"merged_classes_{self.num_clusters}.json"
        with map_file.open() as f:
            class_label_map = json.load(f)
        inverted: Dict[str, Dict[str, List[int]]] = {}
        for key, sub_label_map in class_label_map.items():
            inverted_sub: Dict[str, List[int]] = defaultdict(list)
            for sub_key, label_name in sub_label_map.items():
                inverted_sub[label_name].append(int(sub_key))
            inverted[key] = inverted_sub
        return inverted

    def check_sanity_of_class_label_map(self, relevant_keys) -> Dict:
        color_keys = list(self.class_to_color_map.keys())
        unlabelled = {}
        for key in relevant_keys:
            for class_label in self.class_label_map[key]:
                if class_label not in color_keys:
                    unlabelled.setdefault(key, []).append(class_label)
        return unlabelled

    def compute_masks(self, activations: Dict[str, torch.Tensor]) -> Masks:
        """{(layer_id, class_name): (B, S, S) bool} at image size: per-layer
        nearest-centre labels, cluster -> class OR, nearest upscale."""
        out = {}
        for layer_id, catalog in self.catalog.items():
            labels = catalog.predict(activations[layer_id])
            for class_name, ids in self.class_label_map[layer_id].items():
                ids_t = torch.as_tensor(ids, device=labels.device)
                mask = torch.isin(labels, ids_t)
                if mask.shape[-1] < self.image_size:
                    mask = resize_nearest(mask, self.image_size)
                out[(layer_id, class_name)] = mask
        return out


class BlackWhiteHandwrittenPrintedTextDatasetSegmenter(BaseClusterBasedDatasetSegmenter):
    """Black/white documents with handwritten and printed text."""

    def __init__(self, *args, keys_to_merge: Optional[Dict[str, List[str]]] = None, **kwargs):
        self.keys_to_merge = keys_to_merge or {}
        super().__init__(*args, **kwargs)
        self.keys_for_generation = set(
            reduce(
                lambda x, y: x + y,
                self.keys_to_merge.values(),
                self.keys_for_class_determination + self.keys_for_finegrained_segmentation,
            )
        )
        relevant_keys = set(
            self.keys_for_class_determination
            + self.keys_for_finegrained_segmentation
            + [key for key_list in self.keys_to_merge.values() for key in key_list]
        )
        unlabelled = self.check_sanity_of_class_label_map(relevant_keys)
        if unlabelled:
            raise ValueError(
                "Some of the activation maps were not labelled completely "
                f"(map_id: cluster_id):\n{unlabelled}"
            )

    def adjust_catalog(self, catalog):
        keep = set(self.keys_for_generation) | {
            key for key_list in self.keys_to_merge.values() for key in key_list
        }
        return {k: v for k, v in catalog.items() if k in keep}

    def _build_device_segment_fn(self):
        """activations -> ((B, S, S) uint8 palette indices, (B,) bool drops),
        the whole segmentation on the segmenter's device."""
        class_names = [n for n in self.class_to_color_map if n != "background"]
        self._device_palette = np.stack(
            [np.asarray(self.class_to_color_map["background"])]
            + [np.asarray(self.class_to_color_map[c]) for c in class_names]
        ).astype(np.uint8)
        coarse_keys = list(self.keys_for_class_determination)
        fine_keys = list(self.keys_for_finegrained_segmentation)
        keys_to_merge = dict(self.keys_to_merge)
        only_keep = bool(self.only_keep_overlapping)
        min_area = int(self.min_class_contour_area)
        max_extent = int(self.image_size * 0.95)
        size = self.image_size

        def mask_of(masks: Masks, layer: str, cls: str) -> torch.Tensor:
            if layer in keys_to_merge:
                return reduce(
                    torch.logical_or, [mask_of(masks, src, cls) for src in keys_to_merge[layer]]
                )
            if (layer, cls) not in masks:
                # class unlabelled in this layer: empty mask
                first = next(iter(masks.values()))
                return torch.zeros((first.shape[0], size, size), dtype=torch.bool,
                                   device=first.device)
            return masks[(layer, cls)]

        def segment_masks(masks: Masks):
            coarse = torch.stack([
                torch.stack([mask_of(masks, layer, c) for c in class_names])
                for layer in coarse_keys
            ])
            fine_printed = torch.stack([mask_of(masks, layer, "printed_text") for layer in fine_keys])
            raw_fine = mask_of(masks, fine_keys[-1], "printed_text")
            return device_segment(
                coarse, fine_printed, raw_fine,
                only_keep_overlapping=only_keep, min_area=min_area, max_extent=max_extent,
            )

        @torch.no_grad()
        def fused(activations: Dict[str, torch.Tensor]):
            return segment_masks(self.compute_masks(activations))

        fused.segment_masks = segment_masks
        return fused

    def begin_segment_on_device(self, activations: Dict[int, torch.Tensor]):
        """Run the whole segmentation on the device; returns the device
        tensors (palette indices, drop flags)."""
        if not hasattr(self, "_device_segment_fn"):
            self._device_segment_fn = self._build_device_segment_fn()
        acts = {
            str(k): torch.as_tensor(v, device=self.device)
            for k, v in activations.items()
            if str(k) in self.catalog
        }
        return self._device_segment_fn(acts)

    def finish_segment_on_device(self, pending) -> Tuple[np.ndarray, List[int]]:
        """-> ((B, S, S, 3) uint8 colour masks, ids of images to drop)."""
        idx, drop = pending
        drop_ids = [int(i) for i in np.flatnonzero(drop.cpu().numpy())]
        return self._device_palette[idx.cpu().numpy()], drop_ids
