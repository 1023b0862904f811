"""Dataset segmenters: generator activations -> labelled colour masks
(counterpart of synthesis_in_style_tpu/segmentation/dataset_segmenter.py).

The front half (`compute_masks`) assigns every activation pixel of each
catalog layer to its nearest centre, ORs the clusters of each class into a
mask and upsamples it to image size, on the segmenter's device. Two back
halves follow it:

* the host contour route (the JAX package's default): `begin_prepare` starts
  one copy of all masks of a batch to the host, `finish_prepare` waits for
  it, and `segment_prepared` traces, merges, classifies and renders
  polygons on the host (segmentation/contours.py, OpenCV-free);
* the device route (`--device-contours`): the rasterized `device_segment`,
  after which only (B, H, W) uint8 palette indices and (B,) drop flags reach
  the host.
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

from synthesis_in_style_tpu_torch.segmentation import contours as contour_ops
from synthesis_in_style_tpu_torch.segmentation.device_segmenter import device_segment
from synthesis_in_style_tpu_torch.segmentation.factor_catalog import (
    FactorCatalog,
    convert_legacy_catalog,
    load_catalogs,
)
from synthesis_in_style_tpu_torch.utils.contour_ops import bounding_rect, dilate
from synthesis_in_style_tpu_torch.utils.segmentation_utils import resolve_color_map

Masks = Dict[Tuple[str, str], torch.Tensor]
# {sub_image_key: {class_name: (B, H, W) bool numpy}}
PredictedClusters = Dict[str, Dict[str, np.ndarray]]


class BaseDatasetSegmenter:
    def __init__(self, base_dir: Path, image_size: int, class_to_color_map: Dict,
                 device: Union[str, torch.device] = "cuda"):
        self.base_dir = Path(base_dir)
        self.image_size = image_size
        self.device = torch.device(device)
        self.class_to_color_map = resolve_color_map(class_to_color_map)
        self.class_id_map = {
            class_name: class_id for class_id, class_name in enumerate(self.class_to_color_map)
        }


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
        self.keys_for_class_determination = keys_for_class_determination
        self.keys_for_finegrained_segmentation = keys_for_finegrained_segmentation
        self.keys_for_generation = (
            self.keys_for_class_determination + self.keys_for_finegrained_segmentation
        )
        self.num_clusters = num_clusters
        self.catalog = self.load_catalog()
        self.min_class_contour_area = min_class_contour_area
        self.only_keep_overlapping = only_keep_overlapping
        # opt-in creation-config keys of the host route: clip each class's
        # paint to its own (dilated) class-determination mask, and dilate
        # the painted ink mask by N 3x3 iterations
        self.clip_to_class_regions = clip_to_class_regions
        self.fine_mask_dilation = int(fine_mask_dilation)
        self.class_label_map = self.load_class_label_map()

    def adjust_catalog(self, catalog: Dict[str, FactorCatalog]) -> Dict[str, FactorCatalog]:
        return {key: cat for key, cat in catalog.items() if key in self.keys_for_generation}

    def load_catalog(self) -> Dict[str, FactorCatalog]:
        npz_path = self.base_dir / "catalogs" / f"{self.num_clusters}.npz"
        if npz_path.exists():
            return self.adjust_catalog(load_catalogs(npz_path))
        pkl_path = npz_path.with_suffix(".pkl")
        if pkl_path.exists():
            return self.adjust_catalog(convert_legacy_catalog(pkl_path, npz_path))
        raise FileNotFoundError(f"no catalog at {npz_path} or {pkl_path}")

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

    # ---------------- host route: masks to the host once per batch ----------------

    def _prepare_plan(self) -> List[Tuple[str, str]]:
        return [(layer_id, class_name) for layer_id in self.catalog
                for class_name in self.class_label_map[layer_id]]

    @torch.no_grad()
    def begin_prepare(self, activations: Dict[int, torch.Tensor]):
        """Compute the front half's masks on the device and start their
        copy to the host as one (plan, B, S, S) bool tensor, without
        waiting: the caller dispatches the next batch's synthesis before it
        calls `finish_prepare`."""
        acts = {str(k): torch.as_tensor(v, device=self.device)
                for k, v in activations.items() if str(k) in self.catalog}
        masks = self.compute_masks(acts)
        stacked = torch.stack([masks[key] for key in self._prepare_plan()])
        if stacked.device.type != "cuda":
            return stacked, None
        host = torch.empty(stacked.shape, dtype=torch.bool, pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def finish_prepare(self, pending) -> PredictedClusters:
        """Wait for the copy and split it into {layer: {class: (B, S, S)
        bool numpy}}."""
        host, done = pending
        if done is not None:
            done.synchronize()
        unpacked = host.numpy()
        predicted: PredictedClusters = {}
        for (layer_id, class_name), mask in zip(self._prepare_plan(), unpacked):
            predicted.setdefault(layer_id, {})[class_name] = mask
        return predicted

    # ---------------- worker processes of the host route ----------------

    # everything segment_prepared reads: worker processes rebuild the host
    # half from this picklable spec, without catalogs or device state
    CONTOUR_SPEC_ATTRS = (
        "base_dir", "image_size", "class_to_color_map", "class_id_map",
        "keys_for_class_determination", "keys_for_finegrained_segmentation",
        "keys_for_generation", "keys_to_merge", "num_clusters", "min_class_contour_area",
        "only_keep_overlapping", "clip_to_class_regions", "fine_mask_dilation",
    )

    def contour_spec(self) -> Dict:
        """Picklable description of the host half, for
        `contour_pool.ContourWorkerPool`."""
        return {"cls": type(self),
                "attrs": {k: getattr(self, k) for k in self.CONTOUR_SPEC_ATTRS
                          if hasattr(self, k)}}

    @staticmethod
    def from_contour_spec(spec: Dict) -> "BaseClusterBasedDatasetSegmenter":
        """A host-half-only segmenter (skips __init__: no catalog, no
        device)."""
        obj = spec["cls"].__new__(spec["cls"])
        obj.__dict__.update(spec["attrs"])
        return obj

    # ---------------- host route: the contour half ----------------

    def extract_contours(self, predicted_clusters: PredictedClusters,
                         image_ids_to_extract: List[str]) -> contour_ops.ClassContoursForSubImages:
        """Contours of every non-background class mask of the given layers,
        all traced in one call."""
        keys = [(key_id, class_name) for key_id in image_ids_to_extract
                for class_name in predicted_clusters[key_id] if class_name != "background"]
        if not keys:
            return {key_id: {} for key_id in image_ids_to_extract}
        masks = [np.asarray(predicted_clusters[k][c]) for k, c in keys]
        traced = contour_ops.cluster_image_to_contours(np.concatenate(masks))
        result: contour_ops.ClassContoursForSubImages = {k: {} for k in image_ids_to_extract}
        start = 0
        for (key_id, class_name), mask in zip(keys, masks):
            result[key_id][class_name] = traced[start: start + len(mask)]
            start += len(mask)
        return result

    def merge_finegrained_segmentation(self, predicted_clusters: PredictedClusters,
                                       batch_size: int) -> contour_ops.ClassContours:
        """Keep only contours present in all fine-grained layers."""
        return contour_ops.merge_contours_of_same_class_from_different_images(
            self.extract_contours(predicted_clusters, self.keys_for_finegrained_segmentation),
            batch_size, only_keep_overlapping=True, drop_if_size_of_contours_zero=True,
        )

    def classify_fine_grained_contours(self, text_regions_per_class,
                                       fine_grained_contours_per_class,
                                       fine_grained_class_name: str = "printed_text"):
        return contour_ops.classify_fine_grained_contours(
            text_regions_per_class, fine_grained_contours_per_class, self.class_id_map,
            fine_grained_class_name)

    def drop_too_small_contours(self, class_contours) -> contour_ops.ClassContours:
        return contour_ops.drop_too_small_contours(class_contours, self.min_class_contour_area)

    def render_segmentation_image(self, fine_grained_prediction, classified_contours,
                                  batch_size, cluster_class_name: str = "printed_text",
                                  class_clip_masks=None) -> np.ndarray:
        return contour_ops.render_segmentation_image(
            {k: np.asarray(v) for k, v in fine_grained_prediction.items()},
            classified_contours, batch_size, self.image_size, self.class_to_color_map,
            cluster_class_name, class_clip_masks=class_clip_masks)


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

    def merge_sub_images(self, predicted_clusters: PredictedClusters) -> PredictedClusters:
        """OR the class masks of several layers into a virtual layer."""
        for destination_key, keys_to_merge in self.keys_to_merge.items():
            sub_images = [predicted_clusters[key] for key in keys_to_merge]
            predicted_clusters[destination_key] = {
                class_name: reduce(np.logical_or, [sub[class_name] for sub in sub_images])
                for class_name in self.class_to_color_map
            }
        return predicted_clusters

    def extract_text_regions(self, predicted_clusters: PredictedClusters,
                             batch_size: int) -> contour_ops.ClassContours:
        """Coarse text regions from the class-determination layers, merged
        across them, small ones dropped."""
        merged = contour_ops.merge_contours_of_same_class_from_different_images(
            self.extract_contours(predicted_clusters, self.keys_for_class_determination),
            batch_size, only_keep_overlapping=self.only_keep_overlapping,
            drop_if_size_of_contours_zero=True,
        )
        return self.drop_too_small_contours(merged)

    def determine_images_to_drop(self, fine_grained_contours_per_image) -> List[int]:
        """Images with a contour taller and one wider than 95 % of the
        image."""
        image_ids_to_drop = set()
        max_extent = int(self.image_size * 0.95)
        for batch_contours in fine_grained_contours_per_image.values():
            for image_id, contours in enumerate(batch_contours):
                if contours is None:
                    continue
                rects = np.asarray([bounding_rect(c) for c in contours])
                if (rects[:, 3] > max_extent).any() and (rects[:, 2] > max_extent).any():
                    image_ids_to_drop.add(image_id)
        return list(image_ids_to_drop)

    def create_segmentation_image(self, activations) -> Tuple[np.ndarray, List[int]]:
        """The host route for one batch: front half on the device, contour
        half on the host."""
        predicted_clusters = self.finish_prepare(self.begin_prepare(activations))
        batch_size = int(next(iter(activations.values())).shape[0])
        return self.segment_prepared(predicted_clusters, batch_size)

    def segment_prepared(self, predicted_clusters: PredictedClusters, batch_size: int
                         ) -> Tuple[np.ndarray, List[int]]:
        """Host contour half on masks already on the host: sub-image merge,
        coarse text regions, fine contours, classification, area and extent
        drop rules, render. Returns ((B, S, S, 3) uint8 colour masks, ids of
        images to drop)."""
        predicted_clusters = self.merge_sub_images(predicted_clusters)
        text_regions = self.extract_text_regions(predicted_clusters, batch_size)
        fine_grained = self.merge_finegrained_segmentation(predicted_clusters, batch_size)
        classified = self.classify_fine_grained_contours(
            text_regions, fine_grained, fine_grained_class_name="printed_text")
        classified = self.drop_too_small_contours(classified)
        image_ids_to_drop = self.determine_images_to_drop(classified)

        class_clip_masks = None
        if getattr(self, "clip_to_class_regions", False):
            # each class's paint limited to its own merged class-determination
            # mask, dilated twice by 5x5
            class_clip_masks = {}
            for class_name in self.class_to_color_map:
                if class_name == "background":
                    continue
                mask = reduce(np.logical_or, [np.asarray(predicted_clusters[key][class_name])
                                              for key in self.keys_for_class_determination])
                class_clip_masks[class_name] = dilate(
                    mask.astype(np.uint8), np.ones((5, 5), np.uint8), iterations=2).astype(bool)

        fine_prediction = predicted_clusters[self.keys_for_finegrained_segmentation[-1]]
        if getattr(self, "fine_mask_dilation", 0) > 0:
            fine_prediction = {
                name: dilate(np.asarray(mask).astype(np.uint8), np.ones((3, 3), np.uint8),
                             iterations=self.fine_mask_dilation).astype(bool)
                for name, mask in fine_prediction.items()
            }
        segmentation_images = self.render_segmentation_image(
            fine_prediction, classified, batch_size, cluster_class_name="printed_text",
            class_clip_masks=class_clip_masks)
        return segmentation_images, image_ids_to_drop

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
