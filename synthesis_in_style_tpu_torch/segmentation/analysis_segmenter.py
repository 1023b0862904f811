"""Patch-tiled whole-page inference (counterpart of
synthesis_in_style_tpu/segmentation/analysis_segmenter.py).

A page goes to the device once, as uint8, zero-padded so that every patch
lies inside it. Patches are cut from it in batches of `batch_size` (the last
batch padded with copies of its last patch, so every forward has one
shape), normalized to [-1, 1], run through the network, and turned into
float32 class confidences by a softmax with the confidence threshold. With
a `min_contour_area` above 0, each non-background class is then cleaned of
small regions. By default that is the JAX package's host filter
(`models/base_segmenter.remove_too_small_contours`: the batch's confidences
are copied to the host, regions of polygon area below the threshold are
zeroed, and they return to the device). With `use_device_component_filter`
it runs on the device as the JAX package's device filter does:
foreground where p * 255 >= 1, a 5x5 closing, and the closed components
smaller than the area (4-connected, in pixels) set to 0
(`segmentation/device_cc.py`; on a CUDA tensor the labelling is the
union-find kernel of `csrc/segmented_cc.cu`). The page is assembled on the
device: per-pixel max over overlapping patches (`AnalysisSegmenter`), or the
summed confidences normalized to sum 1, NaN as 0 (`VotingAssemblySegmenter`).

Not ported yet (each raises NotImplementedError, see ROADMAP.md): the fused
whole-page program,
`segment_images` page batching, the mesh, `quantized` and `serving_dtype`.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.models.base_segmenter import (
    SegmenterConfig,
    predict_probabilities,
    remove_too_small_contours,
)
from synthesis_in_style_tpu_torch.segmentation.device_cc import (
    binary_closing,
    filter_small_components,
)
from synthesis_in_style_tpu_torch.utils.segmentation_utils import BBox


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to synthesis_in_style_tpu_torch yet (see ROADMAP.md)"
    )


def calculate_bboxes_for_patches(image_width: int, image_height: int, patch_size: int,
                                 patch_overlap: Optional[int] = None) -> Tuple[BBox, ...]:
    """Patch bboxes over an image: steps of patch_size - patch_overlap from
    0, or, with patch_overlap None, the fewest patches that cover the image
    with an even overlap."""
    patches: List[BBox] = []
    if patch_overlap is not None:
        current_x, current_y = 0, 0
        while current_y < image_height:
            while current_x < image_width:
                patches.append(BBox(current_x, current_y, current_x + patch_size,
                                    current_y + patch_size))
                current_x += patch_size - patch_overlap
            current_x = 0
            current_y += patch_size - patch_overlap
    else:
        windows_in_width = math.ceil(image_width / patch_size)
        total_width_overlap = windows_in_width * patch_size - image_width
        windows_in_height = math.ceil(image_height / patch_size)
        total_height_overlap = windows_in_height * patch_size - image_height
        width_overlap_per_patch = total_width_overlap // windows_in_width
        height_overlap_per_patch = total_height_overlap // windows_in_height
        for y_idx in range(windows_in_height):
            start_y = int(y_idx * (patch_size - height_overlap_per_patch))
            for x_idx in range(windows_in_width):
                start_x = int(x_idx * (patch_size - width_overlap_per_patch))
                patches.append(BBox(start_x, start_y, start_x + patch_size,
                                    start_y + patch_size))
    return tuple(patches)


def resolve_patch_overlap(patch_size: int, patch_overlap: int = 0,
                          patch_overlap_factor: float = 0.0) -> Optional[int]:
    """An explicit overlap in pixels, or one from a factor of the patch
    size, or None (automatic)."""
    assert patch_overlap == 0 or patch_overlap_factor == 0.0, (
        "Only one of 'patch_overlap' and 'patch_overlap_factor' should be specified"
    )
    if patch_overlap != 0:
        assert 0 < patch_overlap < patch_size, (
            f"The value of 'patch_overlap' should be in the following range: "
            f"0 < patch_overlap < patch_size ({patch_size} px)"
        )
        return patch_overlap
    if patch_overlap_factor != 0.0:
        assert 0.0 < patch_overlap_factor < 1.0, (
            "The value of 'patch_overlap_factor' should be in the following "
            "range: 0.0 < patch_overlap_factor < 1.0"
        )
        return math.ceil(patch_overlap_factor * patch_size)
    return None


class AnalysisSegmenter:
    """Max-assembly patch inference."""

    def __init__(self, model_checkpoint: Union[str, Path, None],
                 class_to_color_map: Union[str, Path, Dict],
                 original_config_path: Optional[Path] = None,
                 batch_size: Optional[int] = None, max_image_size: Optional[int] = None,
                 patch_overlap: int = 0, patch_overlap_factor: float = 0.0,
                 network: Optional[torch.nn.Module] = None, config: Optional[dict] = None,
                 segmenter_config: Optional[SegmenterConfig] = None,
                 use_device_component_filter: bool = False,
                 fused_page_inference: bool = False, mesh=None, quantized: bool = False,
                 serving_dtype: Optional[str] = None, device: Union[str, torch.device] = "cuda"):
        for flag, what in ((fused_page_inference, "fused page inference"),
                           (mesh is not None, "mesh serving"),
                           (quantized, "quantized serving"),
                           (serving_dtype not in (None, "float32", "f32"),
                            f"serving dtype {serving_dtype}")):
            if flag:
                raise _not_ported(what)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda, but no CUDA device is available")
        if config is None:
            config = load_config_from_checkpoint(model_checkpoint, original_config_path)
            config["fine_tune"] = str(model_checkpoint)
        self.config = config
        self.class_to_color_map = self.load_color_map(class_to_color_map)
        self.batch_size = batch_size or self.config.get("batch_size", 1)
        self.patch_size = int(self.config["image_size"])
        self.max_image_size = max_image_size
        if network is None:
            network, segmenter_config = self._load_network(model_checkpoint)
        self.network = network.to(self.device).eval()
        self.segmenter_config = segmenter_config or SegmenterConfig(
            num_classes=len(self.class_to_color_map))
        self.patch_overlap = resolve_patch_overlap(self.patch_size, patch_overlap,
                                                   patch_overlap_factor)
        self.use_device_component_filter = use_device_component_filter

    # ---------------- configuration ----------------

    @staticmethod
    def load_color_map(color_map: Union[str, Path, Dict]) -> dict:
        if isinstance(color_map, dict):
            return color_map
        with Path(color_map).open() as f:
            return json.load(f)

    def _load_network(self, model_checkpoint):
        from synthesis_in_style_tpu_torch.training_builder import get_train_builder_class

        config = dict(self.config)
        config.pop("fine_tune", None)  # the builder below loads the checkpoint itself
        builder = get_train_builder_class(config)(config, device=self.device)
        return builder.get_network_for_inference(model_checkpoint)

    def set_patch_overlap(self, patch_overlap: int, patch_overlap_factor: float):
        self.patch_overlap = resolve_patch_overlap(self.patch_size, patch_overlap,
                                                   patch_overlap_factor)

    def set_hyperparams(self, hyperparam_config: dict) -> None:
        if "patch_overlap" in hyperparam_config:
            self.set_patch_overlap(*hyperparam_config["patch_overlap"])
        replacements = {k: hyperparam_config[k] for k in ("min_confidence", "min_contour_area")
                        if k in hyperparam_config}
        if replacements:
            self.segmenter_config = dataclasses.replace(self.segmenter_config, **replacements)

    # ---------------- prediction ----------------

    def calculate_bboxes_for_patches(self, image_width: int,
                                     image_height: int) -> Tuple[BBox, ...]:
        return calculate_bboxes_for_patches(image_width, image_height, self.patch_size,
                                            self.patch_overlap)

    def _page_tensor(self, image) -> Tuple[torch.Tensor, Tuple[BBox, ...]]:
        """The page as (Hp, Wp, C) uint8 on the device, zero-padded to cover
        every patch, and the patch bboxes."""
        arr = np.array(image, dtype=np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w = arr.shape[:2]
        bboxes = self.calculate_bboxes_for_patches(w, h)
        hp = max(max(bb.bottom for bb in bboxes), h)
        wp = max(max(bb.right for bb in bboxes), w)
        page = torch.zeros((hp, wp, arr.shape[2]), dtype=torch.uint8, device=self.device)
        page[:h, :w] = torch.from_numpy(arr).to(self.device)
        return page, bboxes

    def crop_and_batch_patches(self, input_image) -> Iterator[dict]:
        """{"images": (B, P, P, C) uint8 on the device, "bboxes": ...} per
        batch of patches; border patches are zero-padded."""
        page, bboxes = self._page_tensor(input_image)
        p = self.patch_size
        for i in range(0, len(bboxes), self.batch_size):
            batch_bboxes = bboxes[i: i + self.batch_size]
            images = torch.stack([page[bb.top: bb.top + p, bb.left: bb.left + p]
                                  for bb in batch_bboxes])
            yield {"images": images, "bboxes": batch_bboxes}

    @torch.no_grad()
    def predict_batch(self, images: torch.Tensor) -> torch.Tensor:
        """(B, P, P, C) uint8 patches -> (B, P, P, num_classes) float32
        confidences after the threshold and, with a min_contour_area above
        0, the small-region filter (host, or device when it is on)."""
        config = self.segmenter_config
        x = (images.float() / 255.0 - 0.5) / 0.5
        x = x.permute(0, 3, 1, 2)
        if self.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        logits = self.network(x).float()
        probs = predict_probabilities(logits, config.min_confidence, dim=1)
        if float(config.min_contour_area) > 0:
            if not self.use_device_component_filter:
                host = remove_too_small_contours(probs.permute(0, 2, 3, 1).cpu().numpy(),
                                                 config.min_contour_area,
                                                 config.background_class_id)
                return torch.from_numpy(host).to(self.device)
            probs = self._filter_components(probs, config)
        return probs.permute(0, 2, 3, 1)

    def _filter_components(self, probs: torch.Tensor, config: SegmenterConfig) -> torch.Tensor:
        """Zero the closed components of each non-background class that are
        smaller than min_contour_area pixels; other pixels keep their
        confidences. probs: (B, C, P, P)."""
        class_ids = [c for c in range(config.num_classes) if c != config.background_class_id]
        b, _, h, w = probs.shape
        channels = probs[:, class_ids].transpose(0, 1).reshape(len(class_ids) * b, h, w)
        mask = (channels * 255.0) >= 1.0
        closed = binary_closing(mask, 5)
        big = filter_small_components(closed, config.min_contour_area)
        small = closed & ~big
        kept = (channels * ~small).reshape(len(class_ids), b, h, w).transpose(0, 1)
        out = probs.clone()
        out[:, class_ids] = kept
        return out

    def predict_patches(self, patches: Iterator[dict]) -> List[dict]:
        """[{"prediction": (P, P, num_classes) device tensor, "bbox": ...}];
        a short last batch is padded with copies of its last patch."""
        predicted = []
        for batch in patches:
            images = batch["images"]
            n = images.shape[0]
            if n < self.batch_size:
                images = torch.cat([images, images[-1:].expand(self.batch_size - n,
                                                               *images.shape[1:])])
            probs = self.predict_batch(images)[:n]
            for i, bbox in enumerate(batch["bboxes"]):
                predicted.append({"prediction": probs[i], "bbox": bbox})
        return predicted

    def assemble_predictions(self, patches: List[dict], output_size: Tuple[int, int]
                             ) -> torch.Tensor:
        """Per-pixel max across overlapping patches: (H, W, C)."""
        max_width, max_height = output_size
        assembled = torch.full((max_height, max_width, self.segmenter_config.num_classes),
                               -math.inf, dtype=torch.float32, device=self.device)
        for patch in patches:
            x_start, y_start, x_end, y_end = patch["bbox"]
            x_end, y_end = min(x_end, max_width), min(y_end, max_height)
            window = patch["prediction"][: y_end - y_start, : x_end - x_start]
            region = assembled[y_start:y_end, x_start:x_end]
            torch.maximum(region, window, out=region)
        return assembled

    def convert_image_to_correct_color_space(self, image):
        channels = self.segmenter_config.num_input_channels
        if channels == 3:
            return image.convert("RGB")
        if channels == 1:
            return image.convert("L")
        raise ValueError("Can not convert input image to desired format, Network desires "
                         f"inputs with {channels} channels.")

    def _prepare_page(self, image):
        image = self.convert_image_to_correct_color_space(image)
        if self.max_image_size and any(side > self.max_image_size for side in image.size):
            image.thumbnail((self.max_image_size, self.max_image_size))
        return image

    def segment_image_tensor(self, image) -> torch.Tensor:
        """A PIL page -> its (H, W, C) assembled confidences on the device."""
        image = self._prepare_page(image)
        predicted = self.predict_patches(self.crop_and_batch_patches(image))
        return self.assemble_predictions(predicted, image.size)

    def segment_image(self, image) -> np.ndarray:
        """(H, W, C) float32 assembled class confidences."""
        return self.segment_image_tensor(image).cpu().numpy()

    def segment_image_classes(self, image) -> np.ndarray:
        """(H, W) uint8 class ids (argmax on the device; the first maximum
        wins, as numpy's)."""
        return self.segment_image_tensor(image).argmax(dim=-1).to(torch.uint8).cpu().numpy()


class VotingAssemblySegmenter(AnalysisSegmenter):
    """Summed-confidence voting, normalized per pixel."""

    def assemble_predictions(self, patches: List[dict], output_size: Tuple[int, int]
                             ) -> torch.Tensor:
        max_width, max_height = output_size
        summed = torch.zeros((max_height, max_width, self.segmenter_config.num_classes),
                             dtype=torch.float32, device=self.device)
        for patch in patches:
            x_start, y_start, x_end, y_end = patch["bbox"]
            x_start, y_start = max(x_start, 0), max(y_start, 0)
            x_end, y_end = min(x_end, max_width), min(y_end, max_height)
            summed[y_start:y_end, x_start:x_end] += patch["prediction"][
                : y_end - y_start, : x_end - x_start]
        return torch.nan_to_num(summed / summed.sum(dim=-1, keepdim=True))
