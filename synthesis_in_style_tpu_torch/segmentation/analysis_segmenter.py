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

`fused_page_inference=True` runs the whole page as one function of tensors
(`_page_body`, the counterpart of the JAX package's jitted `fused`): patches
cut on the device from a tensor of their corners, the forward, the device
component filter whenever the area filter is on, and the assembly in patch
order. On a CUDA device it is captured once per page tiling into a
`torch.cuda.CUDAGraph` (`PageProgram`) and replayed; the thresholds are 0-d
tensors the graph reads, so a sweep replays the same graphs. On the CPU the
same function runs eagerly. `segment_images` serves many pages, of mixed
sizes, N to a graph (`pages_per_batch`), with two chunks in flight.
`serving_dtype="bfloat16"` casts the network's parameters and BatchNorm
statistics once and runs the forward in bfloat16, the softmax in float32.

TransUNet and EMANet snapshots serve the same ways (TransUNet's attention
through the flash kernel when its config says `attention_impl: flash`;
EMANet's pages use the snapshot's µ bases, `emau.mu`, where the JAX
package's page path falls back to the initial µ).

`quantized=True` serves DocUFCN with static w8a8 int8
(models/doc_ufcn_quant.py): the first page calibrates the activation scales
on up to four of its patch batches through the float network, which is then
replaced by the quantized one; every int8 conv is the kernel of
`csrc/int8_conv.cu`, on the unfused and the fused (CUDA graph) route alike.

Not ported yet (raises NotImplementedError, see ROADMAP.md): the mesh.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import deque
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd_cuda
from synthesis_in_style_tpu_torch.ops.cuda.int8_conv import int8_conv_cuda
from synthesis_in_style_tpu_torch.ops.cuda.segmented_cc import connected_components_cuda
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to synthesis_in_style_tpu_torch yet (see ROADMAP.md, {item})"
    )


def _serving_dtype(name) -> Optional[torch.dtype]:
    """None for float32 serving, torch.bfloat16 for "bfloat16"."""
    if name is None or str(name) in ("float32", "f32"):
        return None
    if str(name) != "bfloat16":
        raise ValueError(f"serving_dtype {name!r}: float32 or bfloat16")
    return torch.bfloat16


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


class PageProgram:
    """The page body at one key, over `n_pages` pages of one padded shape.

    Its inputs are static tensors on the segmenter's device (`pages`,
    `tops`, `n_patches`, `min_confidence`, `min_contour_area`) that a call
    fills before `run`. On a CUDA device the body is captured once, here,
    into a `torch.cuda.CUDAGraph` (after two eager runs on the side stream
    `stream`, which also settle cuDNN's algorithm choice), and `run` replays
    it: the output is a static tensor that the next replay overwrites. A
    capture or replay that fails raises; nothing falls back to eager. On the
    CPU the body runs eagerly at every `run`.

    At capture the CC kernel wrapper records its labellings into the graph
    and counts them apart (`captured`): `cc_labellings_per_replay` is that
    count, and each replay adds it to the wrapper's count of launches, since
    a replay is where those kernels run. The flash attention forward's
    and the int8 convolution's wrappers are counted the same way
    (`flash_launches_per_replay`, `int8_launches_per_replay`).
    `replays` counts the replays."""

    def __init__(self, body: Callable, n_pages: int, padded_shape: Tuple[int, int, int],
                 n_rows: int, device: torch.device, stream: Optional["torch.cuda.Stream"]):
        hp, wp, channels = padded_shape
        self.pages = torch.zeros((n_pages, hp, wp, channels), dtype=torch.uint8, device=device)
        self.tops = torch.zeros((n_pages, n_rows, 2), dtype=torch.int32, device=device)
        self.n_patches = torch.zeros((n_pages,), dtype=torch.int32, device=device)
        self.min_confidence = torch.zeros((), dtype=torch.float32, device=device)
        self.min_contour_area = torch.zeros((), dtype=torch.float32, device=device)
        self.replays = 0
        self.cc_labellings_per_replay = 0
        self.flash_launches_per_replay = 0
        self.int8_launches_per_replay = 0
        self._body = body
        self._graph = None
        if device.type == "cuda":
            self._capture(device, stream)

    def _inputs(self):
        return (self.pages, self.tops, self.n_patches, self.min_confidence,
                self.min_contour_area)

    def _capture(self, device: torch.device, side: "torch.cuda.Stream") -> None:
        # warm-up and capture on a side stream that the segmenter shares
        # between its programs: the caching allocator keeps freed blocks
        # per stream, so a new stream per program would strand each
        # warm-up's blocks
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._body(*self._inputs())
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = (connected_components_cuda.captured, flash_attention_fwd_cuda.captured,
                  int8_conv_cuda.captured)
        # thread_local: other threads of the process (loader pin-memory
        # threads, PNG writers) may use CUDA meanwhile
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            self.output = self._body(*self._inputs())
        self.cc_labellings_per_replay = connected_components_cuda.captured - before[0]
        self.flash_launches_per_replay = flash_attention_fwd_cuda.captured - before[1]
        self.int8_launches_per_replay = int8_conv_cuda.captured - before[2]
        self._graph = graph

    def run(self, min_confidence: torch.Tensor, min_contour_area: torch.Tensor
            ) -> torch.Tensor:
        """The body on the filled inputs and these thresholds (0-d tensors
        on the device): (n_pages, Hp, Wp, nc) float32 confidences or
        (n_pages, Hp, Wp) uint8 classes."""
        self.min_confidence.fill_(min_confidence)
        self.min_contour_area.fill_(min_contour_area)
        if self._graph is None:
            return self._body(*self._inputs())
        self._graph.replay()
        self.replays += 1
        connected_components_cuda.launches += self.cc_labellings_per_replay
        flash_attention_fwd_cuda.launches += self.flash_launches_per_replay
        int8_conv_cuda.launches += self.int8_launches_per_replay
        return self.output


class AnalysisSegmenter:
    """Max-assembly patch inference."""

    # the assembly the page body implements; the voting subclass overrides
    # it together with assemble_predictions
    _fused_assembly = "max"

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
        if mesh is not None:
            raise _not_ported("mesh serving", "Queue 1 item 11")
        self.serving_dtype = _serving_dtype(serving_dtype)
        if self.serving_dtype is not None and quantized:
            # the w8a8 path calibrates against the float master weights
            raise ValueError("serving_dtype and quantized are mutually exclusive")
        # w8a8 serving calibrates on the first page (`_maybe_calibrate_quant`)
        self.quantized = quantized
        self._quant_calibrated = not quantized
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
        if self.serving_dtype is not None:
            # every floating parameter and buffer (BatchNorm's statistics
            # too) at once: PyTorch's batch norm takes a bfloat16 weight only
            # beside bfloat16 statistics
            self.network.to(self.serving_dtype)
        self.segmenter_config = segmenter_config or SegmenterConfig(
            num_classes=len(self.class_to_color_map))
        self.patch_overlap = resolve_patch_overlap(self.patch_size, patch_overlap,
                                                   patch_overlap_factor)
        self.use_device_component_filter = use_device_component_filter
        self.fused_page_inference = fused_page_inference
        # page programs by structural key; the thresholds are tensors the
        # programs read, so a sweep over them adds no key
        self._programs: Dict[tuple, PageProgram] = {}
        self._capture_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                                else None)
        self._thresholds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

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
        # the builder below loads the checkpoint itself, over any pretrained
        # weights it would otherwise apply
        config.pop("fine_tune", None)
        config.pop("pretrained_path", None)
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
            self._thresholds = None

    def _area_filter_active(self) -> bool:
        """The area filter's on/off, a structural choice taken from the
        Python value (its value itself reaches the device as a tensor)."""
        return float(self.segmenter_config.min_contour_area) > 0

    def _hyperparam_args(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """min_confidence and min_contour_area as 0-d float32 tensors on the
        device, made once per setting."""
        if self._thresholds is None:
            config = self.segmenter_config
            self._thresholds = tuple(
                torch.tensor(float(v), dtype=torch.float32, device=self.device)
                for v in (config.min_confidence, config.min_contour_area))
        return self._thresholds

    def page_programs(self) -> List[PageProgram]:
        """Every page program made so far (one CUDA graph each on a card)."""
        return list(self._programs.values())

    # ---------------- prediction ----------------

    def calculate_bboxes_for_patches(self, image_width: int,
                                     image_height: int) -> Tuple[BBox, ...]:
        return calculate_bboxes_for_patches(image_width, image_height, self.patch_size,
                                            self.patch_overlap)

    @staticmethod
    def _page_array(image) -> np.ndarray:
        arr = np.array(image, dtype=np.uint8)
        return arr[:, :, None] if arr.ndim == 2 else arr

    def _page_tensor(self, image) -> Tuple[torch.Tensor, Tuple[BBox, ...]]:
        """The page as (Hp, Wp, C) uint8 on the device, zero-padded to cover
        every patch, and the patch bboxes."""
        arr = self._page_array(image)
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

    def _forward(self, images: torch.Tensor, min_confidence: torch.Tensor,
                 min_contour_area: torch.Tensor, device_filter: bool) -> torch.Tensor:
        """(B, P, P, C) uint8 patches -> (B, num_classes, P, P) float32
        confidences after the threshold and, with `device_filter`, the
        device component filter. Reads the thresholds on the device only."""
        x = (images.float() / 255.0 - 0.5) / 0.5
        x = x.permute(0, 3, 1, 2)
        if self.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        if self.serving_dtype is not None:
            x = x.to(self.serving_dtype)
        logits = self.network(x).float()
        probs = predict_probabilities(logits, min_confidence, dim=1)
        if device_filter:
            probs = self._filter_components(probs, min_contour_area)
        return probs

    @torch.no_grad()
    def predict_batch(self, images: torch.Tensor) -> torch.Tensor:
        """(B, P, P, C) uint8 patches -> (B, P, P, num_classes) float32
        confidences after the threshold and, with a min_contour_area above
        0, the small-region filter (host, or device when it is on)."""
        config = self.segmenter_config
        area_filter = self._area_filter_active()
        device_filter = area_filter and self.use_device_component_filter
        probs = self._forward(images, *self._hyperparam_args(), device_filter=device_filter)
        if area_filter and not device_filter:
            host = remove_too_small_contours(probs.permute(0, 2, 3, 1).cpu().numpy(),
                                             config.min_contour_area,
                                             config.background_class_id)
            return torch.from_numpy(host).to(self.device)
        return probs.permute(0, 2, 3, 1)

    def _filter_components(self, probs: torch.Tensor, min_contour_area) -> torch.Tensor:
        """Zero the closed components of each non-background class that are
        smaller than min_contour_area pixels; other pixels keep their
        confidences. probs: (B, C, P, P). Built from views and stacks (no
        index list goes to the device), so a CUDA graph can capture it."""
        config = self.segmenter_config
        class_ids = [c for c in range(config.num_classes) if c != config.background_class_id]
        b, _, h, w = probs.shape
        channels = torch.stack([probs[:, c] for c in class_ids]).reshape(
            len(class_ids) * b, h, w)
        mask = (channels * 255.0) >= 1.0
        closed = binary_closing(mask, 5)
        big = filter_small_components(closed, min_contour_area)
        small = closed & ~big
        kept = (channels * ~small).reshape(len(class_ids), b, h, w)
        out = list(probs.unbind(1))
        for j, c in enumerate(class_ids):
            out[c] = kept[j]
        return torch.stack(out, dim=1)

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

    # ---------------- the fused page program ----------------

    def _one_page(self, page: torch.Tensor, tops: torch.Tensor, n_patches: torch.Tensor,
                  min_confidence: torch.Tensor, min_contour_area: torch.Tensor,
                  area_filter: bool, output: str) -> torch.Tensor:
        """One padded page (Hp, Wp, C) uint8, its patch corners (n_rows, 2)
        int32 (top, left; rows past n_patches are padding) -> (Hp, Wp, nc)
        float32 or, for output "classes", (Hp, Wp) uint8. Patches are cut by
        a gather at indices computed from `tops` on the device, so the same
        function serves any page of this padded shape and patch count."""
        p, b = self.patch_size, self.batch_size
        nc = self.segmenter_config.num_classes
        hp, wp, channels = page.shape
        vote = self._fused_assembly == "vote"
        offsets = torch.arange(p, device=page.device)
        flat_page = page.reshape(hp * wp, channels)
        canvas = torch.full((hp * wp, nc), 0.0 if vote else -math.inf, dtype=torch.float32,
                            device=page.device)
        tops = tops.long()
        for i in range(0, tops.shape[0], b):
            rows = tops[i: i + b, :1] + offsets  # (b, p)
            cols = tops[i: i + b, 1:] + offsets
            pixels = rows[:, :, None] * wp + cols[:, None, :]  # (b, p, p) flat indices
            probs = self._forward(flat_page[pixels], min_confidence, min_contour_area,
                                  device_filter=area_filter).permute(0, 2, 3, 1)
            # padding patches take the assembly's identity: -inf for max, 0
            # for votes
            valid = (torch.arange(i, i + b, device=page.device) < n_patches)[:, None, None, None]
            probs = probs * valid if vote else torch.where(valid, probs, -math.inf)
            # one patch at a time, in patch order: the sums are the unfused
            # assembly's, term for term (a patch's pixels are distinct, so
            # each element of a call takes exactly one operand)
            for j in range(b):
                index = pixels[j].reshape(-1)
                patch = probs[j].reshape(-1, nc)
                if vote:
                    canvas.index_add_(0, index, patch)
                else:
                    canvas.scatter_reduce_(0, index[:, None].expand(-1, nc), patch, "amax")
        canvas = canvas.view(hp, wp, nc)
        if output == "classes":
            # the vote normalization does not move the argmax, so it is skipped
            return canvas.argmax(dim=-1).to(torch.uint8)
        if vote:
            canvas = torch.nan_to_num(canvas / canvas.sum(dim=-1, keepdim=True))
        return canvas

    @torch.no_grad()
    def _page_body(self, pages: torch.Tensor, tops: torch.Tensor, n_patches: torch.Tensor,
                   min_confidence: torch.Tensor, min_contour_area: torch.Tensor, *,
                   area_filter: bool, output: str) -> torch.Tensor:
        """N pages back to back (the counterpart of the JAX package's
        lax.map over its fused page program): (N, Hp, Wp, C) uint8, (N,
        n_rows, 2) int32 and (N,) int32 -> the N outputs of `_one_page`,
        stacked."""
        return torch.stack([
            self._one_page(pages[n], tops[n], n_patches[n], min_confidence, min_contour_area,
                           area_filter, output)
            for n in range(pages.shape[0])])

    def _page_program(self, padded_shape: Tuple[int, int, int], n_rows: int, n_pages: int,
                      output: str) -> PageProgram:
        """The program for one page tiling, made on first use. The key is
        structural only, as the JAX package's: (padded shape, n_rows, batch
        size, assembly, area filter on, n_pages, output)."""
        area_filter = self._area_filter_active()
        key = (padded_shape, n_rows, self.batch_size, self._fused_assembly, area_filter,
               n_pages, output)
        program = self._programs.get(key)
        if program is None:
            assert n_rows % self.batch_size == 0, (n_rows, self.batch_size)

            def body(*inputs):
                return self._page_body(*inputs, area_filter=area_filter, output=output)

            program = PageProgram(body, n_pages, padded_shape, n_rows, self.device,
                                  self._capture_stream)
            self._programs[key] = program
        return program

    def _tiling(self, w: int, h: int):
        """(bboxes, Hp, Wp, patch corners as (n, 2) int32) of a W x H page."""
        bboxes = self.calculate_bboxes_for_patches(w, h)
        tops = np.array([(bb.top, bb.left) for bb in bboxes], dtype=np.int32)
        return bboxes, max(bb.bottom for bb in bboxes), max(bb.right for bb in bboxes), tops

    def segment_images(self, images: List, pages_per_batch: int = 4, output: str = "probs",
                       bucket_quantum: Optional[int] = 0) -> List[np.ndarray]:
        """Many pages, `pages_per_batch` to a replay of one multi-page
        program (a short last chunk repeats its first page). Pages of
        different sizes share a program: each page's canvas is padded to
        its tiling's extent rounded up to `bucket_quantum` pixels (0: the
        patch size; None: no rounding, exact tilings only) and its patch
        count is a tensor the program reads, so each page's result equals
        its own tiling's. Up to two chunks are in flight: the host fills
        chunk i+1's (pinned) buffers while the card runs chunk i. Results
        come back in input order. Without fused_page_inference, or with
        pages_per_batch <= 1, pages go one by one through segment_image."""
        if not self.fused_page_inference or pages_per_batch <= 1:
            if output == "classes":
                return [self.segment_image_classes(image) for image in images]
            return [self.segment_image(image) for image in images]
        if bucket_quantum == 0:
            bucket_quantum = self.patch_size
        return self._segment_fused(images, pages_per_batch, output, bucket_quantum)

    def _segment_fused(self, images: List, pages_per_batch: int, output: str,
                       bucket_quantum: Optional[int]) -> List[np.ndarray]:
        """`segment_images` on the fused path (bucket_quantum in pixels, or
        None); a single page is the case of one page a program."""
        channels = self.segmenter_config.num_input_channels
        groups: Dict[tuple, List[tuple]] = {}
        for idx, image in enumerate(images):
            # the pixels are read when the page's chunk is staged, while the
            # card runs the chunk before it
            page = self._prepare_page(image)
            bboxes, hp, wp, tops = self._tiling(page.width, page.height)
            if bucket_quantum:
                hp = math.ceil(hp / bucket_quantum) * bucket_quantum
                wp = math.ceil(wp / bucket_quantum) * bucket_quantum
                sig = (hp, wp)
            else:
                sig = (hp, wp, len(bboxes))
            groups.setdefault(sig, []).append((idx, page, tops, hp, wp))

        results: List[Optional[np.ndarray]] = [None] * len(images)
        for members in groups.values():
            hp = max(m[3] for m in members)
            wp = max(m[4] for m in members)
            n_rows = max(math.ceil(len(m[2]) / self.batch_size) * self.batch_size
                         for m in members)
            program = self._page_program((hp, wp, channels), n_rows, pages_per_batch, output)
            self._serve_chunks(program, members, pages_per_batch, results)
        return results  # type: ignore[return-value]

    def _serve_chunks(self, program: PageProgram, members: List[tuple], pages_per_batch: int,
                      results: List) -> None:
        """Replays `program` over `members` in chunks, two in flight, each
        through its own host staging slot; results[idx] gets each page's
        cropped output."""
        cuda = self.device.type == "cuda"
        names = ("pages", "tops", "n_patches") + (("output",) if cuda else ())
        slots = [{name: torch.empty(getattr(program, name).shape,
                                    dtype=getattr(program, name).dtype, pin_memory=cuda)
                  for name in names}
                 for _ in range(min(2, math.ceil(len(members) / pages_per_batch)))]
        thresholds = self._hyperparam_args()
        in_flight: deque = deque()

        def drain():
            chunk, out, event = in_flight.popleft()
            if event is not None:
                event.synchronize()
            out = out.numpy()
            for j, (idx, page, *_rest) in enumerate(chunk):
                results[idx] = out[j, : page.height, : page.width].copy()

        for k, start in enumerate(range(0, len(members), pages_per_batch)):
            if len(in_flight) == 2:
                drain()
            chunk = members[start: start + pages_per_batch]
            slot = slots[k % len(slots)]
            pages, tops, counts = (slot[name].numpy() for name in ("pages", "tops", "n_patches"))
            tops[:] = 0
            for j, (_, page, page_tops, *_rest) in enumerate(chunk):
                h, w = page.height, page.width
                pages[j, :h, :w] = np.asarray(page).reshape(h, w, -1)
                pages[j, h:] = 0
                pages[j, :h, w:] = 0
                tops[j, : len(page_tops)] = page_tops
                counts[j] = len(page_tops)
            for j in range(len(chunk), pages_per_batch):
                pages[j], tops[j], counts[j] = pages[0], tops[0], counts[0]
            for name in ("pages", "tops", "n_patches"):
                getattr(program, name).copy_(slot[name], non_blocking=cuda)
            out = program.run(*thresholds)
            event = None
            if cuda:  # the output stays in the graph's pool until the next replay
                slot["output"].copy_(out, non_blocking=True)
                out, event = slot["output"], torch.cuda.Event()
                event.record()
            in_flight.append((chunk, out, event))
        while in_flight:
            drain()

    # ---------------- entry points ----------------

    def convert_image_to_correct_color_space(self, image):
        """The image in the network's colour mode (itself if it is in it)."""
        channels = self.segmenter_config.num_input_channels
        mode = {3: "RGB", 1: "L"}.get(channels)
        if mode is None:
            raise ValueError("Can not convert input image to desired format, Network desires "
                             f"inputs with {channels} channels.")
        return image if image.mode == mode else image.convert(mode)

    def _prepare_page(self, image):
        """The page in the network's colour mode, shrunk to max_image_size;
        the caller's image is never changed. The first page calibrates the
        quantized network."""
        page = self.convert_image_to_correct_color_space(image)
        if self.max_image_size and any(side > self.max_image_size for side in page.size):
            page = page.copy() if page is image else page
            page.thumbnail((self.max_image_size, self.max_image_size))
        self._maybe_calibrate_quant(page)
        return page

    @torch.no_grad()
    def _maybe_calibrate_quant(self, page) -> None:
        """First use of the w8a8 path: the float network's per-channel
        activation ranges over up to 4 patch batches of this page, then the
        quantized network in its place and no page program kept."""
        if self._quant_calibrated:
            return
        from synthesis_in_style_tpu_torch.models.doc_ufcn import DocUFCN
        from synthesis_in_style_tpu_torch.models.doc_ufcn_quant import quantize_for_serving

        if not isinstance(self.network, DocUFCN):
            raise ValueError("quantized=True serving currently supports DocUFCN networks "
                             f"only, got {type(self.network).__name__}")
        batches = []
        for batch in self.crop_and_batch_patches(page):
            batches.append(((batch["images"].float() / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2))
            if len(batches) >= 4:
                break
        self.network = quantize_for_serving(self.network, batches)
        self._programs.clear()
        self._quant_calibrated = True

    def segment_image_tensor(self, image) -> torch.Tensor:
        """A PIL page -> its (H, W, C) assembled confidences on the device
        (the unfused path)."""
        image = self._prepare_page(image)
        predicted = self.predict_patches(self.crop_and_batch_patches(image))
        return self.assemble_predictions(predicted, image.size)

    def segment_image(self, image) -> np.ndarray:
        """(H, W, C) float32 assembled class confidences."""
        if self.fused_page_inference:
            return self._segment_fused([image], 1, "probs", None)[0]
        return self.segment_image_tensor(image).cpu().numpy()

    def segment_image_classes(self, image) -> np.ndarray:
        """(H, W) uint8 class ids (argmax on the device; the first maximum
        wins, as numpy's)."""
        if self.fused_page_inference:
            return self._segment_fused([image], 1, "classes", None)[0]
        return self.segment_image_tensor(image).argmax(dim=-1).to(torch.uint8).cpu().numpy()


class VotingAssemblySegmenter(AnalysisSegmenter):
    """Summed-confidence voting, normalized per pixel."""

    _fused_assembly = "vote"

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
