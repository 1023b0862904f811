"""DatasetGAN segmenter (counterpart of
synthesis_in_style_tpu/segmentation/dataset_gan_segmenter.py): every pixel
of a generated image is classified by a pixel-classifier ensemble's vote over
the generator's activations, upsampled to the image size and concatenated.

At 256px a StyleGAN2's 14 layers give 5888 features a pixel, 1.54 GB an
image in float32, so the segmenter upsamples and votes a few images at a time
(`IMAGES_AT_A_TIME`): eval-mode BatchNorm makes each pixel independent, so the
chunks compute what one call over the batch would.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from synthesis_in_style_tpu_torch.models.pixel_classifier import (
    PixelEnsembleClassifier,
    ensemble_from_state,
)
from synthesis_in_style_tpu_torch.segmentation.dataset_segmenter import BaseDatasetSegmenter
from synthesis_in_style_tpu_torch.utils.checkpoint import load_pixel_ensemble_state

IMAGES_AT_A_TIME = 2  # images generated, upsampled or voted at a time (3.1 GB at 256px)
_MODES = {"bilinear": "bilinear", "nearest": "nearest-exact"}


def scale_activations(activations: Dict[int, torch.Tensor], image_size: int,
                      method: str = "bilinear", out: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """{layer: (B, h, w, C_l)} -> (B, S, S, sum C_l), NHWC, the layers in
    key order, each resized to the image size as jax.image.resize does for
    an upsampling: bilinear with half-pixel centres (align_corners=False),
    or nearest (`nearest-exact`). Written into `out` when given."""
    keys = sorted(activations)
    first = activations[keys[0]]
    channels = sum(activations[k].shape[-1] for k in keys)
    if out is None:
        out = torch.empty((first.shape[0], image_size, image_size, channels),
                          dtype=first.dtype, device=first.device)
    offset = 0
    for key in keys:
        act = activations[key]
        c = act.shape[-1]
        target = out[..., offset:offset + c]
        if act.shape[1] == image_size and act.shape[2] == image_size:
            target.copy_(act)
        else:
            kwargs = {"align_corners": False} if method == "bilinear" else {}
            up = F.interpolate(act.permute(0, 3, 1, 2), size=(image_size, image_size),
                               mode=_MODES[method], **kwargs)
            target.copy_(up.permute(0, 2, 3, 1))
        offset += c
    return out


def load_ensemble(path: Union[str, Path], num_classes: int,
                  device: Union[str, torch.device] = "cuda") -> PixelEnsembleClassifier:
    """The ensemble of a snapshot of the port, a reference `.pt`
    (`network_<i>` members) or a JAX `save_pytree_npz` file, in eval mode
    on `device`."""
    state = load_pixel_ensemble_state(path)["ensemble"]
    return ensemble_from_state(state, num_classes).to(device).eval()


class DatasetGANSegmenter(BaseDatasetSegmenter):
    def __init__(self, *args, classifier_path: Union[str, Path],
                 upsample_mode: str = "bilinear", **kwargs):
        super().__init__(*args, **kwargs)
        self.upsample_mode = upsample_mode
        self.ensemble = load_ensemble(classifier_path, len(self.class_to_color_map),
                                      self.device)

    def predict_labels(self, scaled_activations: torch.Tensor) -> torch.Tensor:
        """(B, S, S, F) -> (B, S, S) class ids."""
        b, h, w, f = scaled_activations.shape
        return self.ensemble.predict_classes(scaled_activations.reshape(b * h * w, f)
                                             ).view(b, h, w)

    def label_images_to_color_images(self, label_images) -> np.ndarray:
        """(B, H, W) class ids -> (B, H, W, 3) uint8, each id the colour of
        its position in class_to_color_map."""
        lut = np.asarray(list(self.class_to_color_map.values()), np.uint8).reshape(-1, 3)
        return lut[np.asarray(label_images)]

    def create_segmentation_image(self, activations: Dict[int, torch.Tensor]
                                  ) -> Tuple[np.ndarray, List[int]]:
        """Colour label images of a batch's activations, IMAGES_AT_A_TIME images
        at a time; no image is dropped."""
        batch = next(iter(activations.values())).shape[0]
        labels = torch.empty((batch, self.image_size, self.image_size), dtype=torch.long,
                             device=self.device)
        for start in range(0, batch, IMAGES_AT_A_TIME):
            chunk = {k: v[start:start + IMAGES_AT_A_TIME].to(self.device)
                     for k, v in activations.items()}
            scaled = scale_activations(chunk, self.image_size, self.upsample_mode)
            labels[start:start + IMAGES_AT_A_TIME] = self.predict_labels(scaled)
            del scaled
        return self.label_images_to_color_images(labels.cpu().numpy()), []
