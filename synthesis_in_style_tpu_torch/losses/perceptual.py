"""Perceptual and style (Gram) losses over VGG16 features (counterpart of
synthesis_in_style_tpu/losses/perceptual.py).

Images and masks are NHWC at the interfaces ((B, H, W, 3), (B, H, W, 1)),
as the JAX package's; the features are the VGG16 trunk's NCHW maps. A mask
is resized to each tap with `jax.image.resize`'s antialiased bilinear
filter (`ops/resize.resize_linear`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from synthesis_in_style_tpu_torch.losses.feature_extractors import VGG16Features, init_extractor
from synthesis_in_style_tpu_torch.ops.resize import resize_linear

# the reference's perceptual / style blocks: conv1_1, conv1_2, conv2_2, conv3_3
VGG16_STYLE_TAPS = {"conv1_1": 0, "conv1_2": 1, "conv2_2": 3, "conv3_3": 6}


def gram_matrix(features: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B*C, B*C) Gram matrix over the flattened spatial axes of an NCHW
    map; a (B, 1, H, W) mask scales each image by mask / ||mask||."""
    b, c, h, w = features.shape
    if mask is not None:
        denom = mask.square().sum(dim=(2, 3), keepdim=True).sqrt()
        features = features * (mask / (denom + 1e-12))
    flat = features.reshape(b * c, h * w)
    return flat @ flat.t()


def style_loss(features: torch.Tensor, target_features: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, c = features.shape[:2]
    g = gram_matrix(features, mask)
    g_target = gram_matrix(target_features, mask).detach()
    return (g - g_target).square().sum() / (4.0 * (b * c) ** 2)


def perceptual_loss(features: torch.Tensor, target_features: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE against the (constant) target features."""
    target = target_features.detach()
    if mask is not None:
        features = features * mask
        target = target * mask.detach()
    return (features - target).square().mean()


def euclidean_distance(a: torch.Tensor, b: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    diff = a - b
    if mask is not None:
        diff = diff * mask
    return diff.square().sum().sqrt() / a.numel()


class PerceptualAndStyleLoss(nn.Module):
    """VGG16-block perceptual loss (conv1_1, conv1_2, conv2_2, conv3_3) and
    conv3_3 Gram style loss; the trunk stops at conv3_3. `state` is a
    VGG16Features state dict (calibrated values need ImageNet weights);
    without it the trunk is a seeded random init. Frozen."""

    def __init__(self, state: Optional[Dict[str, torch.Tensor]] = None,
                 use_perceptual_loss: bool = True, use_style_loss: bool = True, seed: int = 0):
        super().__init__()
        self.vgg = VGG16Features(max_conv=max(VGG16_STYLE_TAPS.values()))
        if state is not None:
            self.vgg.load_state_dict(state, strict=False)
        else:
            init_extractor(self.vgg, seed)
        self.perceptual_taps = dict(VGG16_STYLE_TAPS) if use_perceptual_loss else {}
        self.style_taps = {"conv3_3": VGG16_STYLE_TAPS["conv3_3"]} if use_style_loss else {}
        self.requires_grad_(False)
        self.eval()

    @staticmethod
    def _mask_at(mask: Optional[torch.Tensor], feat: torch.Tensor) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        return resize_linear(mask.permute(0, 3, 1, 2), feat.shape[2], feat.shape[3])

    def forward(self, image: torch.Tensor, target: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (style loss, perceptual loss), each summed over its taps."""
        image_feats = self.vgg(image)
        target_feats = self.vgg(target)
        style_total = image.new_zeros(())
        perceptual_total = image.new_zeros(())
        for tap in self.perceptual_taps.values():
            perceptual_total = perceptual_total + perceptual_loss(
                image_feats[tap], target_feats[tap], self._mask_at(mask, image_feats[tap]))
        for tap in self.style_taps.values():
            style_total = style_total + style_loss(
                image_feats[tap], target_feats[tap], self._mask_at(mask, image_feats[tap]))
        return style_total, perceptual_total


class StyleLossNetwork(nn.Module):
    """The conv3_3 Gram style loss alone."""

    def __init__(self, state: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0):
        super().__init__()
        self.inner = PerceptualAndStyleLoss(state, use_perceptual_loss=False,
                                            use_style_loss=True, seed=seed)

    def forward(self, generated_image: torch.Tensor, style_image: torch.Tensor) -> torch.Tensor:
        return self.inner(generated_image, style_image)[0]
