"""VGG16 feature trunk (counterpart of the VGG16 part of
synthesis_in_style_tpu/losses/feature_extractors.py): the FID fallback
embedding.

Images are NHWC, as everywhere at the port's interfaces; the trunk runs
NCHW and returns NCHW maps. Without pretrained weights the trunk is a
random init drawn from a seeded torch.Generator (flax's default init:
truncated-normal LeCun kernels, zero biases); `load_torch_vgg16_features`
takes a torchvision vgg16 state dict and
`utils.checkpoint.vgg16_features_params_from_jax` the JAX package's params.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16.features conv indices, in order
VGG16_CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
VGG16_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
# 2x2 max pool after these conv positions (0-indexed into the conv list)
VGG16_POOL_AFTER = {1, 3, 6, 9, 12}


class VGG16Features(nn.Module):
    """VGG16 conv trunk on NHWC images; returns the post-ReLU NCHW map of
    every conv layer up to `max_conv` (callers pick their taps)."""

    def __init__(self, max_conv: int = len(VGG16_CHANNELS) - 1, in_channels: int = 3):
        super().__init__()
        self.max_conv = max_conv
        channels = [in_channels] + VGG16_CHANNELS[: max_conv + 1]
        self.convs = nn.ModuleList(nn.Conv2d(c_in, c_out, 3, padding=1)
                                   for c_in, c_out in zip(channels, channels[1:]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i in VGG16_POOL_AFTER and i < len(self.convs) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


@torch.no_grad()
def init_extractor(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random init of every conv from `torch.Generator().manual_seed(seed)`:
    kernels truncated normal (+-2 std) with variance 1 / fan_in, as flax's
    default lecun_normal, biases 0."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            # a unit normal truncated at +-2 has std 0.87962566
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            m.weight.copy_(w * std)
            if m.bias is not None:
                m.bias.zero_()
    return module


def load_torch_vgg16_features(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 state dict (keys `features.<i>.weight`, or the bare
    `<i>.weight` of its features Sequential) -> VGG16Features state dict."""
    prefix = "features." if any(k.startswith("features.") for k in state_dict) else ""
    out = {}
    for i, tid in enumerate(VGG16_CONV_IDS):
        out[f"convs.{i}.weight"] = torch.as_tensor(state_dict[f"{prefix}{tid}.weight"])
        out[f"convs.{i}.bias"] = torch.as_tensor(state_dict[f"{prefix}{tid}.bias"])
    return out


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize_from_unit_range(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NHWC -> torchvision-normalized input."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device, dtype=x.dtype)
    std = torch.as_tensor(IMAGENET_STD, device=x.device, dtype=x.dtype)
    return ((x + 1.0) / 2.0 - mean) / std
