"""VGG16, AlexNet and SqueezeNet 1.1 feature trunks (counterpart of
synthesis_in_style_tpu/losses/feature_extractors.py): the FID fallback
embedding, the perceptual and style losses (VGG16) and LPIPS's backbones.

Images are NHWC, as everywhere at the port's interfaces; the trunks run
NCHW and return NCHW maps. Without pretrained weights a trunk is a random
init drawn from a seeded torch.Generator (flax's default init:
truncated-normal LeCun kernels, zero biases); `load_torch_*_features` take a
torchvision state dict and `utils.checkpoint.*_features_params_from_jax`
the JAX package's params.
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
    """Random init of every conv from `torch.Generator().manual_seed(seed)`
    (`lecun_init_`)."""
    return lecun_init_(module, torch.Generator().manual_seed(seed))


@torch.no_grad()
def lecun_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """flax's default init of every conv of `module`, drawn from `gen`:
    kernels truncated normal (+-2 std) with variance 1 / fan_in
    (lecun_normal), biases 0."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
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


# ---------------------------------------------------------------------------
# AlexNet (LPIPS "alex")

ALEXNET_CHANNELS = [64, 192, 384, 256, 256]
# (features, kernel, stride, padding)
ALEXNET_SPECS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
                 (256, 3, 1, 1)]
ALEXNET_POOL_AFTER = {0, 1}
ALEXNET_TORCH_CONV_IDS = [0, 3, 6, 8, 10]


class AlexNetFeatures(nn.Module):
    """AlexNet conv trunk on NHWC images; the post-ReLU NCHW maps of its
    five convs (the LPIPS taps), a 3x3 / 2 max pool after the first two."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        convs, c_in = [], in_channels
        for features, kernel, stride, pad in ALEXNET_SPECS:
            convs.append(nn.Conv2d(c_in, features, kernel, stride=stride, padding=pad))
            c_in = features
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i in ALEXNET_POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats


# ---------------------------------------------------------------------------
# SqueezeNet 1.1 (LPIPS "squeeze"): taps after the stem and after Fire
# modules 1, 3, 4, 5, 6, 7 (64/128/256/384/384/512/512 channels)

SQUEEZENET_CHANNELS = [64, 128, 256, 384, 384, 512, 512]
SQUEEZE_FIRES = [(16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192),
                 (64, 256), (64, 256)]
# torchvision features indices of the Fire modules
SQUEEZE_FIRE_IDS = [3, 4, 6, 7, 9, 10, 11, 12]
SQUEEZE_POOL_BEFORE = {0, 2, 4}
SQUEEZE_TAP_AFTER = {1, 3, 4, 5, 6, 7}


class Fire(nn.Module):
    """1x1 squeeze -> ReLU -> concat(ReLU(1x1 expand), ReLU(3x3 expand))."""

    def __init__(self, in_channels: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(in_channels, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class SqueezeNetFeatures(nn.Module):
    """squeezenet1_1 trunk on NHWC images; the seven LPIPS tap maps (NCHW).
    The max pools are 3x3 / 2 with ceil mode, as torchvision's."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_channels, 64, 3, stride=2)
        fires, c_in = [], 64
        for squeeze, expand in SQUEEZE_FIRES:
            fires.append(Fire(c_in, squeeze, expand))
            c_in = 2 * expand
        self.fires = nn.ModuleList(fires)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.conv_0(x.permute(0, 3, 1, 2)))
        feats = [x]
        for i, fire in enumerate(self.fires):
            if i in SQUEEZE_POOL_BEFORE:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            x = fire(x)
            if i in SQUEEZE_TAP_AFTER:
                feats.append(x)
        return feats


def _torch_prefix(state_dict: Dict[str, torch.Tensor]) -> str:
    return "features." if any(k.startswith("features.") for k in state_dict) else ""


def load_torch_alexnet_features(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision alexnet state dict -> AlexNetFeatures state dict."""
    prefix, out = _torch_prefix(state_dict), {}
    for i, tid in enumerate(ALEXNET_TORCH_CONV_IDS):
        for leaf in ("weight", "bias"):
            out[f"convs.{i}.{leaf}"] = torch.as_tensor(state_dict[f"{prefix}{tid}.{leaf}"])
    return out


def load_torch_squeezenet_features(state_dict: Dict[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """torchvision squeezenet1_1 state dict -> SqueezeNetFeatures state dict."""
    prefix = _torch_prefix(state_dict)
    out = {f"conv_0.{leaf}": torch.as_tensor(state_dict[f"{prefix}0.{leaf}"])
           for leaf in ("weight", "bias")}
    for i, tid in enumerate(SQUEEZE_FIRE_IDS):
        for conv in ("squeeze", "expand1x1", "expand3x3"):
            for leaf in ("weight", "bias"):
                out[f"fires.{i}.{conv}.{leaf}"] = torch.as_tensor(
                    state_dict[f"{prefix}{tid}.{conv}.{leaf}"])
    return out
