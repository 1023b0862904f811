"""InceptionV3 pool3 feature extractor for FID (counterpart of
synthesis_in_style_tpu/models/inception_v3.py).

The torchvision inception_v3 feature path up to the 2048-d global average
pool, with pytorch_fid's average pools that count valid cells only
(`count_include_pad=False`) and its max-pooled last block. Module names follow
torchvision, so a pytorch_fid / torchvision state dict loads through
`load_torch_inception_v3`, and the JAX package's converted weights through
`load_inception_npz` (`$SIS_METRIC_WEIGHTS/inception_v3.npz`, written by
its scripts/fetch_metric_weights.py). Without weights the init is random and
the features are not calibrated.

Input: NHWC images in [-1, 1], resized bilinearly to 299x299 by
`preprocess`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.losses.feature_extractors import init_extractor
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    inception_v3_params_from_jax,
    unflatten_npz,
)

Pair = Tuple[int, int]


def avg_pool_no_pad(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """3x3 stride-1 average pool over valid cells only (pytorch_fid's
    FIDInception blocks)."""
    return F.avg_pool2d(x, window, stride=1, padding=window // 2, count_include_pad=False)


class BasicConv2d(nn.Module):
    """conv (no bias) -> inference BatchNorm (eps 1e-3) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Pair,
                 stride: Pair = (1, 1), padding: Pair = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_channels, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(in_channels, pool_features, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_no_pad(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, (3, 3), stride=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=(2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_channels, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(avg_pool_no_pad(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=(2, 2))
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=(2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_channels: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # pytorch_fid's Mixed_7c max-pools
        self.branch1x1 = BasicConv2d(in_channels, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_channels, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = F.max_pool2d(x, 3, 1, padding=1) if self.use_max_pool else avg_pool_no_pad(x)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3Features(nn.Module):
    """NHWC images (already preprocessed) -> the 2048-d pooled embedding
    (pytorch_fid block 3). Always in inference mode: BatchNorm reads its
    running statistics."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=(2, 2))
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.eval()

    def train(self, mode: bool = True) -> "InceptionV3Features":
        return super().train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))  # (B, 2048)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NHWC -> 299x299 NHWC, bilinear with half-pixel centres
    (antialiased only when shrinking, as jax.image.resize)."""
    b, h, w, c = images.shape
    if (h, w) == (299, 299):
        return images
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                      align_corners=False, antialias=h > 299 or w > 299)
    return x.permute(0, 2, 3, 1)


def init_inception(seed: int = 0) -> InceptionV3Features:
    """A random-init InceptionV3Features (seeded kernels, BatchNorm at its
    identity statistics)."""
    return init_extractor(InceptionV3Features(), seed)


def make_inception_feature_fn(model: InceptionV3Features):
    """feature_fn for evaluation.fid.FID: NHWC images in [-1, 1] -> (B, 2048)."""

    @torch.no_grad()
    def feature_fn(images: torch.Tensor) -> torch.Tensor:
        return model(preprocess(images))

    return feature_fn


def load_torch_inception_v3(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision / pytorch_fid inception_v3 state dict -> InceptionV3Features
    state dict: the keys of the feature path (the stem's `Conv2d_*` and the
    `Mixed_*` blocks); `fc` and `AuxLogits` are dropped."""
    keep = set(InceptionV3Features().state_dict())
    out = {k: torch.as_tensor(v) for k, v in state_dict.items() if k in keep}
    missing = keep - set(out)
    if missing:
        raise KeyError(f"inception_v3 state dict lacks {len(missing)} keys, e.g. "
                       f"{sorted(missing)[:3]}")
    return out


def load_inception_npz(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The JAX package's converted InceptionV3 variables, saved flat with
    '/'-joined keys (`params/...`, `batch_stats/...`) -> state dict."""
    with np.load(str(path)) as data:
        tree = unflatten_npz(data)
    return inception_v3_params_from_jax(tree)
