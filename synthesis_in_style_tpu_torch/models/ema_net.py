"""EMANet, the Expectation-Maximization Attention segmenter, in PyTorch
(counterpart of synthesis_in_style_tpu/models/ema_net.py), NCHW.

* Backbone: a deep-stem (3x3 s2 -> 3x3 -> 3x3) dilated ResNet-50 / 101 / 152
  of bottlenecks, output stride 8 (layer3 dilation 2, layer4 dilation 4) or
  16 (layer3 stride 2, layer4 dilation 2); a stage's first block runs at
  dilation {1: 1, 2: 1, 4: 2}[dilation], layer4's blocks multiply theirs by
  the grids [1, 2, 4].
* Head: fc0 (3x3, 2048 -> 512) -> EMAU (k = 64 bases, 3 EM iterations) ->
  fc1 (3x3, 512 -> 256, dropout 0.1) -> fc2 (1x1 to the classes), then a
  bilinear align_corners=True resize to the input size.
* EMAU: the EM loop, and with it the last responsibilities z and bases µ
  that the attention output is built from, carry no gradient, so
  `emau.conv1` never receives one. Its µ bases are the registered buffer
  `emau.mu` (1, C, K): evaluation and page inference use it; in train mode
  the forward returns (logits, the batch's µ (B, C, K)) and the training
  step (updaters/segmentation_updater.emanet_train_step) moves the buffer.
* BatchNorm with torch momentum 3e-4 (flax's 1 - 3e-4), its running
  variance moving towards the biased batch variance as flax's does
  (models/doc_ufcn.BatchNorm2d).
* Submodules carry the reference torch model's state-dict keys
  (`extractor.0.{0,1,3,4,6}` the deep stem, `extractor.1` its last BN,
  `extractor.{4..7}.{i}.conv{1,2,3}/bn{1,2,3}/downsample.{0,1}` the four
  stages, `fc0.{conv,bn}`, `emau.conv1`, `emau.conv2.{0,1}`, `emau.mu`,
  `fc1.0.{conv,bn}`, `fc2`), the keys `torch_emanet_to_flax` of the JAX
  package reads, so a reference `.pt` loads as it is.

The JAX package's `s2d_stem` config key re-lowers the same stem for the
TPU's layout; the port's builder ignores it and computes the plain stem.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.models.doc_ufcn import BatchNorm2d, _truncated_normal
from synthesis_in_style_tpu_torch.ops.resize import resize_bilinear_align_corners

BN_MOM = 3e-4
RESNET_LAYERS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, momentum=BN_MOM)


def _conv(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
          dilation: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                     padding=dilation * (kernel - 1) // 2, dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 to 4 x planes, each with BN,
    plus the (projected) residual, ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = _bn(planes * 4)
        self.downsample = (nn.Sequential(_conv(inplanes, planes * 4, 1, stride),
                                         _bn(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetStage(nn.Sequential):
    """The reference `_make_layer`: the first block may stride and project;
    dilation-2 stages start at dilation 1, dilation-4 stages at 2; the other
    blocks run at dilation x grids[i]."""

    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int = 1,
                 dilation: int = 1, grids: Optional[Sequence[int]] = None):
        grids = list(grids) if grids else [1] * blocks
        layers = [Bottleneck(inplanes, planes, stride, {1: 1, 2: 1, 4: 2}[dilation],
                             downsample=stride != 1 or inplanes != planes * 4)]
        layers += [Bottleneck(planes * 4, planes, 1, dilation * grids[i])
                   for i in range(1, blocks)]
        super().__init__(*layers)


class ResNetExtractor(nn.Sequential):
    """[deep stem, bn1, relu, maxpool, layer1, layer2, layer3, layer4]: the
    reference's `extractor` Sequential."""

    def __init__(self, n_layers: int = 50, stride: int = 8):
        layers = RESNET_LAYERS[n_layers]
        stem = nn.Sequential(_conv(3, 64, 3, 2), _bn(64), nn.ReLU(),
                             _conv(64, 64, 3), _bn(64), nn.ReLU(),
                             _conv(64, 128, 3))
        if stride == 16:
            layer3 = ResNetStage(512, 256, layers[2], stride=2)
            layer4 = ResNetStage(1024, 512, layers[3], dilation=2, grids=[1, 2, 4])
        elif stride == 8:
            layer3 = ResNetStage(512, 256, layers[2], dilation=2)
            layer4 = ResNetStage(1024, 512, layers[3], dilation=4, grids=[1, 2, 4])
        else:
            raise RuntimeError(f"unknown stride: {stride}")
        super().__init__(stem, _bn(128), nn.ReLU(), nn.MaxPool2d(3, 2, 1),
                         ResNetStage(128, 64, layers[0]),
                         ResNetStage(256, 128, layers[1], stride=2),
                         layer3, layer4)


def _l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / (1e-6 + torch.linalg.vector_norm(x, dim=dim, keepdim=True))


def init_emau_mu(channels: int, k: int, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Kaiming-normal µ bases (1, channels, k), l2-normalized over the
    channels (the reference EMAU's init; the JAX package draws its own from
    jax.random)."""
    mu = torch.randn((1, channels, k), generator=generator) * math.sqrt(2.0 / k)
    return _l2norm(mu, dim=1)


class EMAU(nn.Module):
    """Expectation-Maximization Attention Unit over `mu` (1, C, K)."""

    def __init__(self, channels: int, k: int, stage_num: int = 3):
        super().__init__()
        self.stage_num = stage_num
        self.register_buffer("mu", init_emau_mu(channels, k))
        self.conv1 = nn.Conv2d(channels, channels, 1)
        self.conv2 = nn.Sequential(nn.Conv2d(channels, channels, 1, bias=False), _bn(channels))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(features, the batch's bases µ (B, C, K))."""
        idn = x
        x = self.conv1(x)
        b, c, h, w = x.shape
        x_cn = x.reshape(b, c, h * w)  # (B, C, N), n = y * w + x
        with torch.no_grad():
            x_nc = x_cn.transpose(1, 2)  # (B, N, C)
            mu = self.mu.to(x.dtype).expand(b, c, -1)
            for _ in range(self.stage_num):
                z = torch.softmax(torch.bmm(x_nc, mu), dim=2)  # (B, N, K)
                z_norm = z / (1e-6 + z.sum(dim=1, keepdim=True))
                mu = _l2norm(torch.bmm(x_cn, z_norm), dim=1)  # (B, C, K)
            # the attention reuses the last iteration's z (computed against
            # the bases before that iteration's update)
            x_attn = torch.bmm(mu, z.transpose(1, 2)).reshape(b, c, h, w)
        out = self.conv2(F.relu(x_attn))
        return F.relu(out + idn), mu


class ConvBNReLU(nn.Module):
    """conv (no bias) -> BatchNorm -> ReLU, keys `conv` and `bn`."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__()
        self.conv = _conv(in_channels, out_channels, kernel)
        self.bn = _bn(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class EMANet(nn.Module):
    """Input (B, 3, H, W) in [-1, 1]. Eval mode: logits (B, num_classes, H,
    W) against the stored bases; train mode: (logits, the batch's µ)."""

    def __init__(self, num_classes: int, n_layers: int = 50, stride: int = 8,
                 stage_num: int = 3, emau_channels: int = 512, emau_k: int = 64):
        super().__init__()
        self.num_classes = num_classes
        self.emau_channels, self.emau_k = emau_channels, emau_k
        self.dropout = 0.1  # before fc2; a step parity test sets it to 0
        self.extractor = ResNetExtractor(n_layers, stride)
        self.fc0 = ConvBNReLU(2048, emau_channels, 3)
        self.emau = EMAU(emau_channels, emau_k, stage_num)
        self.fc1 = nn.Sequential(ConvBNReLU(emau_channels, 256, 3))
        self.fc2 = nn.Conv2d(256, num_classes, 1)

    def segmenter_config(self, background_class_id: int = 0, min_confidence: float = 0.0,
                         min_contour_area: int = 0) -> SegmenterConfig:
        return SegmenterConfig(num_classes=self.num_classes,
                               background_class_id=background_class_id,
                               min_confidence=min_confidence,
                               min_contour_area=min_contour_area)

    def forward(self, x: torch.Tensor):
        size = x.shape[2:4]
        x = self.fc0(self.extractor(x))
        x, mu = self.emau(x)
        x = F.dropout(self.fc1(x), self.dropout, self.training)
        pred = resize_bilinear_align_corners(self.fc2(x), size[0], size[1])
        return (pred, mu) if self.training else pred

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "EMANet":
        """flax's initializers (lecun_normal convolution kernels, a normal
        truncated at 2 sigma with fan-in variance, zero biases, BatchNorm
        scale 1 and bias 0, running mean 0 and variance 1), and µ from
        `init_emau_mu`, all drawn from `generator`."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                # jax truncated_normal(-2, 2) has std 0.87962566 before scaling
                std = math.sqrt(1.0 / module.weight[0].numel()) / 0.87962566103423978
                module.weight.copy_(_truncated_normal(module.weight.shape, generator) * std)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
        self.emau.mu.copy_(init_emau_mu(self.emau_channels, self.emau_k, generator))
        return self
