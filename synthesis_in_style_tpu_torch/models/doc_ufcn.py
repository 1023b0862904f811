"""DocUFCN document segmenter (counterpart of
synthesis_in_style_tpu/models/doc_ufcn.py), NCHW.

* Encoder: one block per feature size (32/64/128/256 published), each five
  3x3 convolutions with dilations 1, 2, 4, 8, 16 (padding = dilation) and
  BatchNorm + ReLU + Dropout after each, 2x2 max-pool between blocks.
* Decoder: per level a 3x3 conv and a 2x2 / stride-2 transposed conv
  upsample (or, `pixel_shuffle`, a conv to 4x the features and
  `nn.PixelShuffle(2)`), then a channel concat with the encoder feature of
  the same resolution; a 3x3 classifier gives the logits.
* Submodules carry the reference's state-dict keys
  (`encoder_blocks.{b}.{i}.{conv,bn}`, `decoder_blocks.{d}.{conv,upsample}.
  {conv,bn}`, `classifier`), so a reference `.pt` loads as it is.
* BatchNorm follows flax's `nn.BatchNorm(momentum=0.9)`: the running
  variance is updated with the biased batch variance (torch's own update
  uses the unbiased one).

The JAX package's `s2d_stem`, `s2d_tail` and `dropout_rng_impl` re-lower the
same function for the TPU's layout; the port takes those config keys and
computes the plain layout.

`remat=True` recomputes each encoder and decoder block in the backward pass
(`torch.utils.checkpoint`, non-reentrant, the RNG state preserved so that
dropout draws the same masks), the blocks the JAX package wraps in
`nn.remat`: only block-boundary tensors are kept. A memory lever, not a
speed one. The recompute normalizes with the batch statistics as the
forward did but leaves BatchNorm's running statistics alone, so they move
once per step.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.parallel import distributed

ENCODER_DILATIONS = (1, 2, 4, 8, 16)

# set while torch.utils.checkpoint recomputes a block of a remat DocUFCN
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = False


def _remat_contexts():
    """checkpoint's (forward, recompute) contexts: only the recompute is
    flagged, so BatchNorm updates its running statistics once."""
    return contextlib.nullcontext(), _recomputing()


class BiasedRunningVariance:
    """Mixin for a torch BatchNorm whose running variance moves towards the
    biased batch variance, as flax's does. The normalization is torch's own
    (cuDNN on the card); after it, the running variance is corrected from
    torch's unbiased update by the factor (n - 1) / n on the part that
    update added. In a launched multi-process run, training normalizes with
    the global batch's statistics (parallel/distributed.py
    `global_batch_norm`) and the running statistics move towards them."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        recompute = getattr(_RECOMPUTE, "active", False)
        if distributed.is_initialized():
            # a launched run: the statistics of the global batch
            y, mean, var = distributed.global_batch_norm(x, self.weight, self.bias, self.eps)
            if not recompute:
                with torch.no_grad():
                    self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                    self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
                    self.num_batches_tracked.add_(1)
            return y
        if recompute:
            # a remat block's recompute: the same call on copies of the
            # statistics, which are then dropped (the output uses the batch's)
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        # torch's update goes into a copy (autograd keeps the tensor it was
        # given); the corrected value then goes into the buffer
        running_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, running_var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            self.running_var.copy_(kept + (running_var - kept) * ((n - 1) / n))
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(BiasedRunningVariance, nn.BatchNorm2d):
    """`nn.BatchNorm2d` (momentum 0.1 = flax's 0.9, eps 1e-5) with flax's
    running-variance update."""


class ConvBNActDrop(nn.Module):
    """conv -> BatchNorm -> ReLU -> Dropout."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 dilation: int = 1, dropout: float = 0.4, transpose: bool = False):
        super().__init__()
        if transpose:
            self.conv = nn.ConvTranspose2d(in_channels, features, kernel_size, stride=kernel_size)
        else:
            pad = dilation if kernel_size == 3 else kernel_size // 2
            self.conv = nn.Conv2d(in_channels, features, kernel_size, padding=pad,
                                  dilation=dilation)
        self.bn = BatchNorm2d(features)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        if self.dropout > 0:
            x = F.dropout(x, self.dropout, self.training)
        return x


class DecoderBlock(nn.Module):
    """conv, then the 2x transposed-conv upsample."""

    def __init__(self, in_channels: int, features: int, dropout: float):
        super().__init__()
        self.conv = ConvBNActDrop(in_channels, features, dropout=dropout)
        self.upsample = ConvBNActDrop(features, features, kernel_size=2, dropout=dropout,
                                      transpose=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsample(self.conv(x))


class PixelShuffleDecoderBlock(nn.Module):
    """conv to 4x the features, then `nn.PixelShuffle(2)`."""

    def __init__(self, in_channels: int, features: int, dropout: float):
        super().__init__()
        self.conv = ConvBNActDrop(in_channels, features * 4, dropout=dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(x), 2)


class DocUFCN(nn.Module):
    """Input (B, C, H, W) in [-1, 1]; output (B, num_classes, H, W) logits."""

    def __init__(self, num_classes: int, input_channels: int = 3,
                 encoder_dropout: float = 0.4, decoder_dropout: float = 0.4,
                 feature_sizes: Sequence[int] = (32, 64, 128, 256),
                 pixel_shuffle: bool = False, remat: bool = False,
                 s2d_stem: int = 0, s2d_tail: bool = False):
        super().__init__()
        self.remat = remat
        # s2d_stem / s2d_tail are exact TPU re-lowerings of this same
        # function: accepted, and the plain layout is computed
        self.num_classes = num_classes
        self.input_channels = input_channels
        self.feature_sizes = tuple(int(f) for f in feature_sizes)
        self.pixel_shuffle = pixel_shuffle
        blocks, prev = [], input_channels
        for features in self.feature_sizes:
            layers = []
            for dilation in ENCODER_DILATIONS:
                layers.append(ConvBNActDrop(prev, features, dilation=dilation,
                                            dropout=encoder_dropout))
                prev = features
            blocks.append(nn.Sequential(*layers))
        self.encoder_blocks = nn.ModuleList(blocks)
        decoder_cls = PixelShuffleDecoderBlock if pixel_shuffle else DecoderBlock
        rev = list(reversed(self.feature_sizes))
        decoders = []
        for features in rev[1:]:
            decoders.append(decoder_cls(prev, features, decoder_dropout))
            prev = 2 * features  # the upsampled features and the skip
        self.decoder_blocks = nn.ModuleList(decoders)
        self.classifier = nn.Conv2d(prev, num_classes, 3, padding=1)

    def segmenter_config(self, background_class_id: int = 0, min_confidence: float = 0.7,
                         min_contour_area: int = 55) -> SegmenterConfig:
        return SegmenterConfig(num_classes=self.num_classes,
                               background_class_id=background_class_id,
                               min_confidence=min_confidence,
                               min_contour_area=min_contour_area,
                               num_input_channels=self.input_channels)

    def _block(self, block: nn.Module, h: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, h, use_reentrant=False, preserve_rng_state=True,
                              context_fn=_remat_contexts)
        return block(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        h = x
        for i, block in enumerate(self.encoder_blocks):
            if i > 0:
                skips.append(h)
                h = F.max_pool2d(h, 2, 2)
            h = self._block(block, h)
        for block, skip in zip(self.decoder_blocks, reversed(skips)):
            h = torch.cat([self._block(block, h), skip], dim=1)
        return self.classifier(h)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "DocUFCN":
        """flax's initializers: lecun_normal convolution kernels (a normal
        truncated at 2 sigma, fan-in variance), zero biases, BatchNorm scale 1
        and bias 0, running mean 0 and variance 1."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                w = module.weight
                if isinstance(module, nn.ConvTranspose2d):  # (in, out, kh, kw); flax fan-in
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                else:
                    fan_in = w[0].numel()
                # jax truncated_normal(-2, 2) has std 0.87962566 before scaling
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w.copy_(_truncated_normal(w.shape, generator) * std)
                module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
        return self


def _truncated_normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out


def get_doc_ufcn(version: str):
    """'base' | 'no_dropout' | 'pixelshuffle' -> a DocUFCN constructor."""
    if version == "base":
        return DocUFCN
    if version == "no_dropout":
        return functools.partial(DocUFCN, encoder_dropout=0.0, decoder_dropout=0.0)
    if version == "pixelshuffle":
        return functools.partial(DocUFCN, pixel_shuffle=True)
    raise NotImplementedError(
        f"the network you wish for is not implemented, you wished for {version}"
    )
