"""Static w8a8 post-training quantization of DocUFCN for serving
(counterpart of synthesis_in_style_tpu/models/doc_ufcn_quant.py): int8
tensors flow between the layers.

* `calibrate` runs the float network (models/doc_ufcn.py, unchanged) over
  calibration batches and records, through forward hooks, the per-channel
  abs-max at the JAX package's sites: every ConvBNActDrop output
  (`encoder_{b}/conv_{i}`, `decoder_{d}/conv`, `decoder_{d}/upsample`) and
  every decoder block output (`decoder_{d}`, after its upsample).
* `pack_quant` folds the activation scales into the weights
  (ops/quant.py `quantize_weight_folded`), quantizes them per output
  channel, and folds conv bias and eval-mode BatchNorm into two float32
  vectors per site, so the runtime chain of a site is
  int8 conv -> relu(acc * mul + add) -> requantize. The decoder's skip
  concat feeds one int8 conv: its two inputs' scales fold into one weight.
* The 2x2 / stride-2 transposed-conv upsample becomes a 1x1 int8 conv to 4F
  channels and a depth-to-space (exact: every output pixel receives one
  kernel tap).
* `quantized_forward` mirrors `DocUFCN.forward` in eval mode: the first conv
  runs in bfloat16 on the 3-channel image, as in the JAX package, and the
  classifier emits float32 logits. Every other conv is the int8 kernel on
  the card (ops/quant.py `int8_conv`), its plain version on the CPU.

The port computes in NHWC inside (the int8 layout) and takes and returns
NCHW like DocUFCN. The port's pixel-shuffle conv orders its 4F channels as
(channel, parity) for `F.pixel_shuffle` where the JAX package orders them
(parity, channel); the packed scales and the depth-to-space follow the
port's order. The JAX package's s2d flags are re-lowerings of the same
function and the port computes the plain layout, so an s2d checkpoint
quantizes as it is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.models.doc_ufcn import (
    ENCODER_DILATIONS,
    ConvBNActDrop,
    DocUFCN,
)
from synthesis_in_style_tpu_torch.ops.quant import (
    int8_conv,
    quantize_weight_folded,
    requantize,
    scale_from_amax,
)

Site = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# calibration


def scale_sites(model: DocUFCN) -> Dict[str, nn.Module]:
    """{JAX site name: the port module whose output it is}."""
    sites: Dict[str, nn.Module] = {}
    for b, block in enumerate(model.encoder_blocks):
        for i, layer in enumerate(block):
            sites[f"encoder_{b}/conv_{i}"] = layer
    for d, block in enumerate(model.decoder_blocks):
        sites[f"decoder_{d}"] = block
        for name, child in block.named_children():
            if isinstance(child, ConvBNActDrop):
                sites[f"decoder_{d}/{name}"] = child
    return sites


@torch.no_grad()
def calibrate(model: DocUFCN, batches: Sequence[torch.Tensor]) -> Dict[str, np.ndarray]:
    """Run the float model in eval mode over normalized (B, C, H, W) batches
    and return {site: (C,) float32 per-channel abs-max}, the maximum over
    the batches."""
    amax: Dict[str, np.ndarray] = {}

    def hook(name):
        def record(_module, _inputs, output):
            per_channel = output.float().abs().amax(dim=(0, 2, 3)).cpu().numpy()
            prev = amax.get(name)
            amax[name] = per_channel if prev is None else np.maximum(prev, per_channel)
        return record

    was_training = model.training
    handles = [module.register_forward_hook(hook(name))
               for name, module in scale_sites(model).items()]
    try:
        model.eval()
        for batch in batches:
            model(batch)
    finally:
        for handle in handles:
            handle.remove()
        model.train(was_training)
    return amax


def quant_scales_from_amax(amax: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """abs-max -> per-channel int8 scales (float32), zero-safe."""
    return {k: scale_from_amax(v) for k, v in amax.items()}


# ---------------------------------------------------------------------------
# pack


def _bn_affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as (mul, add) per channel, float32."""
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return inv, bn.bias.float() - bn.running_mean.float() * inv


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.detach().float().permute(2, 3, 1, 0)


def _pack_conv_site(layer: ConvBNActDrop, s_in: torch.Tensor,
                    s_out: Optional[torch.Tensor]) -> Site:
    """One ConvBNActDrop: int8 weight with the input scales folded in, and
    the epilogue relu(acc * mul + add), requantized by `s_out` if given."""
    w_q, s_w = quantize_weight_folded(_hwio(layer.conv), s_in)
    bn_mul, bn_add = _bn_affine(layer.bn)
    site = {"w_q": w_q, "mul": s_w * bn_mul,
            "add": layer.conv.bias.detach().float() * bn_mul + bn_add}
    if s_out is not None:
        site["s_out"] = torch.broadcast_to(s_out.float(), site["mul"].shape).clone()
    return site


def _pack_transpose_up(layer: ConvBNActDrop, s_in: torch.Tensor, s_out: torch.Tensor) -> Site:
    """2x2 / stride-2 ConvTranspose2d as a 1x1 int8 conv to 4F channels in
    (a, b, f) order: torch stamps w[c, f, a, b] at output pixel (2i + a,
    2j + b), which `_depth_to_space_int8` then places. The per-channel
    epilogue vectors repeat over the four taps."""
    w = layer.conv.weight.detach().float()  # (C, F, 2, 2)
    c_in, feat, kh, kw = w.shape
    assert kh == 2 and kw == 2, w.shape
    w1 = w.permute(0, 2, 3, 1).reshape(1, 1, c_in, 4 * feat)
    w_q, s_w = quantize_weight_folded(w1, s_in)
    bn_mul, bn_add = _bn_affine(layer.bn)
    return {"w_q": w_q, "mul": s_w * bn_mul.repeat(4),
            "add": (layer.conv.bias.detach().float() * bn_mul + bn_add).repeat(4),
            "s_out": torch.broadcast_to(s_out.float(), (feat,)).repeat(4)}


@torch.no_grad()
def pack_quant(model: DocUFCN, scales: Dict[str, torch.Tensor]) -> Dict[str, Site]:
    """Fold the calibrated scales, the float weights, the conv biases and
    the BatchNorm running statistics into the static serving tree of
    `quantized_forward`, on the model's device. Mirrors the forward's scale
    propagation, the decoder skip-concat input scales included."""
    device = model.classifier.weight.device
    packed: Dict[str, Site] = {}

    def site_scale(name: str) -> torch.Tensor:
        return torch.as_tensor(scales[name], dtype=torch.float32, device=device)

    # encoder_0/conv_0 stays float; only its output scale is kept
    s = site_scale("encoder_0/conv_0")
    packed["encoder_0/conv_0"] = {"s_out": s}
    for i in range(1, len(ENCODER_DILATIONS)):
        name = f"encoder_0/conv_{i}"
        s_next = site_scale(name)
        packed[name] = _pack_conv_site(model.encoder_blocks[0][i], s, s_next)
        s = s_next

    skip_scales: List[torch.Tensor] = []
    for blk in range(1, len(model.feature_sizes)):
        skip_scales.append(s)
        for i in range(len(ENCODER_DILATIONS)):
            name = f"encoder_{blk}/conv_{i}"
            s_next = site_scale(name)
            packed[name] = _pack_conv_site(model.encoder_blocks[blk][i], s, s_next)
            s = s_next

    rev_features = list(reversed(model.feature_sizes))
    for i, (feat, skip_s) in enumerate(zip(rev_features[1:], reversed(skip_scales))):
        block = model.decoder_blocks[i]
        s_blk = torch.broadcast_to(site_scale(f"decoder_{i}"), (feat,))
        if model.pixel_shuffle:
            # conv straight to 4F channels, (channel, parity) order: each
            # channel's block-output scale covers its four parities
            packed[f"decoder_{i}/conv"] = _pack_conv_site(block.conv, s,
                                                          s_blk.repeat_interleave(4))
        else:
            s_mid = site_scale(f"decoder_{i}/conv")
            packed[f"decoder_{i}/conv"] = _pack_conv_site(block.conv, s, s_mid)
            packed[f"decoder_{i}/upsample"] = _pack_transpose_up(block.upsample, s_mid, s_blk)
        skip_c = skip_s.shape[0] if skip_s.ndim else feat
        s = torch.cat([s_blk, torch.broadcast_to(skip_s, (skip_c,))])

    w_q, s_w = quantize_weight_folded(_hwio(model.classifier), s)
    packed["classifier"] = {"w_q": w_q, "mul": s_w,
                            "add": model.classifier.bias.detach().float()}
    return {name: {k: v.to(device).contiguous() for k, v in site.items()}
            for name, site in packed.items()}


# ---------------------------------------------------------------------------
# quantized forward


def _epilogue(site: Site, acc: torch.Tensor) -> torch.Tensor:
    """int32 accumulator -> relu(acc * mul + add), requantized to int8 when
    the site has an output scale (the classifier has none: float32 logits)."""
    y = acc.float() * site["mul"] + site["add"]
    if "s_out" not in site:
        return y
    return requantize(torch.relu(y), site["s_out"])


def _qconv(site: Site, x_q: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    acc = int8_conv(x_q, site["w_q"], padding=dilation, rhs_dilation=(dilation, dilation))
    return _epilogue(site, acc)


def _depth_to_space_int8(q4: torch.Tensor, feat: int) -> torch.Tensor:
    """(B, H, W, 4F) in (a, b, f) channel order -> (B, 2H, 2W, F)."""
    b, h, w, _ = q4.shape
    q4 = q4.reshape(b, h, w, 2, 2, feat).permute(0, 1, 3, 2, 4, 5)
    return q4.reshape(b, h * 2, w * 2, feat)


def _pixel_shuffle_nhwc(q4: torch.Tensor, feat: int) -> torch.Tensor:
    """`F.pixel_shuffle(., 2)` of an NHWC tensor in (f, a, b) channel order."""
    b, h, w, _ = q4.shape
    q4 = q4.reshape(b, h, w, feat, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return q4.reshape(b, h * 2, w * 2, feat)


def _max_pool_int8(q: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool ('VALID') of an NHWC int8 tensor. Exact on
    codes: every scale is positive, so max commutes with dequantization."""
    b, h, w, c = q.shape
    q = q[:, : h // 2 * 2, : w // 2 * 2]
    return q.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def quantized_forward(model: DocUFCN, quant: Dict[str, Site], x: torch.Tensor) -> torch.Tensor:
    """w8a8 eval forward mirroring `DocUFCN.forward`: normalized (B, C, H, W)
    float input -> (B, num_classes, H, W) float32 logits. Only the first
    conv's weights and BatchNorm are read from the float model."""
    first = model.encoder_blocks[0][0]
    h = F.conv2d(x.to(torch.bfloat16), first.conv.weight.to(torch.bfloat16), padding=1)
    mul, add = _bn_affine(first.bn)
    y0 = torch.relu((h.float().permute(0, 2, 3, 1) + first.conv.bias.float()) * mul + add)
    q = requantize(y0, quant["encoder_0/conv_0"]["s_out"])
    for i, dilation in list(enumerate(ENCODER_DILATIONS))[1:]:
        q = _qconv(quant[f"encoder_0/conv_{i}"], q, dilation)

    skips: List[torch.Tensor] = []
    for blk in range(1, len(model.feature_sizes)):
        skips.append(q)
        q = _max_pool_int8(q)
        for i, dilation in enumerate(ENCODER_DILATIONS):
            q = _qconv(quant[f"encoder_{blk}/conv_{i}"], q, dilation)

    rev_features = list(reversed(model.feature_sizes))
    for i, (feat, skip_q) in enumerate(zip(rev_features[1:], reversed(skips))):
        q = _qconv(quant[f"decoder_{i}/conv"], q)
        if model.pixel_shuffle:
            q = _pixel_shuffle_nhwc(q, feat)
        else:
            up = quant[f"decoder_{i}/upsample"]
            q = _depth_to_space_int8(_epilogue(up, int8_conv(q, up["w_q"])), feat)
        q = torch.cat([q, skip_q], dim=-1)

    cls = quant["classifier"]
    logits = _epilogue(cls, int8_conv(q, cls["w_q"], padding=1))
    return logits.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# serving adapter


class QuantizedDocUFCN(nn.Module):
    """Drop-in for the float DocUFCN in the serving stack: same call (NCHW
    in, NCHW float32 logits out), running the w8a8 forward. Eval only.
    Built by `quantize_for_serving`; holds the float model (its first conv)
    and the packed tree."""

    def __init__(self, model: DocUFCN, quant: Dict[str, Site]):
        super().__init__()
        self.model = model
        self.quant = quant
        self.num_classes = model.num_classes
        self.input_channels = model.input_channels

    def segmenter_config(self, *args, **kwargs):
        return self.model.segmenter_config(*args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert not self.training, "w8a8 PTQ is a serving-only path"
        return quantized_forward(self.model, self.quant, x)


def quantize_for_serving(model: DocUFCN, calibration_batches: Sequence[torch.Tensor]
                         ) -> QuantizedDocUFCN:
    """Calibrate on normalized (B, C, H, W) batches and return the quantized
    serving module (in eval mode)."""
    amax = calibrate(model, calibration_batches)
    quant = pack_quant(model, quant_scales_from_amax(amax))
    return QuantizedDocUFCN(model, quant).eval()
