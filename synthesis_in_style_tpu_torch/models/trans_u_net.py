"""TransUNet: a hybrid ResNetV2 + ViT encoder with a cup decoder
(counterpart of synthesis_in_style_tpu/models/trans_u_net.py), NCHW.

* `VIT_CONFIGS` and the `get_*_config` functions are the JAX package's
  config dicts (the reference's vit_seg_configs.py).
* The hybrid backbone (`ResNetV2`) uses weight-standardised convolutions
  (`StdConv2d`: over (in, kh, kw), biased variance, eps 1e-5), GroupNorm(32)
  with eps 1e-6, and zero-pads a skip feature that comes out one or two
  pixels short of `in_size / 4 / (i + 1)` (the reference's quirk).
* `Attention(impl="xla")` materialises the scores, softmax and dropout;
  `impl="flash"` calls `ops.attention.flash_attention` (the hand-written
  CUDA kernel on the card, its plain version on the CPU). The flash path
  keeps the JAX package's guards: no attention dropout, and a token count
  that is a multiple of 128.
* The decoder's BatchNorm moves its statistics as flax's
  `nn.BatchNorm(momentum=0.99)` does (torch momentum 0.01, biased variance).
* Submodules carry the reference torch model's state-dict keys
  (`transformer.embeddings.hybrid_model.root.conv`, `...body.block1.unit1`,
  `transformer.encoder.layer.{i}.attn.{query,key,value,out}`,
  `decoder.conv_more`, `decoder.blocks.{i}.conv{1,2}`,
  `segmentation_head.0`), so a reference `.pt` loads as it is.
* `load_npz_weights` maps the original ViT `.npz` (flax-era names) into the
  port's state dict, resizing the position-embedding grid with
  `scipy.ndimage.zoom` (order 1) as the JAX function does.

Input (B, 1 or 3, H, W) in [-1, 1]; output (B, num_classes, H', W') logits
(H' = H for the shipped configs).
"""

from __future__ import annotations

import copy
import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.models.base_segmenter import SegmenterConfig
from synthesis_in_style_tpu_torch.models.doc_ufcn import BatchNorm2d, _truncated_normal
from synthesis_in_style_tpu_torch.ops.attention import flash_attention
from synthesis_in_style_tpu_torch.ops.resize import resize_bilinear_align_corners

# ---------------------------------------------------------------------------
# configs (the JAX package's VIT_CONFIGS)
# ---------------------------------------------------------------------------


def get_b16_config() -> Dict[str, Any]:
    return {
        "patches": {"size": (16, 16)},
        "hidden_size": 768,
        "transformer": {
            "mlp_dim": 3072,
            "num_heads": 12,
            "num_layers": 12,
            "attention_dropout_rate": 0.0,
            "dropout_rate": 0.1,
        },
        "classifier": "seg",
        "decoder_channels": (256, 128, 64, 16),
        "n_classes": 2,
        "n_skip": 0,
        "activation": "softmax",
    }


def get_b32_config() -> Dict[str, Any]:
    config = get_b16_config()
    config["patches"] = {"size": (32, 32)}
    return config


def get_l16_config() -> Dict[str, Any]:
    config = get_b16_config()
    config["hidden_size"] = 1024
    config["transformer"] = {
        "mlp_dim": 4096,
        "num_heads": 16,
        "num_layers": 24,
        "attention_dropout_rate": 0.0,
        "dropout_rate": 0.1,
    }
    return config


def get_l32_config() -> Dict[str, Any]:
    config = get_l16_config()
    config["patches"] = {"size": (32, 32)}
    return config


def get_r50_b16_config() -> Dict[str, Any]:
    config = get_b16_config()
    config["patches"] = {"size": (16, 16), "grid": (16, 16)}
    config["resnet"] = {"num_layers": (3, 4, 9), "width_factor": 1}
    config["skip_channels"] = [512, 256, 64, 16]
    config["n_skip"] = 3
    return config


def get_r50_l16_config() -> Dict[str, Any]:
    config = get_l16_config()
    config["patches"] = {"size": (16, 16), "grid": (16, 16)}
    config["resnet"] = {"num_layers": (3, 4, 9), "width_factor": 1}
    config["skip_channels"] = [512, 256, 64, 16]
    config["n_skip"] = 3
    return config


def get_h14_config() -> Dict[str, Any]:
    """ViT-H/14 with the standard decoder defaults added (the reference's
    entry has none)."""
    config = get_b16_config()
    config["patches"] = {"size": (14, 14)}
    config["hidden_size"] = 1280
    config["transformer"] = {
        "mlp_dim": 5120,
        "num_heads": 16,
        "num_layers": 32,
        "attention_dropout_rate": 0.0,
        "dropout_rate": 0.1,
    }
    return config


def get_testing_config() -> Dict[str, Any]:
    config = get_b16_config()
    config["hidden_size"] = 16
    config["transformer"] = {
        "mlp_dim": 32,
        "num_heads": 2,
        "num_layers": 2,
        "attention_dropout_rate": 0.0,
        "dropout_rate": 0.1,
    }
    config["decoder_channels"] = (16, 8, 4, 2)
    return config


VIT_CONFIGS = {
    "ViT-B_16": get_b16_config,
    "ViT-B_32": get_b32_config,
    "ViT-L_16": get_l16_config,
    "ViT-L_32": get_l32_config,
    "ViT-H_14": get_h14_config,
    "R50-ViT-B_16": get_r50_b16_config,
    "R50-ViT-L_16": get_r50_l16_config,
    "testing": get_testing_config,
}


# ---------------------------------------------------------------------------
# hybrid ResNetV2 backbone
# ---------------------------------------------------------------------------


class StdConv2d(nn.Conv2d):
    """Weight-standardised convolution: each output channel's kernel is
    standardised over (in, kh, kw) at apply time."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (self.weight - mean) / torch.sqrt(var + 1e-5)
        return F.conv2d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)


def _gn(channels: int, groups: int = 32) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=1e-6)


class PreActBottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 standardised convolutions, each followed
    by GroupNorm (ReLU after the first two), plus the (projected) residual."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.conv1 = StdConv2d(cin, cmid, 1, bias=False)
        self.gn1 = _gn(cmid)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride=stride, padding=1, bias=False)
        self.gn2 = _gn(cmid)
        self.conv3 = StdConv2d(cmid, cout, 1, bias=False)
        self.gn3 = _gn(cout)
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride=stride, bias=False)
            self.gn_proj = _gn(cout, groups=cout)  # flax group_size=1
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(residual + y)


class ResNetV2(nn.Module):
    """Returns (features, skips in decoder order: 1/8, 1/4, 1/2 of the
    input)."""

    def __init__(self, block_units: Sequence[int], width_factor: int = 1):
        super().__init__()
        width = int(64 * width_factor)
        self.width = width
        self.root = nn.Sequential(OrderedDict([
            ("conv", StdConv2d(3, width, 7, stride=2, padding=3, bias=False)),
            ("gn", _gn(width)),
            ("relu", nn.ReLU()),
        ]))
        blocks, cin = [], width
        for i, n_units in enumerate(block_units):
            cmid, cout = width * 2 ** i, width * 4 * 2 ** i
            units = [(f"unit{u}", PreActBottleneck(cin if u == 1 else cout, cout, cmid,
                                                   stride=(2 if i > 0 and u == 1 else 1)))
                     for u in range(1, n_units + 1)]
            blocks.append((f"block{i + 1}", nn.Sequential(OrderedDict(units))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(blocks))
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        in_size = x.shape[2]
        x = self.root(x)
        features = [x]
        x = F.max_pool2d(x, 3, 2)
        n_blocks = len(self.body)
        for i, block in enumerate(self.body):
            x = block(x)
            if i < n_blocks - 1:
                right_size = int(in_size / 4 / (i + 1))
                feat = x
                if x.shape[2] != right_size:
                    pad_h, pad_w = right_size - x.shape[2], right_size - x.shape[3]
                    if not 0 < pad_h < 3:
                        raise ValueError(f"x {tuple(x.shape)} should be {right_size}")
                    feat = F.pad(x, (0, pad_w, 0, pad_h))
                features.append(feat)
        return x, features[::-1]

    def output_size(self, n: int) -> int:
        """Spatial size of the features for an n-pixel input."""
        n = (n + 6 - 7) // 2 + 1  # root conv
        n = (n - 3) // 2 + 1  # max pool
        for _ in range(len(self.body) - 1):  # the stride-2 blocks
            n = (n + 2 - 3) // 2 + 1
        return n


# ---------------------------------------------------------------------------
# transformer encoder
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """Multi-head self-attention on (B, N, hidden). `impl` "xla": scores,
    softmax, dropout and the product in plain PyTorch; "flash": the fused
    op (no N x N matrix in device memory on the card)."""

    def __init__(self, hidden: int, num_heads: int, dropout_rate: float = 0.0,
                 impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "flash"):
            raise ValueError(f"attention impl must be 'xla' or 'flash', got {impl!r}")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.impl = impl
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, hidden = x.shape
        head_dim = hidden // self.num_heads

        def split(t):  # (B, N, hidden) -> (B, heads, N, d)
            return t.view(b, n, self.num_heads, head_dim).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        if self.impl == "flash":
            if self.dropout_rate > 0.0:
                raise ValueError(
                    "attention_impl='flash' does not support "
                    "attention_dropout_rate > 0 (probability dropout happens "
                    "inside the fused kernel's softmax); use 'xla'."
                )
            if n % 128 != 0:
                raise ValueError(
                    f"attention_impl='flash' needs the token count to be a "
                    f"multiple of 128, got {n} (image size must be a "
                    f"multiple of 16*128**0.5 ≈ 192px for square grids); "
                    f"use 'xla'."
                )
            context = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                      sm_scale=1.0 / math.sqrt(head_dim))
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim)
            probs = F.dropout(torch.softmax(scores, dim=-1), self.dropout_rate, self.training)
            context = torch.matmul(probs, v)
        context = context.transpose(1, 2).reshape(b, n, hidden)
        return F.dropout(self.out(context), self.dropout_rate, self.training)


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.dropout(F.gelu(self.fc1(x)), self.dropout_rate, self.training)
        return F.dropout(self.fc2(x), self.dropout_rate, self.training)


class Block(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, attention_impl: str = "xla"):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.attn = Attention(hidden, num_heads, attention_dropout_rate, impl=attention_impl)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn = Mlp(hidden, mlp_dim, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Embeddings(nn.Module):
    """Hybrid backbone (when the config has a grid) or plain patches, the
    patch convolution and the position embeddings."""

    def __init__(self, config: Dict[str, Any], img_size: int):
        super().__init__()
        hidden = config["hidden_size"]
        grid = config["patches"].get("grid")
        if grid is not None:
            self.hybrid_model = ResNetV2(config["resnet"]["num_layers"],
                                         config["resnet"]["width_factor"])
            patch = (max(1, img_size // 16 // grid[0]), max(1, img_size // 16 // grid[1]))
            in_channels = self.hybrid_model.out_channels
            size = self.hybrid_model.output_size(img_size)
        else:
            self.hybrid_model = None
            patch = tuple(config["patches"]["size"])
            in_channels, size = 3, img_size
        self.patch_embeddings = nn.Conv2d(in_channels, hidden, patch, stride=patch)
        n_tokens = (size // patch[0]) * (size // patch[1])
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_tokens, hidden))
        self.dropout_rate = config["transformer"]["dropout_rate"]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        features = None
        if self.hybrid_model is not None:
            x, features = self.hybrid_model(x)
        x = self.patch_embeddings(x).flatten(2).transpose(1, 2)  # (B, N, hidden)
        x = x + self.position_embeddings
        return F.dropout(x, self.dropout_rate, self.training), features


class Encoder(nn.Module):
    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        hidden, tconf = config["hidden_size"], config["transformer"]
        self.layer = nn.ModuleList(
            Block(hidden, tconf["num_heads"], tconf["mlp_dim"], tconf["dropout_rate"],
                  tconf["attention_dropout_rate"],
                  attention_impl=config.get("attention_impl", "xla"))
            for _ in range(tconf["num_layers"]))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.layer:
            x = block(x)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    def __init__(self, config: Dict[str, Any], img_size: int):
        super().__init__()
        self.embeddings = Embeddings(config, img_size)
        self.encoder = Encoder(config)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        x, features = self.embeddings(x)
        return self.encoder(x), features


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


class Conv2dReLU(nn.Sequential):
    """conv (no bias) -> BatchNorm (flax's momentum and variance) -> ReLU,
    keyed `0` and `1` as the reference's Sequential."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__(
            nn.Conv2d(in_channels, features, kernel_size, padding=padding, bias=False),
            BatchNorm2d(features, momentum=0.01),
            nn.ReLU(),
        )


class DecoderBlock(nn.Module):
    """2x bilinear upsample (align_corners), skip concat, two Conv2dReLU."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.conv1 = Conv2dReLU(in_channels + skip_channels, features)
        self.conv2 = Conv2dReLU(features, features)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = resize_bilinear_align_corners(x, x.shape[2] * 2, x.shape[3] * 2)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class DecoderCup(nn.Module):
    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        head_channels = 512
        self.conv_more = Conv2dReLU(config["hidden_size"], head_channels)
        decoder_channels = list(config["decoder_channels"])
        self.n_skip = config.get("n_skip", 0)
        skip_channels = list(config.get("skip_channels", [0, 0, 0, 0]))
        for i in range(4 - self.n_skip):
            skip_channels[3 - i] = 0
        self.skip_channels = skip_channels
        in_channels = [head_channels] + decoder_channels[:-1]
        self.blocks = nn.ModuleList(
            DecoderBlock(cin, skip_channels[i], cout)
            for i, (cin, cout) in enumerate(zip(in_channels, decoder_channels)))

    def forward(self, x: torch.Tensor, features: Optional[List[torch.Tensor]]) -> torch.Tensor:
        b, n, hidden = x.shape
        h = w = int(math.sqrt(n))
        x = self.conv_more(x.transpose(1, 2).reshape(b, hidden, h, w))
        for i, block in enumerate(self.blocks):
            skip = None
            if features is not None and i < self.n_skip and self.skip_channels[i] != 0:
                skip = features[i]
            x = block(x, skip)
        return x


class VisionTransformer(nn.Module):
    """TransUNet on NCHW images (1 or 3 channels) in [-1, 1]; returns
    (B, num_classes, H, W) logits. `config` is one of VIT_CONFIGS (a dict,
    with "attention_impl" "xla" or "flash")."""

    def __init__(self, config: Dict[str, Any], img_size: int = 224, num_classes: int = 2):
        super().__init__()
        self.config = copy.deepcopy(config)
        self.img_size = img_size
        self.num_classes = num_classes
        self.transformer = Transformer(self.config, img_size)
        self.decoder = DecoderCup(self.config)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(self.config["decoder_channels"][-1], num_classes, 3, padding=1))

    def segmenter_config(self, background_class_id: int = 0, min_confidence: float = 0.0,
                         min_contour_area: int = 0) -> SegmenterConfig:
        return SegmenterConfig(num_classes=self.num_classes,
                               background_class_id=background_class_id,
                               min_confidence=min_confidence,
                               min_contour_area=min_contour_area)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x, features = self.transformer(x)
        return self.segmentation_head(self.decoder(x, features))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "VisionTransformer":
        """flax's initializers: lecun_normal convolution and dense kernels
        with zero biases, except the MLP's (xavier_uniform kernels, normal
        biases of std 1e-6); zero position embeddings; norm scales 1 and
        biases 0; BatchNorm statistics 0 / 1."""
        mlp_layers = {id(m) for blk in self.transformer.encoder.layer
                      for m in (blk.ffn.fc1, blk.ffn.fc2)}
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                w = module.weight
                fan_in = w[0].numel()
                if id(module) in mlp_layers:
                    limit = math.sqrt(6.0 / (fan_in + w.shape[0]))
                    w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * limit)
                    module.bias.copy_(torch.randn(module.bias.shape, generator=generator) * 1e-6)
                    continue
                # jax truncated_normal(-2, 2) has std 0.87962566 before scaling
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w.copy_(_truncated_normal(w.shape, generator) * std)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)):
                module.reset_parameters()
                if isinstance(module, nn.BatchNorm2d):
                    module.reset_running_stats()
        self.transformer.embeddings.position_embeddings.zero_()
        return self


# ---------------------------------------------------------------------------
# original ViT .npz weights
# ---------------------------------------------------------------------------


def _hwio(kernel: np.ndarray) -> np.ndarray:
    return np.asarray(kernel).transpose(3, 2, 0, 1)  # (kh, kw, in, out) -> (out, in, kh, kw)


def resize_position_embeddings(posemb: np.ndarray, ntok_new: int) -> np.ndarray:
    """The npz's (1, n, hidden) position embeddings for `ntok_new` tokens:
    as they are, without the class token, or their grid resized with
    scipy.ndimage.zoom (order 1)."""
    if posemb.shape[1] == ntok_new:
        return posemb
    if posemb.shape[1] - 1 == ntok_new:
        return posemb[:, 1:]
    from scipy import ndimage

    posemb_grid = posemb[0, 1:] if posemb.shape[1] % 2 else posemb[0]
    gs_old = int(np.sqrt(len(posemb_grid)))
    gs_new = int(np.sqrt(ntok_new))
    posemb_grid = posemb_grid.reshape(gs_old, gs_old, -1)
    zoom = (gs_new / gs_old, gs_new / gs_old, 1)
    posemb_grid = ndimage.zoom(posemb_grid, zoom, order=1)
    return posemb_grid.reshape(1, gs_new * gs_new, -1)


def load_npz_weights(state_dict: Dict[str, torch.Tensor], weights: Dict[str, np.ndarray],
                     config: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Merge original ViT `.npz` weights (flax-era names) into a copy of the
    port's TransUNet state dict; returns the new state dict. The decoder
    and the head keep their values."""
    hidden = config["hidden_size"]
    new: Dict[str, np.ndarray] = {}
    emb = "transformer.embeddings"
    new[f"{emb}.patch_embeddings.weight"] = _hwio(weights["embedding/kernel"])
    new[f"{emb}.patch_embeddings.bias"] = weights["embedding/bias"]
    new["transformer.encoder.encoder_norm.weight"] = weights["Transformer/encoder_norm/scale"]
    new["transformer.encoder.encoder_norm.bias"] = weights["Transformer/encoder_norm/bias"]
    new[f"{emb}.position_embeddings"] = resize_position_embeddings(
        np.asarray(weights["Transformer/posembed_input/pos_embedding"]),
        state_dict[f"{emb}.position_embeddings"].shape[1])

    for i in range(config["transformer"]["num_layers"]):
        root = f"Transformer/encoderblock_{i}"
        attn = f"{root}/MultiHeadDotProductAttention_1"
        t = f"transformer.encoder.layer.{i}"
        for name in ("query", "key", "value", "out"):
            new[f"{t}.attn.{name}.weight"] = weights[f"{attn}/{name}/kernel"].reshape(
                hidden, hidden).T
            new[f"{t}.attn.{name}.bias"] = weights[f"{attn}/{name}/bias"].reshape(-1)
        for port, theirs in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            new[f"{t}.ffn.{port}.weight"] = weights[f"{root}/MlpBlock_3/{theirs}/kernel"].T
            new[f"{t}.ffn.{port}.bias"] = weights[f"{root}/MlpBlock_3/{theirs}/bias"]
        for port, theirs in (("attention_norm", "LayerNorm_0"), ("ffn_norm", "LayerNorm_2")):
            new[f"{t}.{port}.weight"] = weights[f"{root}/{theirs}/scale"]
            new[f"{t}.{port}.bias"] = weights[f"{root}/{theirs}/bias"]

    hybrid = f"{emb}.hybrid_model"
    if f"{hybrid}.root.conv.weight" in state_dict:
        new[f"{hybrid}.root.conv.weight"] = _hwio(weights["conv_root/kernel"])
        new[f"{hybrid}.root.gn.weight"] = weights["gn_root/scale"].reshape(-1)
        new[f"{hybrid}.root.gn.bias"] = weights["gn_root/bias"].reshape(-1)
        units = sorted({tuple(k.split(".")[4:6]) for k in state_dict
                        if k.startswith(f"{hybrid}.body.")})
        for block, unit in units:
            t, root = f"{hybrid}.body.{block}.{unit}", f"{block}/{unit}"
            for j in (1, 2, 3):
                new[f"{t}.conv{j}.weight"] = _hwio(weights[f"{root}/conv{j}/kernel"])
                new[f"{t}.gn{j}.weight"] = weights[f"{root}/gn{j}/scale"].reshape(-1)
                new[f"{t}.gn{j}.bias"] = weights[f"{root}/gn{j}/bias"].reshape(-1)
            if f"{t}.downsample.weight" in state_dict:
                new[f"{t}.downsample.weight"] = _hwio(weights[f"{root}/conv_proj/kernel"])
                new[f"{t}.gn_proj.weight"] = weights[f"{root}/gn_proj/scale"].reshape(-1)
                new[f"{t}.gn_proj.bias"] = weights[f"{root}/gn_proj/bias"].reshape(-1)

    out = dict(state_dict)
    for key, value in new.items():
        if key not in out:
            raise KeyError(f"npz weight for {key!r}, which the network does not have")
        value = torch.from_numpy(np.array(value, dtype=np.float32))
        if value.shape != out[key].shape:
            raise ValueError(f"{key}: npz shape {tuple(value.shape)}, network "
                             f"{tuple(out[key].shape)}")
        out[key] = value.to(out[key].device)
    return out
