"""LPIPS perceptual distance (counterpart of
synthesis_in_style_tpu/losses/lpips.py): scaling layer -> backbone features
at its taps -> unit-normalize over channels -> squared difference ->
learned per-channel "lin" weights -> spatial mean -> sum over the taps.

The lin calibration weights ship with the port (losses/lpips_weights/
v0.{0,1}/{alex,vgg,squeeze}.npz, byte copies of the JAX package's) and load
by default. The backbone (AlexNet, VGG16 or SqueezeNet 1.1) needs ImageNet
weights: pass a state dict (`backbone_state`) or set SIS_METRIC_WEIGHTS to a
directory of the JAX package's converted `<net>_features.npz` files.
Without them the distance runs on a seeded random backbone (its values are
NOT calibrated LPIPS) and warns, as the JAX package does.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from synthesis_in_style_tpu_torch.losses.feature_extractors import (
    ALEXNET_CHANNELS,
    SQUEEZENET_CHANNELS,
    VGG16_CHANNELS,
    AlexNetFeatures,
    SqueezeNetFeatures,
    VGG16Features,
    init_extractor,
)

# the reference's ScalingLayer
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
VGG16_LPIPS_TAPS = (1, 3, 6, 9, 12)

VENDORED_LIN_DIR = Path(__file__).parent / "lpips_weights"


def normalize_tensor(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalize an NCHW map over its channels."""
    return feat / (feat.square().sum(dim=1, keepdim=True).sqrt() + eps)


def load_vendored_lpips_lin(net: str = "alex", version: str = "0.1") -> List[np.ndarray]:
    """The shipped lin weights of `net` ("alex", "vgg", "squeeze")."""
    net = {"vgg16": "vgg"}.get(net, net)
    with np.load(VENDORED_LIN_DIR / f"v{version}" / f"{net}.npz") as data:
        return [data[f"lin{k}"] for k in range(len(data.files))]


def load_torch_lpips_lin(path) -> List[np.ndarray]:
    """The per-tap lin weights of a reference LPIPS .pth (keys
    `lin<k>.model.1.weight`, shape (1, C, 1, 1)) -> list of (C,) arrays."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    lins, k = [], 0
    while f"lin{k}.model.1.weight" in sd:
        lins.append(sd[f"lin{k}.model.1.weight"].reshape(-1).numpy())
        k += 1
    return lins


def _backbone(net: str):
    """(module, taps, tap channels, JAX params converter) of a backbone."""
    from synthesis_in_style_tpu_torch.utils import checkpoint as ck

    if net in ("vgg", "vgg16"):
        return (VGG16Features(), list(VGG16_LPIPS_TAPS),
                [VGG16_CHANNELS[t] for t in VGG16_LPIPS_TAPS], ck.vgg16_features_params_from_jax)
    if net == "alex":
        return (AlexNetFeatures(), list(range(5)), ALEXNET_CHANNELS,
                ck.alexnet_features_params_from_jax)
    if net == "squeeze":
        return (SqueezeNetFeatures(), list(range(7)), SQUEEZENET_CHANNELS,
                ck.squeezenet_features_params_from_jax)
    raise NotImplementedError(net)


def _backbone_state_from_env(net: str, from_jax) -> Optional[Dict[str, torch.Tensor]]:
    """The converted ImageNet backbone `$SIS_METRIC_WEIGHTS/<net>_features.npz`
    (the JAX package's params, '/'-joined keys), or None."""
    root = os.environ.get("SIS_METRIC_WEIGHTS")
    if not root:
        return None
    path = Path(root) / f"{ {'vgg16': 'vgg'}.get(net, net)}_features.npz"
    if not path.exists():
        return None
    from synthesis_in_style_tpu_torch.utils.checkpoint import unflatten_npz

    with np.load(path) as data:
        return from_jax(unflatten_npz(data))


class LPIPS(nn.Module):
    """LPIPS distance between NHWC images in [-1, 1] (or [0, 1] with
    normalize=True) -> (B,). Its parameters are frozen; gradients flow to
    the inputs."""

    def __init__(self, net: str = "alex", backbone_state: Optional[Dict[str, torch.Tensor]] = None,
                 lin_weights: Optional[Sequence[np.ndarray]] = None, lin_weights_path=None,
                 use_lin: bool = True, version: str = "0.1", seed: int = 0):
        super().__init__()
        self.backbone, self.taps, channels, from_jax = _backbone(net)
        if backbone_state is None:
            backbone_state = _backbone_state_from_env(net, from_jax)
        self.calibrated_backbone = backbone_state is not None
        if self.calibrated_backbone:
            self.backbone.load_state_dict(backbone_state, strict=False)
        else:
            warnings.warn(
                f"LPIPS({net!r}): no ImageNet backbone weights - distances use a RANDOM-INIT "
                "backbone and are NOT calibrated LPIPS. Convert torchvision weights once with "
                "the JAX package's scripts/fetch_metric_weights.py and set SIS_METRIC_WEIGHTS "
                "(or pass backbone_state).", stacklevel=2)
            init_extractor(self.backbone, seed)
        if lin_weights is None and lin_weights_path is not None:
            lin_weights = load_torch_lpips_lin(lin_weights_path)
        if lin_weights is None and use_lin:
            lin_weights = load_vendored_lpips_lin(net, version)
        if lin_weights is None:
            lin_weights = [np.ones(c, np.float32) for c in channels]
        for k, w in enumerate(lin_weights):
            self.register_buffer(f"lin{k}", torch.as_tensor(np.asarray(w, np.float32)))
        self.num_taps = len(lin_weights)
        self.register_buffer("shift", torch.as_tensor(SHIFT), persistent=False)
        self.register_buffer("scale", torch.as_tensor(SCALE), persistent=False)
        self.requires_grad_(False)
        self.eval()

    @property
    def lin_weights(self) -> List[torch.Tensor]:
        return [getattr(self, f"lin{k}") for k in range(self.num_taps)]

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = self.backbone((x - self.shift) / self.scale)
        return [feats[t] for t in self.taps]

    def distance(self, feats0: List[torch.Tensor], feats1: List[torch.Tensor],
                 lin_weights: Sequence[torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for f0, f1, lin in zip(feats0, feats1, lin_weights):
            diff = (normalize_tensor(f0) - normalize_tensor(f1)).square()
            total = total + torch.einsum("nchw,c->nhw", diff, lin).mean(dim=(1, 2))
        return total

    def forward(self, pred: torch.Tensor, target: torch.Tensor,
                normalize: bool = False) -> torch.Tensor:
        if normalize:
            pred, target = 2 * pred - 1, 2 * target - 1
        return self.distance(self.features(pred), self.features(target), self.lin_weights)
