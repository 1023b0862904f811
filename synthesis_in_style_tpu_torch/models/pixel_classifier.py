"""DatasetGAN pixel classifiers (counterpart of
synthesis_in_style_tpu/models/pixel_classifier.py): per-pixel MLPs over the
generator's upsampled, concatenated activations.

* `PixelClassifier`: dim -> 128 -> 32 -> K for K < 32, else dim -> 256 ->
  128 -> K, ReLU then BatchNorm after each hidden linear, as the reference's
  `nn.Sequential` (`layers.0` Linear, `layers.2` BatchNorm1d, `layers.3`,
  `layers.5`, `layers.6`), so a reference member's state dict loads as it is.
* `PixelEnsembleClassifier`: M members as stacked parameters (a leading
  member axis), so one product runs every member: the first layer as one
  matrix product of the shared input with the members' weights side by side,
  the later ones as one `torch.baddbmm` (the JAX package's `jax.vmap`).
  `member_state_dict(i)` / `stack_member_state_dicts` convert to and from
  the reference layout.
* BatchNorm follows flax's `nn.BatchNorm()`: momentum 0.99 (torch's 0.01),
  eps 1e-5, batch variance E[x^2] - E[x]^2, and the running variance moves
  towards the biased batch variance.
* `predict_classes` is a majority vote: one-hot counts of the members'
  argmax, then argmax, so a tie goes to the smallest class id.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synthesis_in_style_tpu_torch.models.doc_ufcn import BiasedRunningVariance

BN_MOMENTUM = 0.01  # flax's momentum 0.99
BN_EPS = 1e-5
INIT_STD = 0.02
# the ensemble's layers -> the reference Sequential's indices
REFERENCE_LAYERS = (("fc1", 0), ("bn1", 2), ("fc2", 3), ("bn2", 5), ("fc3", 6))


def hidden_sizes(num_classes: int) -> Tuple[int, int]:
    return (128, 32) if num_classes < 32 else (256, 128)


class BatchNorm1d(BiasedRunningVariance, nn.BatchNorm1d):
    """`nn.BatchNorm1d` with flax's defaults and running-variance update."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)


class PixelClassifier(nn.Module):
    """One member in the reference layout (`layers`, an nn.Sequential):
    (B, dim) features -> (B, K) logits."""

    def __init__(self, num_classes: int, dim: int):
        super().__init__()
        h1, h2 = hidden_sizes(num_classes)
        self.layers = nn.Sequential(
            nn.Linear(dim, h1), nn.ReLU(), BatchNorm1d(h1), nn.Linear(h1, h2), nn.ReLU(),
            BatchNorm1d(h2), nn.Linear(h2, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class StackedLinear(nn.Module):
    """M linear layers: weight (M, out, in), bias (M, out)."""

    def __init__(self, num_models: int, fan_in: int, fan_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_models, fan_out, fan_in))
        self.bias = nn.Parameter(torch.zeros(num_models, fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, in) shared by every member, or (M, B, in) -> (M, B, out)."""
        m, fan_out, fan_in = self.weight.shape
        if x.dim() == 2:  # one product against every member's weights
            out = torch.addmm(self.bias.reshape(-1), x, self.weight.reshape(-1, fan_in).t())
            return out.view(x.shape[0], m, fan_out).transpose(0, 1)
        return torch.baddbmm(self.bias[:, None, :], x, self.weight.transpose(1, 2))


class StackedBatchNorm(nn.Module):
    """M flax-style BatchNorms over the feature axis of (M, B, C)."""

    def __init__(self, num_models: int, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_models, num_features))
        self.bias = nn.Parameter(torch.zeros(num_models, num_features))
        self.register_buffer("running_mean", torch.zeros(num_models, num_features))
        self.register_buffer("running_var", torch.ones(num_models, num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=1)
            var = ((x * x).mean(dim=1) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
                self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean[:, None, :]) * mul[:, None, :] + self.bias[:, None, :]


class PixelEnsembleClassifier(nn.Module):
    """M PixelClassifiers with stacked parameters. Uninitialised until
    `init_weights` or a loaded state."""

    def __init__(self, num_classes: int, dim: int, num_models: int):
        super().__init__()
        self.num_classes = num_classes
        self.dim = dim
        self.num_models = num_models
        h1, h2 = hidden_sizes(num_classes)
        self.fc1 = StackedLinear(num_models, dim, h1)
        self.bn1 = StackedBatchNorm(num_models, h1)
        self.fc2 = StackedLinear(num_models, h1, h2)
        self.bn2 = StackedBatchNorm(num_models, h2)
        self.fc3 = StackedLinear(num_models, h2, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """normal(0, 0.02) linear weights from `generator`, zero biases,
        BatchNorm scale 1 and bias 0, running statistics 0 and 1."""
        for fc in (self.fc1, self.fc2, self.fc3):
            fc.weight.copy_(torch.randn(fc.weight.shape, generator=generator) * INIT_STD)
            fc.bias.zero_()
        for bn in (self.bn1, self.bn2):
            bn.weight.fill_(1.0)
            bn.bias.zero_()
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, dim) -> (M, B, K) logits; in train mode BatchNorm uses and
        tracks the batch statistics."""
        x = self.bn1(F.relu(self.fc1(x)))
        x = self.bn2(F.relu(self.fc2(x)))
        return self.fc3(x)

    @torch.no_grad()
    def predict_classes(self, x: torch.Tensor) -> torch.Tensor:
        """Majority vote of the members in eval mode: (B, dim) -> (B,)
        int64 class ids, ties to the smallest id."""
        was_training = self.training
        self.eval()
        try:
            votes = self(x).argmax(dim=-1)  # (M, B)
        finally:
            self.train(was_training)
        classes = torch.arange(self.num_classes, device=votes.device)
        counts = (votes[..., None] == classes).sum(dim=0)  # (B, K); no host sync
        return counts.argmax(dim=-1)

    # ---------------- the reference layout ----------------

    def member_state_dict(self, i: int) -> Dict[str, torch.Tensor]:
        """Member i as a `PixelClassifier` state dict (reference layout;
        `num_batches_tracked` 0, as flax keeps no such count)."""
        out = {}
        for name, index in REFERENCE_LAYERS:
            for key, value in getattr(self, name).state_dict().items():
                out[f"layers.{index}.{key}"] = value[i].detach().clone()
            if name.startswith("bn"):
                out[f"layers.{index}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        return out


def stack_member_state_dicts(members: Sequence[Dict[str, torch.Tensor]]
                             ) -> Dict[str, torch.Tensor]:
    """Reference-layout member state dicts -> the ensemble's stacked state
    dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, index in REFERENCE_LAYERS:
        keys = ("weight", "bias", "running_mean", "running_var") if name.startswith("bn") \
            else ("weight", "bias")
        for key in keys:
            out[f"{name}.{key}"] = torch.stack(
                [torch.as_tensor(m[f"layers.{index}.{key}"]).float() for m in members])
    return out


def ensemble_from_state(state: Dict[str, torch.Tensor], num_classes: int
                        ) -> PixelEnsembleClassifier:
    """An ensemble shaped by a stacked state dict, loaded with it."""
    num_models, _, dim = state["fc1.weight"].shape
    ensemble = PixelEnsembleClassifier(num_classes, int(dim), int(num_models))
    ensemble.load_state_dict(state, strict=True)
    return ensemble

