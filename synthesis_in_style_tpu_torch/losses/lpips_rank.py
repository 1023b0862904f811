"""Training LPIPS's calibration on 2AFC judgements (counterpart of
synthesis_in_style_tpu/losses/lpips_rank.py): the `Dist2LogitLayer` rank
head, the BCE ranking loss, accuracy, and a trainer whose Adam step trains
the lin weights of an `LPIPS` (backbone frozen) together with the rank
head, clamping the lin weights at 0 after every step."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Dist2LogitLayer(nn.Module):
    """(d0, d1) distances -> probability that p1 is closer: three linear
    layers over [d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)] (the
    reference's 1x1 convs over per-pair scalars), LeakyReLU 0.2 between."""

    def __init__(self, chn_mid: int = 32, use_sigmoid: bool = True):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(5, chn_mid), nn.Linear(chn_mid, chn_mid),
                                    nn.Linear(chn_mid, 1)])
        self.use_sigmoid = use_sigmoid

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Dist2LogitLayer":
        """flax Dense's default init drawn from `generator`: kernels
        truncated normal (+-2 std) with variance 1 / fan_in, biases 0."""
        for layer in self.dense:
            w = torch.empty(layer.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            # a unit normal truncated at +-2 has std 0.87962566
            layer.weight.copy_(w / (0.87962566103423978 * layer.in_features**0.5))
            layer.bias.zero_()
        return self

    def forward(self, d0: torch.Tensor, d1: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
        d0, d1 = d0.reshape(-1, 1), d1.reshape(-1, 1)
        x = torch.cat([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)], dim=1)
        x = F.leaky_relu(self.dense[0](x), 0.2)
        x = F.leaky_relu(self.dense[1](x), 0.2)
        x = self.dense[2](x)
        if self.use_sigmoid:
            x = torch.sigmoid(x)
        return x.reshape(-1)


def dist2logit_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX Dist2LogitLayer params (`Dense_<i>`: kernel (in, out), bias)
    -> the port's state dict."""
    params = params.get("params", params)
    sd = {}
    for i in range(3):
        p = params[f"Dense_{i}"]
        sd[f"dense.{i}.weight"] = torch.from_numpy(np.array(p["kernel"], np.float32).T.copy())
        sd[f"dense.{i}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return sd


def bce_ranking_loss(prob: torch.Tensor, judge: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """BCE between the rank head's probability and the judgement mapped
    from [-1, 1] to [0, 1]."""
    per = (judge + 1.0) / 2.0
    prob = prob.clamp(eps, 1.0 - eps)
    return -(per * prob.log() + (1.0 - per) * (1.0 - prob).log()).mean()


def compute_accuracy(d0: torch.Tensor, d1: torch.Tensor, judge01: torch.Tensor) -> torch.Tensor:
    """Share of pairs whose ranking agrees with the judgement in [0, 1]."""
    d1_lt_d0 = (d1 < d0).float()
    return (d1_lt_d0 * judge01 + (1.0 - d1_lt_d0) * (1.0 - judge01)).mean()


def twoafc_score(d0: np.ndarray, d1: np.ndarray, judge01: np.ndarray) -> float:
    """The LPIPS paper's 2AFC score (compute_accuracy on the host)."""
    d1_lt_d0 = (d1 < d0).astype(np.float64)
    return float(np.mean(d1_lt_d0 * judge01 + (1 - d1_lt_d0) * (1 - judge01)))


class LPIPSRankTrainer:
    """Adam (optax.adam: lr, b1 = beta1, b2 = 0.999, eps 1e-8) over the lin
    weights of `lpips` (a copy; the backbone stays frozen) and a
    Dist2LogitLayer, the lin weights clamped >= 0 after each step."""

    def __init__(self, lpips, lr: float = 1e-4, beta1: float = 0.5, seed: int = 0):
        self.lpips = lpips
        device = lpips.lin0.device
        self.rank_net = Dist2LogitLayer().init_weights(
            torch.Generator().manual_seed(seed)).to(device)
        self.lin: List[torch.Tensor] = [w.detach().clone().requires_grad_(True)
                                        for w in lpips.lin_weights]
        self.params = self.lin + list(self.rank_net.parameters())
        self.optimizer = torch.optim.Adam(self.params, lr=lr, betas=(beta1, 0.999), eps=1e-8)

    def _distance(self, lin: Sequence[torch.Tensor], x0: torch.Tensor, x1: torch.Tensor
                  ) -> torch.Tensor:
        return self.lpips.distance(self.lpips.features(x0), self.lpips.features(x1), lin)

    def train_step(self, ref, p0, p1, judge01) -> Dict[str, float]:
        """One 2AFC batch: NHWC images in [-1, 1]; judge01 (B,) in [0, 1]
        (the share of people preferring p1)."""
        judge01 = torch.as_tensor(judge01, dtype=torch.float32, device=self.lin[0].device)
        d0 = self._distance(self.lin, ref, p0)
        d1 = self._distance(self.lin, ref, p1)
        loss = bce_ranking_loss(self.rank_net(d0, d1), judge01 * 2.0 - 1.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            for w in self.lin:
                w.clamp_(min=0.0)
        acc = compute_accuracy(d0.detach(), d1.detach(), judge01)
        return {"loss_total": float(loss), "acc_r": float(acc)}

    def apply_to_lpips(self) -> None:
        """Write the trained lin weights into the LPIPS module."""
        for k, w in enumerate(self.lin):
            getattr(self.lpips, f"lin{k}").copy_(w.detach())

    @torch.no_grad()
    def evaluate(self, ref, p0, p1, judge01) -> Dict[str, float]:
        d0 = self._distance(self.lin, ref, p0)
        d1 = self._distance(self.lin, ref, p1)
        judge = torch.as_tensor(judge01, dtype=torch.float32, device=d0.device)
        return {"acc_r": float(compute_accuracy(d0, d1, judge)),
                "twoafc": twoafc_score(d0.cpu().numpy(), d1.cpu().numpy(),
                                       judge.cpu().numpy())}
