"""EMANet train builder (counterpart of
synthesis_in_style_tpu/training_builder/ema_net_builder.py): the network
from the config's `num_classes`, `n_layers` and `stride`, SGD with momentum
`lr_mom` at the base builder's learning-rate schedule over three parameter
groups, and the cross-entropy step with the µ moving average (`em_mom`).
The JAX package's `s2d_stem` key (an exact TPU re-lowering of the stem) is
ignored: the plain stem is computed.

The groups follow the JAX package's optax.multi_transform, by module kind
(PyTorch names a BatchNorm scale `weight` too):
* convolution weights: the schedule's rate, with `weight_decay`;
* BatchNorm weights: the rate, no decay;
* every bias, of a convolution or a BatchNorm: twice the rate, no decay.
`emau.conv1` gets no gradient (the EM attention carries none), and optax
still decays its weight every step; the port does the same (the original
PyTorch trainer did not decay a parameter without a gradient).

Validation and page inference use the network's stored µ (`emau.mu`),
which the snapshot carries.
"""

from __future__ import annotations

from typing import Dict, List

from torch import nn

from synthesis_in_style_tpu_torch.models.ema_net import EMANet
from synthesis_in_style_tpu_torch.training_builder.base import BaseTrainBuilder
from synthesis_in_style_tpu_torch.updaters.segmentation_updater import SGDOptimizer


def emanet_param_groups(network: nn.Module, weight_decay: float) -> List[Dict]:
    """[conv weights (lr, decay), BN weights (lr), biases (2 lr)]."""
    conv, norm, bias = [], [], []
    for module in network.modules():
        if isinstance(module, nn.Conv2d):
            conv.append(module.weight)
        elif isinstance(module, nn.BatchNorm2d):
            norm.append(module.weight)
        if isinstance(module, (nn.Conv2d, nn.BatchNorm2d)) and module.bias is not None:
            bias.append(module.bias)
    return [{"params": conv, "weight_decay": weight_decay, "lr_scale": 1.0},
            {"params": norm, "weight_decay": 0.0, "lr_scale": 1.0},
            {"params": bias, "weight_decay": 0.0, "lr_scale": 2.0}]


class EMANetTrainBuilder(BaseTrainBuilder):
    def _build_network(self):
        return EMANet(num_classes=self.config["num_classes"],
                      n_layers=int(self.config.get("n_layers", 50)),
                      stride=int(self.config.get("stride", 8)))

    def _build_optimizer(self) -> SGDOptimizer:
        config = self.config
        groups = emanet_param_groups(self.network, float(config.get("weight_decay", 0.0)))
        return SGDOptimizer(groups, self.lr_schedule(),
                            momentum=float(config.get("lr_mom", 0.9)))

    def _updater_kwargs(self) -> dict:
        return {"em_mom": float(self.config.get("em_mom", 0.9))}
