"""Segmentation training step (counterpart of the standard weighted
cross-entropy step of synthesis_in_style_tpu/updaters/segmentation_updater.py).

* `compute_dtype` ("bfloat16") runs the forward and backward with every
  floating parameter cast to that type, differentiably, so the gradients
  reach the float32 masters, as the JAX package's `_apply_train` casts the
  whole parameter tree. BatchNorm's scale and bias are rounded to that type
  and handed over as float32 (see `cast_params`); its statistics and running
  buffers stay float32, and the logits return to float32 before the loss.
* The optimizer is `GANOptimizer` with weight decay: clip the global norm
  to 1, add weight_decay * param, Adam with the schedule at the update
  count.
* Dropout draws from torch's default generator, seeded from (seed,
  iteration) at each step, so a resumed run draws what a straight run did.

TransUNet and EMANet steps are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from synthesis_in_style_tpu_torch.core.updater import Updater, iteration_seed
from synthesis_in_style_tpu_torch.losses.segmentation import cross_entropy_loss
from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import GANOptimizer


def cast_params(network: nn.Module, dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every floating parameter cast (differentiably) to
    `dtype`; empty without one. Convolution weights and biases become
    `dtype`. BatchNorm's weight and bias are rounded to `dtype` and cast
    back to float32: PyTorch's batch norm refuses a bfloat16 weight beside
    its float32 running statistics (on the CPU), and with the rounded
    float32 copy it computes what flax does with a bfloat16 scale and bias
    (promoted into its float32 normalization)."""
    if dtype is None:
        return {}
    out = {}
    for mod_name, module in network.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if not p.is_floating_point():
                continue
            cast = p.to(dtype)
            if isinstance(module, nn.modules.batchnorm._BatchNorm):
                cast = cast.to(p.dtype)
            out[f"{mod_name}.{name}" if mod_name else name] = cast
    return out


def forward_train(network: nn.Module, images: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Train-mode logits (float32) of NCHW images, in `compute_dtype`."""
    if compute_dtype is None:
        return network(images)
    logits = torch.func.functional_call(network, cast_params(network, compute_dtype),
                                        (images.to(compute_dtype),))
    return logits.float()


def standard_train_step(network: nn.Module, optimizer: GANOptimizer, batch: Dict[str, torch.Tensor],
                        class_weights: Optional[torch.Tensor] = None,
                        compute_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """One weighted cross-entropy step on {"images": NCHW, "segmented":
    (B, H, W) ints}; returns {"softmax": loss}."""
    network.train()
    logits = forward_train(network, batch["images"], compute_dtype)
    loss = cross_entropy_loss(logits, batch["segmented"], class_weights)
    params = list(network.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    optimizer.step(grads)
    return {"softmax": loss.detach()}


class SegmentationUpdater(Updater):
    """Fetches a batch of NHWC images and labels, moves it to the device
    (as an NCHW view, channels last in memory), and takes one step; reports
    `loss/softmax`."""

    def __init__(self, network: nn.Module, optimizer: GANOptimizer, iterators,
                 class_weights=None, compute_dtype: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        super().__init__(iterators, seed=seed, device=device)
        self.network = network
        self.optimizer = optimizer
        self.class_weights = (None if class_weights is None else
                              torch.as_tensor(class_weights, dtype=torch.float32,
                                              device=self.device))
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None

    def update_core(self):
        batch = self.next_batch("images")
        images = batch["images"].to(self.device, non_blocking=True).permute(0, 3, 1, 2)
        labels = batch["segmented"].to(self.device, non_blocking=True)
        torch.manual_seed(iteration_seed(self.seed, self.iteration))
        metrics = standard_train_step(self.network, self.optimizer,
                                      {"images": images, "segmented": labels},
                                      self.class_weights, self.compute_dtype)
        self.report(metrics, prefix="loss")
