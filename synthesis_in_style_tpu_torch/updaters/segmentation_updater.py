"""Segmentation training steps (counterpart of
synthesis_in_style_tpu/updaters/segmentation_updater.py): DocUFCN's weighted
cross-entropy step (`standard_train_step`), TransUNet's 0.5 * CE + 0.5 *
Dice step (`transunet_train_step`, reporting `combined`, `CE` and `Dice`)
and EMANet's cross-entropy step with the moving average of its µ bases
(`emanet_train_step`, reporting `softmax`).

* `compute_dtype` ("bfloat16") runs the forward and backward with every
  floating parameter cast to that type, differentiably, so the gradients
  reach the float32 masters, as the JAX package's `_apply_train` casts the
  whole parameter tree. BatchNorm's scale and bias are rounded to that type
  and handed over as float32 (see `cast_params`); its statistics and running
  buffers stay float32, and the logits return to float32 before the loss.
* The optimizer is anything with `params` and `step(grads)`, the gradients
  in the order of its `params`: DocUFCN's `GANOptimizer` with weight decay
  (clip the global norm to 1, add weight_decay * param, Adam with the
  schedule at the update count), TransUNet's `SGDOptimizer` and EMANet's,
  over three parameter groups.
* Dropout draws from torch's default generator, seeded from (seed,
  iteration) at each step, so a resumed run draws what a straight run did.
* In a launched multi-process run (parallel/distributed.py) each process
  steps on its shard: BatchNorm, the weighted cross-entropy's normalizer,
  Dice's sums and EMANet's µ mean are those of the global batch, the
  optimizers average the gradients, and the reported losses are averaged
  over the processes. (A shard draws its own dropout masks.)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from synthesis_in_style_tpu_torch.core.updater import Updater, iteration_seed
from synthesis_in_style_tpu_torch.losses.segmentation import cross_entropy_loss, dice_loss
from synthesis_in_style_tpu_torch.parallel import distributed


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


def _apply_gradients(optimizer, loss: torch.Tensor) -> None:
    grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
    optimizer.step(grads)


def standard_train_step(network: nn.Module, optimizer, batch: Dict[str, torch.Tensor],
                        class_weights: Optional[torch.Tensor] = None,
                        compute_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """One weighted cross-entropy step on {"images": NCHW, "segmented":
    (B, H, W) ints}; returns {"softmax": loss}."""
    network.train()
    logits = forward_train(network, batch["images"], compute_dtype)
    loss = cross_entropy_loss(logits, batch["segmented"], class_weights)
    _apply_gradients(optimizer, loss)
    return {"softmax": loss.detach()}


def transunet_train_step(network: nn.Module, optimizer, batch: Dict[str, torch.Tensor],
                         num_classes: int, compute_dtype: Optional[torch.dtype] = None
                         ) -> Dict[str, torch.Tensor]:
    """One 0.5 * CE + 0.5 * Dice step (the JAX package's
    `make_transunet_train_step`); returns {"combined", "CE", "Dice"}."""
    network.train()
    logits = forward_train(network, batch["images"], compute_dtype)
    labels = batch["segmented"]
    loss_ce = cross_entropy_loss(logits, labels)
    loss_dice = dice_loss(logits, labels, num_classes)
    loss = 0.5 * loss_ce + 0.5 * loss_dice
    _apply_gradients(optimizer, loss)
    return {"combined": loss.detach(), "CE": loss_ce.detach(), "Dice": loss_dice.detach()}


def emanet_train_step(network: nn.Module, optimizer, batch: Dict[str, torch.Tensor],
                      em_mom: float = 0.9, compute_dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, torch.Tensor]:
    """One EMANet step (the JAX package's `make_emanet_train_step`):
    cross-entropy only, then the bases buffer moves to em_mom * µ + (1 -
    em_mom) * (the batch mean of the forward's µ), in float32. Returns
    {"softmax": loss}."""
    network.train()
    images = batch["images"]
    if compute_dtype is None:
        logits, mu_batch = network(images)
    else:
        logits, mu_batch = torch.func.functional_call(
            network, cast_params(network, compute_dtype), (images.to(compute_dtype),))
    loss = cross_entropy_loss(logits.float(), batch["segmented"])
    _apply_gradients(optimizer, loss)
    with torch.no_grad():
        mu = network.emau.mu
        mu_mean = distributed.all_reduce_mean(mu_batch.float().mean(dim=0, keepdim=True))
        mu.copy_(mu * em_mom + mu_mean * (1 - em_mom))
    return {"softmax": loss.detach()}


class SGDOptimizer:
    """optax.chain(add_decayed_weights(weight_decay), sgd(schedule,
    momentum)) over a fixed parameter list, on torch.optim.SGD: the decay is
    added to the gradient before the momentum trace (dampening 0, no
    Nesterov), and each update steps at the schedule's rate for the count of
    updates made before it. The count travels in the state dict's parameter
    groups (`update_count`).

    `params` may instead be parameter groups, dicts of `params` with their
    own `weight_decay` and `lr_scale` (the schedule's rate times it): EMANet's
    optax.multi_transform of three such chains. A parameter without a
    gradient gets a zero one, so its decay and momentum still apply, as
    optax applies them to a zero gradient (torch.optim.SGD would skip it)."""

    def __init__(self, params, schedule: Callable[[int], float], momentum: float = 0.9,
                 weight_decay: float = 0.0):
        params = list(params)
        groups = params if params and isinstance(params[0], dict) else [{"params": params}]
        groups = [{"weight_decay": weight_decay, "lr_scale": 1.0, **group,
                   "params": list(group["params"])} for group in groups]
        self.params = [p for group in groups for p in group["params"]]
        self.schedule = schedule
        self.sgd = torch.optim.SGD(groups, lr=schedule(0), momentum=momentum)
        for group in self.sgd.param_groups:
            group["update_count"] = 0

    @property
    def count(self) -> int:
        """Updates made so far."""
        return int(self.sgd.param_groups[0]["update_count"])

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update from `grads` (in `params` order), averaged over the
        processes of a launched run first."""
        lr = self.schedule(self.count)
        for p, g in zip(self.params, distributed.average_gradients(grads)):
            p.grad = torch.zeros_like(p) if g is None else g
        for group in self.sgd.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)  # older snapshots have none
            group["update_count"] += 1
        self.sgd.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return self.sgd.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state)


class SegmentationUpdater(Updater):
    """Fetches a batch of NHWC images and labels, moves it to the device
    (as an NCHW view, channels last in memory), and takes one step: the
    weighted cross-entropy step, with `num_classes` the TransUNet step, or
    with `em_mom` the EMANet step; reports its losses under `loss/`."""

    def __init__(self, network: nn.Module, optimizer, iterators,
                 class_weights=None, compute_dtype: Optional[str] = None, seed: int = 0,
                 device="cuda", num_classes: Optional[int] = None,
                 em_mom: Optional[float] = None):
        super().__init__(iterators, seed=seed, device=device)
        self.network = network
        self.optimizer = optimizer
        self.class_weights = (None if class_weights is None else
                              torch.as_tensor(class_weights, dtype=torch.float32,
                                              device=self.device))
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.num_classes = num_classes
        self.em_mom = em_mom

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step on a batch already on the device; returns its losses."""
        if self.em_mom is not None:
            return emanet_train_step(self.network, self.optimizer, batch, self.em_mom,
                                     self.compute_dtype)
        if self.num_classes is not None:
            return transunet_train_step(self.network, self.optimizer, batch, self.num_classes,
                                        self.compute_dtype)
        return standard_train_step(self.network, self.optimizer, batch, self.class_weights,
                                   self.compute_dtype)

    def update_core(self):
        batch = self.next_batch("images")
        images = batch["images"].to(self.device, non_blocking=True).permute(0, 3, 1, 2)
        labels = batch["segmented"].to(self.device, non_blocking=True)
        torch.manual_seed(iteration_seed(self.seed, self.iteration))
        metrics = self.step({"images": images, "segmented": labels})
        self.report(distributed.reduce_metrics(metrics), prefix="loss")
