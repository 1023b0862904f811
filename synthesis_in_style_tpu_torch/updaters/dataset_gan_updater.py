"""DatasetGAN ensemble training (counterpart of
synthesis_in_style_tpu/updaters/dataset_gan_updater.py): every member of the
pixel ensemble takes a step on the same batch, all of them in one forward
and backward over the stacked parameters (the JAX package's `jax.vmap`).

The optimizer is the JAX builder's chain, per member: clip the member's
gradients to global norm 1.0 (optax's `t / norm * max_norm` above the norm),
add weight_decay * param (coupled), then Adam at a constant learning rate.
Adam is elementwise, so one torch Adam over the stacked parameters is M
member Adams; the snapshot splits its state into one per member
(`member_state_dicts`), the reference's `optimizer_<i>`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from synthesis_in_style_tpu_torch.core.updater import Updater
from synthesis_in_style_tpu_torch.models.pixel_classifier import PixelEnsembleClassifier


class EnsembleOptimizer:
    def __init__(self, ensemble: PixelEnsembleClassifier, lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), weight_decay: float = 0.0,
                 max_norm: float = 1.0, eps: float = 1e-8):
        self.params = list(ensemble.parameters())
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=betas, eps=eps,
                                     weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from the stacked gradients, in `params` order."""
        norm = torch.stack([g.square().flatten(1).sum(dim=1) for g in grads]).sum(dim=0).sqrt()
        for p, g in zip(self.params, grads):
            n = norm.view((-1,) + (1,) * (g.dim() - 1))
            p.grad = torch.where(n < self.max_norm, g, g / n * self.max_norm)
        self.adam.step()
        for p in self.params:
            p.grad = None

    def member_state_dicts(self) -> List[dict]:
        """Each member's torch Adam state dict (its slices of the moments)."""
        state = self.adam.state_dict()
        num_models = self.params[0].shape[0]
        return [{"state": {idx: {"step": s["step"].clone(), "exp_avg": s["exp_avg"][i].clone(),
                                 "exp_avg_sq": s["exp_avg_sq"][i].clone()}
                           for idx, s in state["state"].items()},
                 "param_groups": [dict(group) for group in state["param_groups"]]}
                for i in range(num_models)]

    def load_member_state_dicts(self, members: Sequence[dict]) -> None:
        first = members[0]
        state = {idx: {"step": s["step"],
                       **{key: torch.stack([m["state"][idx][key] for m in members])
                          for key in ("exp_avg", "exp_avg_sq")}}
                 for idx, s in first["state"].items()}
        self.adam.load_state_dict({"state": state, "param_groups": first["param_groups"]})


def ensemble_train_step(ensemble: PixelEnsembleClassifier, optimizer: EnsembleOptimizer,
                        batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every member's cross-entropy step on {"activations": (B, F), "label":
    (B,)}; returns the (M,) losses before the step."""
    ensemble.train()
    logits = ensemble(batch["activations"])  # (M, B, K)
    labels = batch["label"].long()[None, :, None].expand(logits.shape[0], -1, 1)
    losses = -F.log_softmax(logits.float(), dim=-1).gather(-1, labels)[..., 0].mean(dim=1)
    grads = torch.autograd.grad(losses.sum(), optimizer.params)
    optimizer.step(grads)
    return losses.detach()


class DatasetGANUpdater(Updater):
    """Steps the ensemble on the `feature_vectors` stream and, when its epoch
    passes a whole number, regenerates the dataset (`reset_dataset`, for a
    generation-backed one) before the step."""

    def __init__(self, ensemble: PixelEnsembleClassifier, optimizer: EnsembleOptimizer,
                 iterators, dataset=None, seed: int = 0, device="cuda"):
        super().__init__(iterators, seed=seed, device=device)
        self.ensemble = ensemble
        self.optimizer = optimizer
        self.dataset = dataset
        self._last_epoch = 0

    def update_core(self):
        it = self.iterators["feature_vectors"]
        epoch = getattr(it, "epoch", 0)
        if self.dataset is not None and int(epoch) > self._last_epoch:
            self._last_epoch = int(epoch)
            self.reset()
        losses = ensemble_train_step(self.ensemble, self.optimizer, next(it))
        self.report({f"CrossEntropyLoss_network_{i}": losses[i] for i in range(len(losses))},
                    prefix="loss")

    def reset(self):
        reset_fn = getattr(self.dataset, "reset_dataset", None)
        if reset_fn is not None:
            reset_fn()
