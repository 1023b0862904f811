"""Non-saturating logistic GAN losses and the R1 penalty (counterpart of
synthesis_in_style_tpu/losses/gan.py)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def d_logistic_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    """softplus(-D(x)) + softplus(D(G(z)))."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """softplus(-D(G(z)))."""
    return F.softplus(-fake_pred).mean()


def r1_penalty(
    disc: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    r1_weight: float,
    interval: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(penalty, r1): r1 = E[||grad_x D(x)||^2] over the batch, penalty =
    r1_weight / 2 * r1 * interval (the lazy-regularization weight folding).
    The penalty keeps its graph to D's parameters (double backward)."""
    real = real.detach().requires_grad_(True)
    (grad_x,) = torch.autograd.grad(disc(real).sum(), real, create_graph=True)
    r1 = grad_x.square().sum(dim=(1, 2, 3)).mean()
    return r1_weight / 2.0 * r1 * interval, r1
