"""A reference training step: the model's forward in f32 (or the control's
precision), the soft-target cross-entropy, the backward, and AdamW
(Loshchilov and Hutter, arXiv:1711.05101) as torch.optim.AdamW states it:
decoupled decay p <- p (1 - lr wd) on the parameters of more than one axis
only, then m, v with bias correction and p <- p - lr m_hat / (sqrt(v_hat) +
eps).

Stochastic depth draws its masks from the default generator of the
images' device, one Bernoulli draw an image for each residual branch of
each block whose probability is above 0, in the order the forward reaches
them; the caller sets that generator's state to the one the program's
step started from.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F


def drop_path_fn(rates: List[float]) -> Callable[[int, torch.Tensor], torch.Tensor]:
    def drop(block: int, branch: torch.Tensor) -> torch.Tensor:
        p = rates[block]
        if p == 0.0:
            return branch
        keep = 1.0 - p
        mask = torch.empty((branch.shape[0],) + (1,) * (branch.ndim - 1), device=branch.device).bernoulli_(keep)
        return torch.where(mask.bool(), branch / keep, torch.zeros_like(branch))

    return drop


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -(targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()


class AdamW:
    """torch.optim.AdamW's arithmetic on a dict of f32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1**self.t, 1 - b2**self.t
        for k, p in self.params.items():
            g = grads[k]
            if p.ndim > 1:
                p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2**0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def loss_and_grads(forward: Callable, params: Dict[str, torch.Tensor], shards, drop: Optional[Callable]):
    """The mean loss and the mean gradients over equal shards of a batch:
    ``shards`` yields ``(images, targets, before)``, ``before()`` setting the
    generators' states for that shard's forward (one rank's rows of a data
    parallel step; a single shard on one card)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = None
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    count = 0
    for images, targets, before in shards:
        before()
        loss = soft_cross_entropy(forward(leaves, images, drop), targets)
        g = torch.autograd.grad(loss, list(leaves.values()))
        for k, gk in zip(leaves, g):
            grads[k] += gk
        total = loss.detach() if total is None else total + loss.detach()
        count += 1
    return total / count, {k: g / count for k, g in grads.items()}
