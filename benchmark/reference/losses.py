"""The ESS losses and the optimizer, in plain PyTorch float32.

- Task loss: cross entropy (mean over labelled pixels) plus the dice loss
  (per class ``1 - (2 sum(p t) + 1) / (sum(p^2) + sum(t^2) + 1)`` over the
  batch, averaged over classes), both from one log-softmax.
- Cycle losses of ESS UDA: the symmetric Jensen-Shannon form ``0.5 KL(q||p)
  + 0.5 KL(p||q)`` of two class softmaxes (each clamped at 1e-10, the mean
  over every element) and the mean absolute error.
- RAdam as optax defines it (``b1``, ``b2``, ``eps`` 1e-8, the rectified
  update from ``rho_t >= 5``), with ESS's ``b1 = 0``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def task_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
              ignore: int = 255) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=1)
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    picked = logp.gather(1, safe[:, None])[:, 0]
    ce = torch.where(valid, -picked, torch.zeros_like(picked)).sum() \
        / valid.sum().clamp(min=1)
    vmask = valid[:, None].float()
    probs = logp.exp() * vmask
    onehot = torch.nn.functional.one_hot(safe, num_classes).permute(
        0, 3, 1, 2).float() * vmask
    axes = (0, 2, 3)
    num = 2 * (probs * onehot).sum(axes) + 1.0
    den = (probs * probs).sum(axes) + onehot.sum(axes) + 1.0
    return ce + (1 - num / den).mean()


def symmetric_js(p_logits: torch.Tensor, q_logits: torch.Tensor
                 ) -> torch.Tensor:
    p = torch.softmax(p_logits.float(), dim=1).clamp(min=1e-10)
    q = torch.softmax(q_logits.float(), dim=1).clamp(min=1e-10)
    lp, lq = p.log(), q.log()
    return 0.5 * (q * (lq - lp)).mean() + 0.5 * (p * (lp - lq)).mean()


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def confusion(pred: torch.Tensor, labels: torch.Tensor, num_classes: int,
              ignore: int = 255) -> torch.Tensor:
    """(label, prediction) pair counts, (C, C) float64."""
    valid = labels != ignore
    idx = labels[valid].long() * num_classes + pred[valid].long()
    return torch.bincount(idx, minlength=num_classes ** 2).view(
        num_classes, num_classes).double()


class RAdam:
    """optax's ``radam(lr, b1, b2, eps=1e-8, threshold=5)`` over a list of
    float32 tensors updated in place."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 b1: float = 0.0, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = (
            params, lr, b1, b2, eps)
        self.mu = [torch.zeros_like(q) for q in params]
        self.nu = [torch.zeros_like(q) for q in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        t = self.count + 1
        f32 = np.float32
        b2t = f32(self.b2) ** f32(t)
        rho_inf = 2.0 / (1.0 - self.b2) - 1.0
        rho = f32(rho_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
        bc1 = float(f32(1) - f32(self.b1) ** f32(t))
        bc2 = float(f32(1) - b2t)
        r = None
        if rho >= 5.0:
            r = float(np.sqrt((rho - 4) * (rho - 2) * f32(rho_inf)
                              / (f32((rho_inf - 4) * (rho_inf - 2)) * rho)))
        for i, (q, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * g * g + self.b2 * self.nu[i]
            u = self.mu[i] / bc1
            if r is not None:
                u = r * u / ((self.nu[i] / bc2).sqrt() + self.eps)
            q.add_(-self.lr * u)
        self.count = t


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}
