"""Train state and optimizer of the train steps.

Counterpart of ``ess_tpu/train/state.py``: ``make_radam`` is
``optax.radam(b1=0, b2=0.999, eps=1e-8, threshold=5)`` with an optional
per-epoch staircase ``optax.exponential_decay`` of the learning rate, written
as a ``torch.optim.Optimizer`` in optax's form. ``torch.optim.RAdam`` is not
that form: it adds eps after a different bias correction and switches to the
rectified update at ``rho_t > 5`` instead of ``>= 5``.

optax's update at step t (1-based), per parameter, in f32:

- ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g^2 + b2 v``;
- ``m^ = m / (1 - b1^t)``, ``v^ = v / (1 - b2^t)``;
- ``rho_inf = 2 / (1 - b2) - 1``, ``rho_t = rho_inf - 2 t b2^t / (1 - b2^t)``;
- ``u = r m^ / (sqrt(v^) + eps)`` with
  ``r = sqrt((rho_t - 4)(rho_t - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2) rho_t))``
  when ``rho_t >= threshold``, else ``u = m^``;
- ``p <- p - lr(t - 1) u``, with ``lr(k) = lr * decay^floor(k / steps_per_epoch)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn as nn


class RAdam(torch.optim.Optimizer):
    """optax's ``radam`` (module docstring) for f32 parameters. The step
    count is the optimizer's own (``step_count``), as optax's
    ``count`` in its state."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, *,
                 b1: float = 0.0, b2: float = 0.999, eps: float = 1e-8,
                 threshold: float = 5.0, lr_decay: float = 1.0,
                 steps_per_epoch: int = 1):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      threshold=threshold))
        self.lr_decay = lr_decay
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.step_count = 0

    def learning_rate(self, count: int, lr: float) -> float:
        """``optax.exponential_decay(lr, steps_per_epoch, lr_decay,
        staircase=True)`` at update ``count`` (0-based); exactly ``lr``
        when ``lr_decay == 1``."""
        return lr * self.lr_decay ** (count // self.steps_per_epoch)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RAdam.step takes no closure")
        count = self.step_count
        t = count + 1
        f32 = np.float32
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            # step scalars in f32, as optax computes them from its int32
            # count; tensor ops take them as exact f32 values (no device
            # copies, no sync)
            b2t = f32(b2) ** f32(t)
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            rho = f32(rho_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
            rectify = bool(rho >= group["threshold"])
            if rectify:
                r = float(np.sqrt((rho - f32(4)) * (rho - f32(2))
                                  * f32(rho_inf)
                                  / (f32((rho_inf - 4.0) * (rho_inf - 2.0))
                                     * rho)))
            bc1 = float(f32(1) - f32(b1) ** f32(t))
            bc2 = float(f32(1) - b2t)
            scale = -float(f32(self.learning_rate(count, group["lr"])))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                mu = (1 - b1) * g + b1 * st["mu"]
                nu = (1 - b2) * g ** 2 + b2 * st["nu"]
                st["mu"], st["nu"] = mu, nu
                u = mu / bc1
                if rectify:
                    u = r * u / (torch.sqrt(nu / bc2) + eps)
                p.add_(scale * u)
        self.step_count = t

    def state_dict(self) -> dict:
        """torch's optimizer state (``mu``, ``nu`` and the groups) plus
        ``step_count``, which the update reads."""
        out = super().state_dict()
        out["step_count"] = self.step_count
        return out

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.step_count = int(state_dict.pop("step_count"))
        super().load_state_dict(state_dict)


def make_radam(params: Iterable[torch.Tensor], lr: float, *,
               lr_decay: float = 1.0, steps_per_epoch: int = 1,
               b1: float = 0.0, b2: float = 0.999) -> RAdam:
    """RAdam(betas=(b1, b2), eps=1e-8, threshold=5) with the per-epoch
    staircase decay when ``lr_decay != 1``."""
    return RAdam(params, lr, b1=b1, b2=b2, eps=1e-8, threshold=5.0,
                 lr_decay=lr_decay, steps_per_epoch=steps_per_epoch)


@dataclass
class TrainState:
    """What a train step changes: the step counter, the trainable head and
    its optimizer and, for UDA, the image front (with its batch-norm
    statistics) and its optimizer, None in the supervised steps; and the
    frozen E2VID, which no step changes but a checkpoint holds, as the
    JAX ``TrainState`` does. The modules are the ones the steps run, so
    a restore loads into them in place."""

    step: int
    head: nn.Module
    opt_back: RAdam
    front: Optional[nn.Module] = None
    opt_front: Optional[RAdam] = None
    e2vid: Optional[nn.Module] = None


def apply_updates(params: Iterable[torch.Tensor],
                  grads: Iterable[torch.Tensor], opt: RAdam) -> None:
    """Set each parameter's gradient and take one optimizer step (the
    counterpart of optax's ``update`` + ``apply_updates``)."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()

