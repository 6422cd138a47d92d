"""Segmentation task loss: dice + cross-entropy with ignore label.

Counterpart of ``ess_tpu/train/losses.py::task_loss`` on NCHW logits
(B, C, H, W) and NHW integer labels; the loss math runs in f32 and is
differentiable in the logits (the train step's head backward).
"""

from __future__ import annotations

import torch


def task_loss(logits: torch.Tensor, labels: torch.Tensor, *,
              num_classes: int, ignore_label: int = 255,
              losses: tuple[str, ...] = ("dice", "cross_entropy")
              ) -> torch.Tensor:
    """Sum of the selected terms:

    - cross_entropy: mean negative log-likelihood over non-ignored pixels;
    - dice: per class ``1 - (2*sum(p*t) + 1) / (sum(p^2) + sum(t^2) + 1)``
      over every pixel of the batch, with probabilities and one-hot targets
      zeroed at ignored pixels, averaged over classes.
    """
    if logits.shape[1] != num_classes:
        raise ValueError(f"logits have {logits.shape[1]} classes, "
                         f"expected {num_classes}")
    log_probs = torch.log_softmax(logits.float(), dim=1)
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    if "cross_entropy" in losses:
        picked = log_probs.gather(1, safe[:, None])[:, 0]
        nll = torch.where(valid, -picked, torch.zeros_like(picked))
        total = total + nll.sum() / torch.clamp(valid.sum(), min=1)
    if "dice" in losses:
        vmask = valid[:, None].float()
        probs = torch.exp(log_probs) * vmask
        one_hot = torch.zeros_like(probs).scatter_(1, safe[:, None], 1.0)
        one_hot = one_hot * vmask
        axes = (0, 2, 3)
        num = 2.0 * (probs * one_hot).sum(axes) + 1.0
        den = (probs * probs).sum(axes) + one_hot.sum(axes) + 1.0
        total = total + (1.0 - num / den).mean()
    return total
