"""Segmentation and domain-adaptation losses.

Counterpart of ``ess_tpu/train/losses.py`` on NCHW logits (B, C, H, W) and
NHW integer labels: ``cross_entropy_loss``, ``dice_loss`` and their sum
``task_loss`` (with ignore label), ``symmetric_js_divergence`` and
``l1_loss``, the cycle losses of ESS UDA. The math runs in f32 and is
differentiable in the logits. The JAX package's class-on-sublane
transposes are TPU layouts of the same sums. Its label folds are ported:
the fused-final head's logits come as (B, C, H/2, 2W) parity
pseudo-pixels (:func:`fold_labels_up2x`) and the blocked head's s4d
logits as (B, C, H/4, 4W) (:func:`s4d_logits_class_minor`,
:func:`fold_labels_s4d`); CE and dice sum over pixels in any order, so
the folded losses are the standard ones.

Every sum, count and mean over the batch is the global batch's under data
parallel (``parallel/dp.py``): the ranks' partial sums go through
``dp.all_sum``, so each rank computes the loss of the whole global batch,
as GSPMD makes the JAX package's reductions global.
"""

from __future__ import annotations

import math

import torch

from ess_tpu_torch.parallel import dp


def _check_classes(logits: torch.Tensor, num_classes: int) -> None:
    if logits.shape[1] != num_classes:
        raise ValueError(f"logits have {logits.shape[1]} classes, "
                         f"expected {num_classes}")


def _valid_labels(labels: torch.Tensor, ignore_label: int):
    valid = labels != ignore_label
    return valid, torch.where(valid, labels, torch.zeros_like(labels)).long()


def _cross_entropy(log_probs, valid, safe) -> torch.Tensor:
    picked = log_probs.gather(1, safe[:, None])[:, 0]
    nll = torch.where(valid, -picked, torch.zeros_like(picked))
    return dp.all_sum(nll.sum()) / torch.clamp(dp.all_sum(valid.sum()),
                                               min=1)


def _dice(log_probs, valid, safe, smooth: float = 1.0) -> torch.Tensor:
    vmask = valid[:, None].float()
    probs = torch.exp(log_probs) * vmask
    one_hot = torch.zeros_like(probs).scatter_(1, safe[:, None], 1.0) * vmask
    axes = (0, 2, 3)
    pt, pp, tt = dp.all_sum(torch.stack([(probs * one_hot).sum(axes),
                                         (probs * probs).sum(axes),
                                         one_hot.sum(axes)]))
    num = 2.0 * pt + smooth
    den = pp + tt + smooth
    return (1.0 - num / den).mean()


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over every element of the global batch (``x.mean()`` on one
    device)."""
    if dp.world() == 1:
        return x.mean()
    return dp.all_sum(x.sum()) / math.prod(dp.global_shape(x.shape))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_label: int = 255) -> torch.Tensor:
    """Mean negative log-likelihood over non-ignored pixels
    (``nn.CrossEntropyLoss(ignore_index)``)."""
    return _cross_entropy(torch.log_softmax(logits.float(), dim=1),
                          *_valid_labels(labels, ignore_label))


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, *,
              num_classes: int, ignore_label: int = 255,
              smooth: float = 1.0) -> torch.Tensor:
    """Per class ``1 - (2*sum(p*t) + s) / (sum(p^2) + sum(t^2) + s)`` over
    every pixel of the batch, with probabilities and one-hot targets zeroed
    at ignored pixels, averaged over classes."""
    _check_classes(logits, num_classes)
    return _dice(torch.log_softmax(logits.float(), dim=1),
                 *_valid_labels(labels, ignore_label), smooth)


def task_loss(logits: torch.Tensor, labels: torch.Tensor, *,
              num_classes: int, ignore_label: int = 255,
              losses: tuple[str, ...] = ("dice", "cross_entropy")
              ) -> torch.Tensor:
    """Sum of the selected terms (:func:`dice_loss`,
    :func:`cross_entropy_loss`) over one shared log-softmax."""
    _check_classes(logits, num_classes)
    log_probs = torch.log_softmax(logits.float(), dim=1)
    valid, safe = _valid_labels(labels, ignore_label)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    if "cross_entropy" in losses:
        total = total + _cross_entropy(log_probs, valid, safe)
    if "dice" in losses:
        total = total + _dice(log_probs, valid, safe)
    return total


def symmetric_js_divergence(p_logits: torch.Tensor,
                            q_logits: torch.Tensor) -> torch.Tensor:
    """``0.5 KL(q||p) + 0.5 KL(p||q)`` of the class softmaxes, each clamped
    at 1e-10, with the mean over every element (torch's legacy
    ``KLDivLoss`` 'mean' reduction)."""
    p = torch.clamp(torch.softmax(p_logits.float(), dim=1), min=1e-10)
    q = torch.clamp(torch.softmax(q_logits.float(), dim=1), min=1e-10)
    log_p, log_q = torch.log(p), torch.log(q)
    kl_qp = _mean(q * (log_q - log_p))
    kl_pq = _mean(p * (log_p - log_q))
    return 0.5 * kl_qp + 0.5 * kl_pq


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error in f32 (the cycle-content loss)."""
    return _mean((a.float() - b.float()).abs())


def s4d_logits_class_minor(logits_s4d: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """The blocked head's s4d logits (B, 16C, h, w) -> (B, C, h, w*16): one
    pseudo-pixel per subpixel, in (j, r, s) order along the width (JAX's
    (B, h, w*16, C) with the classes on dim 1)."""
    b, cc, h, w = logits_s4d.shape
    if cc != 16 * num_classes:
        raise ValueError(f"s4d logits have {cc} channels, expected "
                         f"16 * {num_classes}")
    return logits_s4d.view(b, 16, num_classes, h, w).permute(
        0, 2, 3, 4, 1).reshape(b, num_classes, h, w * 16)


def fold_labels_up2x(labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) labels -> (B, H/2, (W/2)*4) pseudo-pixels in (j, r, s)
    order, matching the fused-final head's logits."""
    b, hh, ww = labels.shape
    return labels.reshape(b, hh // 2, 2, ww // 2, 2).permute(
        0, 1, 3, 2, 4).reshape(b, hh // 2, (ww // 2) * 4)


def fold_labels_s4d(labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) labels -> (B, H/4, (W/4)*16) in the s4d subpixel order,
    matching :func:`s4d_logits_class_minor`."""
    b, hh, ww = labels.shape
    return labels.reshape(b, hh // 4, 4, ww // 4, 4).permute(
        0, 1, 3, 2, 4).reshape(b, hh // 4, (ww // 4) * 16)
