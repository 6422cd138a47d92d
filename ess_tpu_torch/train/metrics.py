"""Streaming confusion-matrix semantic-segmentation metrics.

Counterpart of ``ess_tpu/train/metrics.py``: the per-batch confusion matrix
on the tensors' device (rows are the true label, columns the prediction,
ignored pixels count nothing), mIoU and accuracy summaries, and the
accumulator over batches. Only (C, C) matrices cross to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, *,
                     num_classes: int, ignore_label: int = 255
                     ) -> torch.Tensor:
    """(num_classes, num_classes) f32 counts of (label, pred) pairs: one
    scatter-add of unit weights, with no host synchronization (the counts
    are exact in f32 below 2^24 pixels per cell)."""
    valid = label != ignore_label
    zero = torch.zeros_like(label, dtype=torch.long)
    idx = (torch.where(valid, label.long(), zero) * num_classes
           + torch.where(valid, pred.long(), zero))
    flat = torch.zeros(num_classes * num_classes, dtype=torch.float32,
                       device=label.device)
    flat.index_add_(0, idx.reshape(-1), valid.reshape(-1).float())
    return flat.view(num_classes, num_classes)


def confusion_to_iou(conf: np.ndarray) -> tuple[np.ndarray, float]:
    """Per-class IoU (x100) and mean IoU."""
    conf = np.asarray(conf, np.float64)
    diag = np.diag(conf)
    denom = conf.sum(axis=1) + conf.sum(axis=0) - diag
    iou = 100.0 * diag / np.clip(denom, 1e-12, None)
    return iou, float(iou.mean())


def confusion_to_accuracy(conf: np.ndarray) -> float:
    """Global pixel accuracy x100."""
    conf = np.asarray(conf, np.float64)
    return float(100.0 * np.diag(conf).sum() / max(conf.sum(), 1e-12))


class MetricsSemseg:
    """Streaming accumulator: update with per-batch (pred, label) or with a
    precomputed confusion matrix; summarize to mIoU, accuracy and the
    matrix."""

    def __init__(self, num_classes: int, ignore_label: int,
                 class_names: Sequence[str]):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.class_names = list(class_names)
        self._acc: Optional[np.ndarray] = None

    def reset(self) -> None:
        self._acc = None

    def update_batch(self, pred, label) -> None:
        cm = confusion_matrix(
            torch.as_tensor(pred), torch.as_tensor(label),
            num_classes=self.num_classes, ignore_label=self.ignore_label)
        self.update_confusion(cm.cpu().numpy())

    def update_confusion(self, cm: np.ndarray) -> None:
        cm = np.asarray(cm, np.float64)
        self._acc = cm if self._acc is None else self._acc + cm

    @property
    def confusion(self) -> np.ndarray:
        if self._acc is None:
            return np.zeros((self.num_classes, self.num_classes), np.float64)
        return self._acc

    def summary(self) -> Dict[str, object]:
        iou, miou = confusion_to_iou(self.confusion)
        out: Dict[str, object] = {name: iou[i]
                                  for i, name in enumerate(self.class_names)}
        out["mean_iou"] = miou
        out["acc"] = confusion_to_accuracy(self.confusion)
        out["cm"] = self.confusion
        return out
