"""Metric writers.

Counterpart of ``ess_tpu/io/writers.py``: scalar curves (train losses
averaged over 50 steps), image grids and confusion-matrix figures. The
durable record is a JSONL stream (``metrics.jsonl``) that any dashboard can
tail; TensorBoard gets the same records where ``torch.utils.tensorboard``
imports, unless ``ESS_TENSORBOARD=0`` is set (the import may load
TensorFlow, seconds in a fresh process), and a ``tracker`` mirrors them:
``'wandb'`` to a W&B run where the package imports, or any callable, which
receives ``(kind, tag, value, step)``. Under data parallel only rank 0
writes; the other ranks hold a :class:`NullWriter`.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class MetricsWriter:
    """JSONL (always) + TensorBoard (if available) scalar and image
    writer."""

    def __init__(self, log_dir: str, *, config: Optional[dict] = None,
                 flush_every: int = 50, tracker=None,
                 tracker_project: str = "ess-tpu"):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tracker = None
        self._wandb = None
        if tracker == "wandb":
            try:
                import wandb
                self._wandb = wandb.init(
                    project=tracker_project, dir=log_dir,
                    config=config or {}, mode=os.environ.get(
                        "WANDB_MODE", "offline"))
            except Exception as e:  # run without it, but say so
                print(f"[ess-tpu] wandb tracker disabled: {e!r}")
        elif callable(tracker):
            self._tracker = tracker
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            if os.environ.get("ESS_TENSORBOARD", "1") != "0":
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
        except Exception:
            pass
        self._avg: Dict[str, list] = defaultdict(list)
        self.flush_every = flush_every
        if config:
            with open(os.path.join(log_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def scalar(self, tag: str, value: float, step: int) -> None:
        v = float(value)
        self._jsonl.write(json.dumps(
            {"t": time.time(), "step": step, tag: v}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)
        if self._wandb is not None:
            self._wandb.log({tag: v}, step=step)
        if self._tracker is not None:
            self._tracker("scalar", tag, v, step)

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "") -> None:
        for k, v in values.items():
            if np.ndim(v) == 0:
                self.scalar(prefix + k, v, step)

    def averaged_scalar(self, tag: str, value: float, step: int) -> None:
        """Accumulate and emit the mean every ``flush_every`` calls."""
        self._avg[tag].append(float(value))
        if len(self._avg[tag]) >= self.flush_every:
            self.scalar(tag, float(np.mean(self._avg[tag])), step)
            self._avg[tag].clear()

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        """Log an HWC uint8 or float image (grids built by
        ``ess_tpu_torch.utils.viz``). A JSONL marker records the emission
        for headless runs and tests."""
        arr = np.asarray(img_hwc)
        self._jsonl.write(json.dumps(
            {"t": time.time(), "step": step, "image": tag,
             "shape": list(arr.shape)}) + "\n")
        if self._tb is not None:
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            self._tb.add_image(tag, arr, step, dataformats="HWC")
        if self._tracker is not None:
            self._tracker("image", tag, img_hwc, step)

    def figure(self, tag: str, fig, step: int) -> None:
        """Log a matplotlib figure (confusion matrices)."""
        if fig is None:
            return
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step)   # closes the figure
        else:
            import matplotlib.pyplot as plt
            plt.close(fig)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullWriter:
    """A :class:`MetricsWriter` that writes nothing: the writer of every
    data-parallel rank but rank 0, so one run writes one log."""

    flush_every = 50

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "") -> None:
        pass

    def averaged_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        pass

    def figure(self, tag: str, fig, step: int) -> None:
        if fig is not None:
            import matplotlib.pyplot as plt
            plt.close(fig)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
