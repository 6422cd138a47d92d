"""Synthetic event and image datasets for tests and benchmarks.

Counterpart of ``ess_tpu/data/synthetic.py``: a deterministic generator of
samples with the event datasets' contract (raw fixed-capacity windows,
their validity and a label). The scene is up to three moving rectangles on
a dark background: events fire along their leading and trailing edges with
opposite polarities, plus uniform noise, and the label marks each
rectangle's class id. The same seed gives the JAX package's samples.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ess_tpu_torch.data.slicer import pad_windows


class SyntheticEvents:
    """Map-style dataset matching the event-dataset sample contract."""

    def __init__(self, length: int = 16, height: int = 32, width: int = 32,
                 nr_events_data: int = 4, nr_events_window: int = 512,
                 num_classes: int = 6, with_image: bool = False,
                 seed: int = 6):
        self.length = length
        self.h, self.w = height, width
        self.t_dim = nr_events_data
        self.n = nr_events_window
        self.num_classes = num_classes
        self.with_image = with_image
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 10007 + idx)
        h, w = self.h, self.w
        label = np.zeros((h, w), np.uint8)
        boxes = []
        for c in range(1, min(4, self.num_classes)):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            bh, bw = rng.integers(h // 8, h // 4), rng.integers(w // 8, w // 4)
            vx = rng.integers(1, 3)
            boxes.append((y0, x0, bh, bw, vx))
            label[y0: y0 + bh, x0: x0 + bw] = c

        windows = []
        for t_i in range(self.t_dim):
            xs, ys, ps = [], [], []
            for (y0, x0, bh, bw, vx) in boxes:
                x_lead = (x0 + bw + t_i * vx) % w
                x_trail = (x0 + t_i * vx) % w
                yy = np.arange(y0, min(y0 + bh, h))
                xs += [np.full_like(yy, x_lead), np.full_like(yy, x_trail)]
                ys += [yy, yy]
                ps += [np.ones_like(yy), np.zeros_like(yy)]
            n_noise = max(self.n // 4, 8)
            xs.append(rng.integers(0, w, n_noise))
            ys.append(rng.integers(0, h, n_noise))
            ps.append(rng.integers(0, 2, n_noise))
            x = np.concatenate(xs).astype(np.float64)
            y = np.concatenate(ys).astype(np.float64)
            p = np.concatenate(ps).astype(np.float64)
            t = np.sort(rng.uniform(t_i * 1000.0, (t_i + 1) * 1000.0, len(x)))
            windows.append(np.stack([x, y, t, p], axis=1))

        raw, valid = pad_windows(windows, self.n)
        out = {"raw_events": raw, "valid": valid, "label": label}
        if self.with_image:
            out["image"] = (label > 0).astype(np.float32)[..., None]
        return out


class SyntheticImages:
    """Image-sensor (image, label) samples sharing the synthetic scenes."""

    def __init__(self, length: int = 16, height: int = 32, width: int = 32,
                 num_classes: int = 6, seed: int = 7):
        self._events = SyntheticEvents(
            length, height, width, nr_events_data=1, nr_events_window=8,
            num_classes=num_classes, with_image=True, seed=seed)

    def __len__(self) -> int:
        return len(self._events)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self._events[idx]
        return {"image": s["image"], "label": s["label"]}
