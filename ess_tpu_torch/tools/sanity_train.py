"""Training sanity at the DSEC bench shape: a supervised overfit of one
synthetic, label-correlated batch.

Counterpart of the JAX package's ``tools/sanity_train.py``. One batch at the
bench shape (B=8, T=20 windows of 100k events on the 480x640 sensor cropped
to 440x640, 5 bins, 11 classes, bf16, base 32) whose events follow a band
scene: the rows of class c carry an event density proportional to c + 1
and a positive share of c / (classes - 1). The supervised train step runs
``steps`` times on it (the head learns; the E2VID stays as seeded), then
the eval step scores the same batch. The loss must stay finite and fall
below 0.7x of the first step's; the tool prints the loss trajectory and
the batch mIoU. It is the end-to-end check that learning still happens on
the card's kernels (voxelizer, ConvLSTM cells) and precision.

``main`` runs the train rollout on the int8 cell (``'pallas_int8'``, the
train default of the port's bench: B2-int8 where JAX's size rule takes it,
B2 elsewhere); JAX's tool leaves ``lstm_impl_train`` unset (the exact
cell). :func:`overfit` runs either cell and any event representation.

Usage: python -m ess_tpu_torch.tools.sanity_train [steps=40]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ess_tpu_torch import resolve_device
from ess_tpu_torch.core.config import (
    Config, DatasetConfig, EventDatasetConfig, ImageDatasetConfig,
    ModelConfig, OptimConfig, TaskConfig)
from ess_tpu_torch.ops.voxel_tiled import host_tile_bin
from ess_tpu_torch.train.builder import (build_modules, init_params,
                                         init_state, make_pipeline)
from ess_tpu_torch.train.metrics import confusion_to_iou
from ess_tpu_torch.train.supervised import make_eval_step, make_train_step

B, T, N, CLASSES = 8, 20, 100_000, 11
SENSOR_H, SENSOR_W, CROP_BOTTOM = 480, 640, 40
LOSS_DROP = 0.7      # the last loss must fall below this share of the first


def make_scene_batch(rng: np.random.Generator, b: int, t: int, n: int,
                     sensor_h: int, sensor_w: int, classes: int,
                     crop_bottom: int) -> Dict[str, np.ndarray]:
    """Label-correlated events, tile-sorted on the host: class c bands get
    event density proportional to c + 1 and polarity bias c/(classes - 1).
    Returns the SoA columns (``ev_x`` ... ``ev_valid``, ``ev_tile_offsets``)
    and the (b, sensor_h - crop_bottom, sensor_w) labels, numpy arrays."""
    band_h = sensor_h // classes
    label_full = np.minimum(
        np.arange(sensor_h)[:, None] // band_h, classes - 1
    ) * np.ones((1, sensor_w), np.int64)
    weights = (label_full[:, 0] + 1).astype(np.float64)
    weights /= weights.sum()
    shape = (b, t, n)
    ys = rng.choice(sensor_h, size=shape, p=weights).astype(np.float32)
    xs = rng.uniform(0, sensor_w - 1, shape).astype(np.float32)
    cls = np.minimum(ys.astype(np.int64) // band_h, classes - 1)
    p_pos = cls / (classes - 1)
    ps = (rng.random(shape) < p_pos).astype(np.float32)
    ts = np.sort(rng.uniform(0, 5e4, shape), axis=-1).astype(np.float32)

    raw = np.stack([xs, ys, ts, ps], axis=-1)
    valid = np.ones(shape, bool)
    sraw = np.empty_like(raw)
    svalid = np.empty_like(valid)
    offs = []
    for i in range(b):
        sraw[i], svalid[i], o = host_tile_bin(
            raw[i], valid[i], height=sensor_h, width=sensor_w, bins=5)
        offs.append(o)
    label = label_full[: sensor_h - crop_bottom]
    return {
        "ev_x": sraw[..., 0], "ev_y": sraw[..., 1], "ev_t": sraw[..., 2],
        "ev_p": sraw[..., 3], "ev_valid": svalid,
        "ev_tile_offsets": np.stack(offs),
        "label": np.broadcast_to(label, (b,) + label.shape).copy(),
    }


def sanity_config(*, lstm_impl_train: Optional[str] = "pallas_int8",
                  representation: str = "voxel_grid", b: int = B,
                  t: int = T, n: int = N, classes: int = CLASSES,
                  shape: Tuple[int, int] = (SENSOR_H - CROP_BOTTOM,
                                            SENSOR_W),
                  base: int = 32) -> Config:
    """The JAX tool's config (DSEC events at ``shape``, bf16, lr_back
    1e-3) with the train cell and the event representation."""
    return Config(
        dataset=DatasetConfig(
            sensor_a=ImageDatasetConfig(shape=shape),
            sensor_b=EventDatasetConfig(
                name="DSEC_events", shape=shape, nr_events_data=t,
                nr_temporal_bins=5, nr_events_window=n,
                event_representation=representation)),
        model=ModelConfig(model_name="ess_supervised",
                          compute_dtype="bfloat16",
                          lstm_impl_train=lstm_impl_train,
                          e2vid_base_channels=base,
                          data_augmentation_train=False),
        task=TaskConfig(semseg_num_classes=classes),
        optim=OptimConfig(batch_size_b=b, lr_back=1e-3))


def overfit(cfg: Config, batch: Dict[str, torch.Tensor], steps: int, *,
            device=None, log=print) -> Tuple[List[float], float]:
    """``steps`` supervised train steps of ``cfg``'s seeded modules (seed
    0) on ``batch`` (tensors on ``device``) through the dataset's eval
    pipeline (no flip), then the eval step on it: (losses, batch mIoU in
    %). A non-finite loss raises."""
    mods = build_modules(cfg, device=resolve_device(device))
    init_params(mods, torch.Generator().manual_seed(0))
    state = init_state(mods)
    pipeline = make_pipeline(cfg, train=False)
    train_step = make_train_step(mods, pipeline)
    losses = []
    for i in range(steps):
        loss = float(train_step(state, batch)["loss"])
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {i}")
        losses.append(loss)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:3d}: loss {loss:.4f}")
    cm = make_eval_step(mods, pipeline)(batch)["cm"]
    _, miou = confusion_to_iou(cm.cpu().numpy())
    return losses, float(miou)


def main(steps: int = 40, *, device=None) -> None:
    device = resolve_device(device)
    cfg = sanity_config()
    host = make_scene_batch(np.random.default_rng(0), B, T, N, SENSOR_H,
                            SENSOR_W, CLASSES, CROP_BOTTOM)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in host.items()}
    losses, miou = overfit(cfg, batch, steps, device=device)
    print(f"final: loss {losses[-1]:.4f} (from {losses[0]:.4f}), "
          f"train-batch mIoU {miou:.1f}")
    if not losses[-1] < LOSS_DROP * losses[0]:
        raise AssertionError("loss did not decrease enough")
    print("SANITY OK")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 40)
