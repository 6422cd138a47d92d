"""Training loop: epochs, validation, checkpoints, logging.

Counterpart of ``ess_tpu/train/loop.py``: ``run`` trains epochs with a
validation every ``val_epoch_step`` epochs and a checkpoint after each
epoch; supervised ESS iterates the event loader only, ESS UDA pairs the
image and event loaders. Batches are split into SoA columns on the host
(``to_soa``), images moved to channel-first, and ``prefetch_to_device``
moves them to the device on a side stream while the previous step runs.
Each train step reads its losses back once (one host sync a step);
validation crosses to the host as scalars and (C, C) confusion matrices.
The learning-rate decay lives in the optimizers, not in the loop.

The train steps update the state's modules in place and return only their
losses, so the state always names the modules the steps run, and a
checkpoint, whose copy to the host waits for the device, saves the state
after the last step issued.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from ess_tpu_torch import resolve_device
from ess_tpu_torch.core.config import Config
from ess_tpu_torch.data.loader import PairedLoader, prefetch_to_device
from ess_tpu_torch.data.pipeline import to_soa
from ess_tpu_torch.io import timers
from ess_tpu_torch.io.checkpoint import AUTOSAVE_BASE, CheckpointManager
from ess_tpu_torch.io.writers import MetricsWriter
from ess_tpu_torch.train import supervised as sup
from ess_tpu_torch.train import uda as uda_mod
from ess_tpu_torch.train.builder import (
    ESSModules, build_modules, init_params, init_state, make_pipeline)
from ess_tpu_torch.train.metrics import MetricsSemseg
from ess_tpu_torch.utils import viz


def _host_batch(b: dict) -> dict:
    """A loader batch as the steps take it: raw events split into SoA
    columns, an (B, H, W, 1) image moved to (B, 1, H, W)."""
    if "raw_events" in b or "ev_xq" in b:
        b = to_soa(b)
    if "image" in b:
        b = dict(b, image=np.moveaxis(b["image"], -1, 1))
    return b


def _merge_uda(batch_a: dict, batch_b: dict) -> dict:
    out = {"image_a": batch_a["image"], "label_a": batch_a["label"]}
    for k, v in batch_b.items():
        out["label_b" if k == "label" else k] = v
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


class Trainer:
    """End-to-end ESS trainer (supervised or UDA) on ``device``
    (None: the first CUDA device; raises where there is none).

    The parameters start from ``init_params`` seeded with ``cfg.seed``;
    ``e2vid_state`` and ``front_state`` (state dicts, e.g. from
    :mod:`ess_tpu_torch.io.convert`) replace the E2VID's and the image
    front's. ``save_every_steps > 0`` adds mid-epoch checkpoints under
    ``AUTOSAVE_BASE + step``; ``profile_steps = (start, end)`` writes a
    ``torch.profiler`` trace of those train steps to ``<log_dir>/profile``.
    The JAX Trainer's ``mesh`` (data parallel over several devices) and its
    ``rectify_map`` (DSEC rectification on the device) are not ported: the
    port trains on one device, and DSEC is rectified on the host."""

    def __init__(
        self,
        cfg: Config,
        *,
        train_b,
        val_b=None,
        train_a=None,
        val_a=None,
        e2vid_state: Optional[Mapping[str, torch.Tensor]] = None,
        front_state: Optional[Mapping[str, torch.Tensor]] = None,
        log_dir: Optional[str] = None,
        save_every_steps: int = 0,
        profile_steps: Optional[tuple] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.save_every_steps = save_every_steps
        self.profile_steps = profile_steps
        self.cfg = cfg
        self.is_uda = cfg.model.model_name == "ess"
        self.train_b, self.val_b = train_b, val_b
        self.train_a, self.val_a = train_a, val_a

        steps_per_epoch = len(train_b) if not self.is_uda else max(
            len(train_a or train_b), len(train_b))
        self.mods: ESSModules = build_modules(
            cfg, device=self.device, steps_per_epoch=steps_per_epoch)
        self.pipe_train = make_pipeline(cfg, train=True)
        self.pipe_val = make_pipeline(cfg, train=False)
        init_params(self.mods, torch.Generator().manual_seed(cfg.seed))
        if e2vid_state is not None:
            self.mods.e2vid.load_state_dict(e2vid_state)
        if front_state is not None:
            if self.mods.front_a is None:
                raise ValueError("front_state given for a config without "
                                 "an image front (model_name 'ess' has one)")
            self.mods.front_a.load_state_dict(front_state)
        self.state = init_state(self.mods)

        if self.is_uda:
            self.train_step = uda_mod.make_train_step(self.mods,
                                                      self.pipe_train)
            self.eval_step_a = uda_mod.make_eval_step_a(self.mods)
            self.eval_step_b = uda_mod.make_eval_step_b(self.mods,
                                                        self.pipe_val)
        else:
            self.train_step = sup.make_train_step(self.mods, self.pipe_train)
            self.eval_step_b = sup.make_eval_step(self.mods, self.pipe_val)
            self.eval_step_a = None

        self.log_dir = log_dir or os.path.join(
            cfg.log_dir, time.strftime("%Y%m%d-%H%M%S"))
        self.writer = MetricsWriter(
            self.log_dir, config={"cfg": cfg},
            tracker=cfg.tracker if cfg.tracker != "none" else None)
        # train losses are averaged over 50 steps, or over an epoch where an
        # epoch is shorter, so that every epoch logs them
        self.writer.flush_every = min(self.writer.flush_every,
                                      max(steps_per_epoch, 1))
        counts = {"back_end": viz.count_params(self.state.head),
                  "front_sensor_b(e2vid,frozen)":
                  viz.count_params(self.mods.e2vid)}
        if self.state.front is not None:
            counts["front_sensor_a"] = viz.count_params(self.state.front)
        for name, n in counts.items():
            print(f"[ess-tpu] {name}: {n / 1e6:.2f}M params")
        self.ckpt = (CheckpointManager(os.path.join(self.log_dir,
                                                    "checkpoints"))
                     if cfg.checkpoint.save_checkpoint else None)
        self.step_count = 0
        self.epoch = 0
        if cfg.checkpoint.resume_training:
            self._resume()

    def _resume(self) -> None:
        """Resume from ``resume_file`` (a previous run's directory or its
        ``checkpoints/``), else from this run's own checkpoints: the latest
        save of any kind. After an epoch save the next epoch starts; after
        a mid-epoch autosave the interrupted epoch runs again (its data
        order restarts) from the saved parameters, optimizers and step."""
        src = self.ckpt
        rf = self.cfg.checkpoint.resume_file
        if rf:
            if os.path.isdir(os.path.join(rf, "checkpoints")):
                rf = os.path.join(rf, "checkpoints")
            src = CheckpointManager(rf)
        latest = src.latest() if src is not None else None
        if latest is None:
            return
        src.restore(self.state, latest)
        self.step_count = int(self.state.step)
        meta = src.restore_metadata(latest) or {}
        if latest >= AUTOSAVE_BASE:
            self.epoch = int(meta.get("epoch", 0))
        else:
            self.epoch = int(meta.get("epoch", latest)) + 1
        print(f"[ess-tpu] resumed from checkpoint {latest} "
              f"(epoch {self.epoch}, step {self.step_count})")

    # ------------------------------------------------------------------

    def _device_batches(self, loader) -> Iterator[dict]:
        return prefetch_to_device((_host_batch(b) for b in loader),
                                  device=self.device)

    def _train_batches(self) -> Iterator[dict]:
        if self.is_uda:
            paired = PairedLoader(self.train_a, self.train_b)
            it = (_merge_uda(_host_batch(a), _host_batch(b))
                  for a, b in paired)
            yield from prefetch_to_device(it, device=self.device)
        else:
            yield from self._device_batches(self.train_b)

    def train_epoch(self) -> None:
        for batch in self._train_batches():
            if self.profile_steps and self.step_count == self.profile_steps[0]:
                timers.start_trace(os.path.join(self.log_dir, "profile"))
            with timers.Timer("train_step"):
                losses = self.train_step(self.state, batch)
                # one read of all the losses: the step's only host sync
                names = list(losses)
                values = dict(zip(names, torch.stack(
                    [losses[k].float() for k in names]).tolist()))
            self.step_count += 1
            for k, v in values.items():
                self.writer.averaged_scalar(f"train/{k}", v, self.step_count)
            if (self.save_every_steps and self.ckpt is not None
                    and self.step_count % self.save_every_steps == 0):
                self.ckpt.save(AUTOSAVE_BASE + self.step_count, self.state,
                               metadata={"epoch": self.epoch,
                                         "step_count": self.step_count})
            if self.profile_steps and self.step_count == self.profile_steps[1]:
                timers.stop_trace()

    def _metrics(self) -> MetricsSemseg:
        task = self.cfg.task
        return MetricsSemseg(task.semseg_num_classes,
                             task.semseg_ignore_label, task.class_names)

    def validate(self) -> dict:
        task = self.cfg.task
        summary: dict = {}
        if self.eval_step_a is not None and self.val_a is not None:
            m = self._metrics()
            losses_a = []
            logged_a = False
            for batch in self._device_batches(self.val_a):
                out = self.eval_step_a(batch)
                m.update_confusion(_np(out["cm_a"]))
                losses_a.append(float(out["semseg_sensor_a_loss"]))
                if not logged_a:
                    self._log_val_images_a(batch, out)
                    self._log_latent_pca(out, "val_img")
                    logged_a = True
            if losses_a:
                # one mean per validation pass (the 50-sample window of
                # averaged_scalar would swallow small validation sets)
                self.writer.scalar("val/semseg_sensor_a_loss",
                                   float(np.mean(losses_a)), self.step_count)
            s = m.summary()
            summary["semseg_sensor_a_mean_iou"] = s["mean_iou"]
            summary["semseg_sensor_a_acc"] = s["acc"]

        if self.val_b is not None:
            m_b, m_cycle = self._metrics(), self._metrics()
            logged_images = False
            embeds = []
            for batch in self._device_batches(self.val_b):
                out = self.eval_step_b(batch)
                m_b.update_confusion(_np(out["cm_b" if "cm_b" in out
                                             else "cm"]))
                if "cm_cycle" in out:
                    m_cycle.update_confusion(_np(out["cm_cycle"]))
                if "latent8" in out:
                    # task-feature embedding: the spatially pooled deepest
                    # latent of each sample (NCHW)
                    embeds.append(_np(out["latent8"].mean(dim=(2, 3))))
                if not logged_images:
                    self._log_val_images(batch, out)
                    self._log_latent_pca(out, "val_events")
                    logged_images = True
            if embeds:
                edir = os.path.join(self.log_dir, "embeddings")
                os.makedirs(edir, exist_ok=True)
                viz.embedding_dump(
                    np.concatenate(embeds, axis=0), None,
                    os.path.join(edir,
                                 f"task_feature_space_{self.step_count}.tsv"))
            s = m_b.summary()
            summary["semseg_sensor_b_mean_iou"] = s["mean_iou"]
            summary["semseg_sensor_b_acc"] = s["acc"]
            summary["cm_b"] = s["cm"]
            for name in task.class_names:
                self.writer.scalar(f"val_events/iou_{name}", float(s[name]),
                                   self.step_count)
            self.writer.figure(
                "val_events/semseg_cm",
                viz.confusion_matrix_figure(s["cm"], task.class_names),
                self.step_count)
            if m_cycle.confusion.sum() > 0:
                sc = m_cycle.summary()
                summary["semseg_sensor_cycle_mean_iou"] = sc["mean_iou"]
                summary["semseg_sensor_cycle_acc"] = sc["acc"]
        for k, v in summary.items():
            if np.ndim(v) == 0:
                self.writer.scalar(f"val/{k}", float(v), self.step_count)
        return summary

    def _colorized(self, maps) -> list:
        cmap = self.cfg.task.color_map
        ignore = self.cfg.task.semseg_ignore_label
        return [viz.colorize_semseg(p, cmap, ignore) / 255.0 for p in maps]

    def _log_val_images(self, batch: dict, out: dict, n: int = 4) -> None:
        """Validation grid of sensor B: the reconstruction, the colorized
        prediction and the colorized ground truth."""
        tiles = []
        if "img_fake" in out:
            tiles += [np.repeat(i[..., None], 3, -1)
                      for i in _np(out["img_fake"])[:n, 0]]
        if "pred" in out:
            tiles += self._colorized(_np(out["pred"])[:n])
        if "label" in batch:
            tiles += self._colorized(_np(batch["label"])[:n])
        if tiles:
            self.writer.image("val/sensor_b", viz.make_grid(tiles, nrow=n),
                              self.step_count)

    def _log_val_images_a(self, batch: dict, out: dict, n: int = 4) -> None:
        """Validation grid of sensor A: the input image, the colorized
        prediction and the colorized ground truth."""
        tiles = []
        if "image" in batch:
            imgs = _np(batch["image"])[:n, 0]
            lo, hi = imgs.min(), imgs.max()
            imgs = (imgs - lo) / max(hi - lo, 1e-12)
            tiles += [np.repeat(i[..., None], 3, -1) for i in imgs]
        if "pred" in out:
            tiles += self._colorized(_np(out["pred"])[:n])
        if "label" in batch:
            tiles += self._colorized(_np(batch["label"])[:n])
        if tiles:
            self.writer.image("val_img/sensor_a", viz.make_grid(tiles, nrow=n),
                              self.step_count)

    def _log_latent_pca(self, out: dict, prefix: str) -> None:
        """Top-3-PCA RGB image of the deepest latent of the first samples."""
        if "latent8" not in out:
            return
        tiles = [viz.latent_pca_rgb(lat) for lat in _np(out["latent8"])[:4]]
        self.writer.image(f"{prefix}/pca_latent_space",
                          viz.make_grid(tiles, nrow=len(tiles)),
                          self.step_count)

    def train_stats_epoch(self) -> dict:
        """An eval pass over the train sets with the validation's steps and
        metrics, logged under ``train_stats/`` (with
        ``cfg.model.do_val_training_epoch``)."""
        summary: dict = {}
        if self.eval_step_a is not None and self.train_a is not None:
            m = self._metrics()
            for batch in self._device_batches(self.train_a):
                m.update_confusion(_np(self.eval_step_a(batch)["cm_a"]))
            summary["train_stats_sensor_a_mean_iou"] = m.summary()["mean_iou"]
        if self.train_b is not None:
            m = self._metrics()
            for batch in self._device_batches(self.train_b):
                out = self.eval_step_b(batch)
                m.update_confusion(_np(out["cm_b" if "cm_b" in out
                                           else "cm"]))
            summary["train_stats_sensor_b_mean_iou"] = m.summary()["mean_iou"]
        for k, v in summary.items():
            tag = k.removeprefix("train_stats_")
            self.writer.scalar(f"train_stats/{tag}", float(v),
                               self.step_count)
        return summary

    def run(self) -> Dict[str, object]:
        """Train from ``self.epoch`` to ``num_epochs``, validating every
        ``val_epoch_step`` epochs before the epoch's training and once at
        the end, with a checkpoint after each epoch."""
        cfg = self.cfg
        last_summary: dict = {}
        validates = self.val_b is not None or self.val_a is not None
        for epoch in range(self.epoch, cfg.optim.num_epochs):
            self.epoch = epoch
            if epoch % cfg.optim.val_epoch_step == 0 and validates:
                last_summary = self.validate()
                if cfg.model.do_val_training_epoch:
                    last_summary.update(self.train_stats_epoch())
            self.train_epoch()
            if self.ckpt is not None:
                self.ckpt.save(epoch, self.state,
                               metadata={"epoch": epoch,
                                         "step_count": self.step_count})
        if validates:
            last_summary = self.validate()
        if self.ckpt is not None:
            self.ckpt.wait()
        self.writer.flush()
        return last_summary
