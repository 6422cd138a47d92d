"""Supervised ESS steps: frozen E2VID rollout + trainable segmentation head.

Counterparts of ``ess_tpu/train/supervised.py::make_train_step`` and
``make_eval_step`` on the batches ``EventPipeline.build_all`` takes (f32
or packed columns, host-folded, tile-sorted or raw).

- Train: voxelize all windows once (with the flip augmentation), roll the
  frozen backbone out under ``torch.no_grad`` on the train rollout's
  ConvLSTM cell with no decoder (the head reads only the latent; XLA drops
  the unused decoder in the JAX step), then the head forward, the task loss
  times ``weight_task_loss``, its backward into the head, and one RAdam
  update.
- Eval: voxelize, roll out at the validation geometry, run the head on the
  final latent, resize logits to the label size if they differ, then the
  task loss, argmax and confusion matrix.

Under data parallel (``parallel/dp.py``) each rank runs its rows of the
global batch: the augmentation is drawn for the global batch and sliced
(:func:`rank_rows`), the losses are the global batch's, the gradients
are averaged over the ranks before the update (``apply_updates``), and an
eval step's confusion matrix counts the rank's rows (the Trainer sums
them).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ess_tpu_torch.data.pipeline import AugmentParams, EventPipeline
from ess_tpu_torch.ops.resize import resize_nearest
from ess_tpu_torch.parallel import dp
from ess_tpu_torch.train.builder import ESSModules
from ess_tpu_torch.train.losses import task_loss
from ess_tpu_torch.train.metrics import confusion_matrix
from ess_tpu_torch.train.state import TrainState, apply_updates


def draw_augment(pipeline: EventPipeline, seed: int, step: int,
                 batch_size: int) -> AugmentParams:
    """A train step's augmentation: ``pipeline``'s draws for a global
    batch of ``batch_size`` rows from a generator seeded by ``seed`` and
    ``step``."""
    entropy = np.random.SeedSequence((seed, step)).generate_state(1)[0]
    gen = torch.Generator().manual_seed(int(entropy))
    return pipeline.sample_augment(gen, batch_size, train=True)


def rank_rows(aug: AugmentParams, global_rows: int) -> AugmentParams:
    """This data-parallel rank's rows of a global batch's draws (the
    draws themselves on one device)."""
    if dp.world() == 1:
        return aug
    return aug.rows(*dp.row_range(global_rows))


def batch_size(batch: Dict[str, torch.Tensor]) -> int:
    """B of an event batch, f32 ("ev_x") or packed ("ev_xq")."""
    return batch["ev_xq" if "ev_xq" in batch else "ev_x"].shape[0]


def make_train_step(mods: ESSModules, pipeline: EventPipeline
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, batch, aug=None) -> {"loss", "semseg_sensor_b_loss"}``;
    updates ``state`` (the head's parameters through ``state.opt_back``,
    ``state.step``) in place. ``aug`` (the global batch's draws) defaults
    to draws from a generator seeded by ``cfg.seed`` and ``state.step``.
    Under data parallel ``batch`` is this rank's rows of the global batch,
    and the losses and the update are the global batch's."""
    cfg = mods.cfg
    recon = mods.recon_train

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             aug: Optional[AugmentParams] = None) -> Dict[str, torch.Tensor]:
        rows = batch_size(batch) * dp.world()
        if aug is None:
            aug = draw_augment(pipeline, cfg.seed, state.step, rows)
        aug = rank_rows(aug, rows)
        with torch.no_grad():
            windows, labels = pipeline.build_all(batch, aug=aug,
                                                 out_dtype=recon.model.dtype)
            _, _, latent = recon.rollout(windows, decode=False)
        params = [p for p in state.head.parameters() if p.requires_grad]
        logits = state.head(latent)[1]
        loss = task_loss(
            logits, labels, num_classes=cfg.task.semseg_num_classes,
            ignore_label=cfg.task.semseg_ignore_label,
            losses=cfg.optim.task_loss) * cfg.optim.weight_task_loss
        grads = torch.autograd.grad(loss, params)
        apply_updates(params, grads, state.opt_back)
        state.step += 1
        loss = loss.detach()
        return {"loss": loss, "semseg_sensor_b_loss": loss}

    return step


def make_eval_step(mods: ESSModules, pipeline: EventPipeline
                   ) -> Callable[[Dict[str, torch.Tensor]],
                                 Dict[str, torch.Tensor]]:
    """``step(batch) -> {"loss", "cm", "pred", "img_fake", "latent8"}``;
    ``img_fake`` and ``latent8`` are NCHW f32."""
    cfg = mods.cfg
    recon = mods.recon_val

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        windows, labels = pipeline.build_all(batch,
                                             out_dtype=recon.model.dtype)
        img_fake, _, latent = recon.rollout(windows)
        logits = mods.head(latent)[1]
        lh, lw = labels.shape[1], labels.shape[2]
        if tuple(logits.shape[2:]) != (lh, lw):
            logits = resize_nearest(logits, lh, lw)
        loss = task_loss(
            logits, labels, num_classes=cfg.task.semseg_num_classes,
            ignore_label=cfg.task.semseg_ignore_label,
            losses=cfg.optim.task_loss) * cfg.optim.weight_task_loss
        pred = logits.argmax(dim=1)
        cm = confusion_matrix(pred, labels,
                              num_classes=cfg.task.semseg_num_classes,
                              ignore_label=cfg.task.semseg_ignore_label)
        return {"loss": loss, "cm": cm, "pred": pred, "img_fake": img_fake,
                "latent8": latent[8].float()}

    return step
