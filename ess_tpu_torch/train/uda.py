"""ESS UDA steps: the image front aligned with the event embedding.

Counterpart of ``ess_tpu/train/uda.py`` (``_cycle_latent_loss``,
``uda_losses``, ``make_train_step``, ``make_eval_step_a``,
``make_eval_step_b``) on NCHW images and sensor-B events in the three
forms of ``train/supervised.py``: event columns (precomputed or, with
``precompute=False``, voxelized in the loop) or dense grids, which the
train step takes as ``"events_b"`` and the event eval step as
``"events"``.

The train step rolls the frozen E2VID out under ``torch.no_grad`` on the
train rollout's ConvLSTM cell, decoder included (``img_fake``, the
reconstructed frame, feeds the front), then:

- image branch: the front in train mode on ``image_a``, the head, the task
  loss ``t_img``; on DSEC the front's features are detached, so only the
  head learns from images;
- event branch: the front in train mode on ``img_fake`` (batch-norm
  statistics updated after each pass, image first), L1 of its latents
  against the rollout's at scales 2, 4, 8 and, through the head, symmetric
  JS at 1x (counted only on DSEC) and L1 at 2x and 4x against the head's
  prediction on the rollout's latent: ``e_loss``, which trains the front
  only; the head on the rollout's latent against the detached front
  prediction: ``t_ev`` (plus the sensor-B task loss with
  ``train_on_event_labels``), which trains the head only.

Each of the three head passes runs its fused-final stage where
``mods.fused_final`` is on and its branch's input has even sides (JAX's
``f_img`` / ``f_ev``), with the labels folded to match
(``fold_labels_up2x``); the cycle losses compare predictions of one
layout, so every loss is the standard one.

The JAX step is one scalar loss whose ``stop_gradient`` placement decides
which parameters each term trains. Here the same gradients are two
``autograd.grad`` calls over one forward: the front's of ``e_loss`` (plus
``t_img`` off DSEC), the head's of ``t_img + t_ev``, with the
cross-targets detached. Each RAdam then steps once.

Under data parallel each rank runs its rows of the global batch, as the
supervised steps do (``train/supervised.py``); the image front's batch
norm takes the global batch's statistics (``models/layers.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ess_tpu_torch.data.pipeline import AugmentParams, EventPipeline
from ess_tpu_torch.ops.resize import resize_nearest
from ess_tpu_torch.train.builder import ESSModules
from ess_tpu_torch.train.losses import (
    fold_labels_up2x, l1_loss, symmetric_js_divergence, task_loss)
from ess_tpu_torch.train.metrics import confusion_matrix
from ess_tpu_torch.train.state import TrainState, apply_updates
from ess_tpu_torch.train.supervised import (
    _rollout, _step_augment, draw_augment, fused_final_fits)

Losses = Dict[str, torch.Tensor]
PREFIX = "sensor_b_to_sensor_a"


def _detach(latent: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    return {k: v.detach() for k, v in latent.items()}


def _task_loss_fn(cfg):
    def tloss(logits, labels):
        return task_loss(logits, labels,
                         num_classes=cfg.task.semseg_num_classes,
                         ignore_label=cfg.task.semseg_ignore_label,
                         losses=cfg.optim.task_loss)
    return tloss


def _cycle_latent_loss(latent_fake, latent_real, *, skip_connect_encoder,
                       weight, losses: Losses, prefix: str) -> torch.Tensor:
    """L1 of the multi-scale latents times ``weight``, each scale also in
    ``losses``."""
    total = 0.0
    for s in ((2, 4, 8) if skip_connect_encoder else (8,)):
        term = l1_loss(latent_fake[s], latent_real[s]) * weight
        losses[f"cycle_latent_{s}x_{prefix}_loss"] = term
        total = total + term
    return total


def uda_losses(mods: ESSModules, front, head, *, img_a, labels_a, img_fake,
               latent_real, labels_b=None):
    """The UDA losses of one batch -> (losses, front loss, head loss).

    ``img_fake`` and ``latent_real`` are the frozen rollout's outputs
    (without gradient). The front runs twice in train mode, updating its
    batch-norm statistics; the head three times. The front loss is
    ``e_loss`` (plus ``t_img`` off DSEC), the head loss ``t_img + t_ev``;
    ``losses["loss"]`` is their JAX total ``t_img + e_loss + t_ev``."""
    cfg = mods.cfg
    is_dsec = cfg.dataset.sensor_b.name.startswith("DSEC")
    w = cfg.optim
    tloss = _task_loss_fn(cfg)
    losses: Losses = {}
    f_img = fused_final_fits(mods, img_a.shape[2:])
    f_ev = fused_final_fits(mods, img_fake.shape[2:])

    # image branch
    latent_a = front(img_a, train=True)
    content_a = _detach(latent_a) if is_dsec else latent_a
    pred_a = head(content_a, fused_final=f_img)
    t_img = tloss(pred_a[1], fold_labels_up2x(labels_a) if f_img
                  else labels_a) * w.weight_task_loss
    losses["semseg_sensor_a_loss"] = t_img

    # event branch; e_loss trains the front only (the head's gradient is
    # never taken of it)
    latent_fake = front(img_fake, train=True)
    e_loss = _cycle_latent_loss(
        latent_fake, latent_real,
        skip_connect_encoder=cfg.model.skip_connect_encoder,
        weight=w.weight_cycle_emb_loss, losses=losses, prefix=PREFIX)
    pred_fake = head(latent_fake, fused_final=f_ev)
    pred_real = head(latent_real, fused_final=f_ev)
    pred_real_ng = _detach(pred_real)
    sym_1x = symmetric_js_divergence(pred_fake[1], pred_real_ng[1])
    losses[f"cycle_pred_1x_{PREFIX}_loss"] = sym_1x
    if is_dsec:
        e_loss = e_loss + sym_1x
    for s in (2, 4):
        term = l1_loss(pred_fake[s], pred_real_ng[s]) * w.weight_cycle_task_loss
        losses[f"cycle_pred_{s}x_{PREFIX}_loss"] = term
        e_loss = e_loss + term

    # t_ev trains the head only: latent_real carries no gradient
    pred_fake_ng = _detach(pred_fake)
    t_ev = symmetric_js_divergence(
        pred_real[1], pred_fake_ng[1]) * w.weight_cycle_pred_loss
    for s in (2, 4):
        t_ev = t_ev + l1_loss(pred_real[s], pred_fake_ng[s]) \
            * w.weight_cycle_task_loss
    if cfg.model.train_on_event_labels and labels_b is not None:
        t_b = tloss(pred_real[1], fold_labels_up2x(labels_b) if f_ev
                    else labels_b) * w.weight_task_loss
        losses["semseg_sensor_b_loss"] = t_b
        t_ev = t_ev + t_b

    losses["loss"] = t_img + e_loss + t_ev
    front_loss = e_loss if is_dsec else e_loss + t_img
    return losses, front_loss, t_img + t_ev


def make_train_step(mods: ESSModules,
                    pipeline: Optional[EventPipeline] = None, *,
                    precompute: bool = True) -> Callable[..., Losses]:
    """``step(state, batch, aug=None) -> losses``; updates ``state`` (front
    and head parameters through their RAdams, the front's batch-norm
    statistics, ``state.step``) in place. ``batch``: ``"image_a"``
    (B, 1, H, W), ``"label_a"`` (B, H, W), the sensor-B events as
    event columns (``"ev_*"``, through ``pipeline``; ``precompute`` picks
    their rollout) or dense grids ``"events_b"`` (B, T, H, W, C), and
    optionally ``"label_b"``. ``aug`` defaults to draws from a generator
    seeded by ``cfg.seed + 1`` and ``state.step`` (JAX's UDA key)."""
    cfg = mods.cfg
    recon = mods.recon_train
    is_dsec = cfg.dataset.sensor_b.name.startswith("DSEC")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             aug: Optional[AugmentParams] = None) -> Losses:
        b_batch = {k: v for k, v in batch.items() if k.startswith("ev_")}
        if "events_b" in batch:
            b_batch["events"] = batch["events_b"]
        if batch.get("label_b") is not None:
            b_batch["label"] = batch["label_b"]
        aug = _step_augment(pipeline, b_batch, aug, cfg.seed + 1, state.step,
                            draw_augment)
        with torch.no_grad():
            img_fake, latent_real, labels_b = _rollout(
                recon, b_batch, pipeline, aug=aug, precompute=precompute,
                train=True)
        p_front = [p for p in state.front.parameters() if p.requires_grad]
        p_back = [p for p in state.head.parameters() if p.requires_grad]
        losses, front_loss, back_loss = uda_losses(
            mods, state.front, state.head, img_a=batch["image_a"],
            labels_a=batch["label_a"], img_fake=img_fake,
            latent_real=latent_real, labels_b=labels_b)
        # off DSEC both losses reach back through the image branch
        g_front = torch.autograd.grad(front_loss, p_front,
                                      retain_graph=not is_dsec)
        g_back = torch.autograd.grad(back_loss, p_back)
        apply_updates(p_front, g_front, state.opt_front)
        apply_updates(p_back, g_back, state.opt_back)
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_eval_step_a(mods: ESSModules) -> Callable[..., Losses]:
    """Sensor-A (image) validation, ``step(batch)`` with ``"image"``
    (B, 1, H, W) and ``"label"``: the front with its running statistics,
    the head, the task loss and the confusion matrix ->
    ``{"semseg_sensor_a_loss", "cm_a", "pred", "latent8"}``."""
    cfg = mods.cfg
    tloss = _task_loss_fn(cfg)
    nc, ignore = cfg.task.semseg_num_classes, cfg.task.semseg_ignore_label

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Losses:
        labels = batch["label"]
        latent = mods.front_a(batch["image"], train=False)
        logits = mods.head(latent)[1]
        pred = logits.argmax(dim=1)
        return {"semseg_sensor_a_loss":
                tloss(logits, labels) * cfg.optim.weight_task_loss,
                "cm_a": confusion_matrix(pred, labels, num_classes=nc,
                                         ignore_label=ignore),
                "pred": pred, "latent8": latent[8].float()}

    return step


def make_eval_step_b(mods: ESSModules,
                     pipeline: Optional[EventPipeline] = None, *,
                     precompute: bool = True) -> Callable[..., Losses]:
    """Sensor-B (event) validation with the cycle branch, ``step(batch)``
    on a batch in any form of ``train/supervised.py``:
    the rollout at the validation geometry (exact cell), the head's
    prediction resized to the label size, its loss and confusion matrix;
    then the reconstruction through the front (running statistics) and the
    head, its loss and confusion matrix, and the cycle losses between the
    two branches. NCHW ``img_fake`` and ``latent8`` in f32."""
    cfg = mods.cfg
    recon = mods.recon_val
    w = cfg.optim
    tloss = _task_loss_fn(cfg)
    nc, ignore = cfg.task.semseg_num_classes, cfg.task.semseg_ignore_label

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Losses:
        out: Losses = {}
        img_fake, latent_ev, labels = _rollout(recon, batch, pipeline,
                                               precompute=precompute)
        lh, lw = labels.shape[1], labels.shape[2]

        def scored(logits, loss_key, cm_key):
            if tuple(logits.shape[2:]) != (lh, lw):
                logits = resize_nearest(logits, lh, lw)
            out[loss_key] = tloss(logits, labels) * w.weight_task_loss
            pred = logits.argmax(dim=1)
            out[cm_key] = confusion_matrix(pred, labels, num_classes=nc,
                                           ignore_label=ignore)
            return pred

        preds_ev = mods.head(latent_ev)
        out["pred"] = scored(preds_ev[1], "semseg_sensor_b_loss", "cm_b")

        latent_fake = mods.front_a(img_fake, train=False)
        for s in ((2, 4, 8) if cfg.model.skip_connect_encoder else (8,)):
            out[f"cycle_latent_{s}x_{PREFIX}_loss"] = l1_loss(
                latent_ev[s], latent_fake[s]) * w.weight_cycle_emb_loss
        preds_cycle = mods.head(latent_fake)
        scored(preds_cycle[1], f"semseg_{PREFIX}_loss", "cm_cycle")
        out[f"cycle_pred_1x_{PREFIX}_loss"] = symmetric_js_divergence(
            preds_cycle[1], preds_ev[1]) * w.weight_cycle_pred_loss
        for s in (2, 4):
            out[f"cycle_pred_{s}x_{PREFIX}_loss"] = l1_loss(
                preds_ev[s], preds_cycle[s]) * w.weight_cycle_task_loss
        out["img_fake"] = img_fake
        out["latent8"] = latent_ev[8].float()
        return out

    return step
