"""Supervised ESS steps: frozen E2VID rollout + trainable segmentation head.

Counterparts of ``ess_tpu/train/supervised.py::make_train_step`` and
``make_eval_step``. Both take a batch in any of JAX's three forms
(:func:`_rollout`):

- event columns as ``EventPipeline.build_all`` takes them (f32 or packed,
  host-folded, tile-sorted or raw, rectified on the device with the
  pipeline's map), all T windows voxelized in one launch before the
  rollout (``precompute=True``, the default);
- the same columns with ``precompute=False``: each window voxelized just
  before its step (``Reconstructor.rollout_events``), T voxelizer launches
  a step and one window's grid alive at a time;
- dense grids ``{"events": (B, T, H, W, C), "label"}``, built already (for
  example by ``EventPipeline.__call__``): rolled out as given, with no
  normalization, crop or augmentation and the label as it comes. The step
  permutes them to (T, B, C, H, W) where they lie, which must be the
  model's device.

A precomputed event batch takes JAX's branches (:func:`rollout_form`):
with ``stack_windows`` B1 emits the space-to-depth window stack
(``build_all_stack``), with ``raw_windows`` the raw band accumulator
(``build_all_raw``), each mapped to a block window just before its step
(``Reconstructor.rollout_raw``); ``windows_s2d=True`` (a step keyword)
builds space-to-depth windows in one batch (``build_all(layout='s2d')``),
JAX's default branch, which the port keeps opt-in; a quad-block rollout
(``RecurrentUNet(quad_block=True)``) builds 4x4 block windows
(``build_all(layout='s4d')``) where the pipeline can, and takes no stack
or raw branch, as JAX's; otherwise the standard build. The stack and raw
windows equal the standard build's bit for bit.

- Train: voxelize all windows once (with the flip augmentation), roll the
  frozen backbone out under ``torch.no_grad`` on the train rollout's
  ConvLSTM cell with no decoder (the head reads only the latent; XLA drops
  the unused decoder in the JAX step), then the head forward, the task loss
  times ``weight_task_loss``, its backward into the head, and one RAdam
  update. Where ``mods.fused_final`` is on and the geometry allows (JAX's
  conditions: a skip-connect head, even label sides at twice the latent's
  scale-2 size), the head runs its fused-final stage and the loss reads
  the labels folded to its pseudo-pixels (``fold_labels_up2x``): the same
  loss and gradient.
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
from ess_tpu_torch.train.losses import fold_labels_up2x, task_loss
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
    """B of a batch: dense ("events"), f32 ("ev_x") or packed ("ev_xq")."""
    for key in ("events", "ev_xq", "ev_x"):
        if key in batch:
            return batch[key].shape[0]
    raise KeyError("a batch needs events, ev_x or ev_xq")


def rollout_form(recon, batch: Dict[str, torch.Tensor],
                 pipeline: Optional[EventPipeline], *, train: bool,
                 precompute: bool = True, windows_s2d: bool = False) -> str:
    """The branch :func:`_rollout` takes (``'dense'``, ``'in_loop'``,
    ``'s4d'``, ``'stack'``, ``'raw'``, ``'s2d'`` or ``'standard'``), under
    JAX's conditions (``ess_tpu/train/supervised.py:52-100``): a
    precomputed event batch goes to a block-window branch where the
    pipeline can build one (``s2d_capable``, and ``s4d_capable`` for a
    quad-block rollout), the rollout runs in block space at a size that
    needs no pad, the windows come out at that size, and a resize rides on
    band offsets; then a quad-block rollout takes the s4d build, any other
    the stack build if ``stack_capable``, else the raw build if
    ``raw_capable``, else the s2d build if ``windows_s2d``; else the
    standard build."""
    if "events" in batch:
        return "dense"
    if not precompute:
        return "in_loop"
    cfg = pipeline.cfg
    g = recon.geometry
    quad = recon.quad
    blocks = (pipeline.s2d_capable(train=train) and recon.use_blocks
              and (not quad or pipeline.s4d_capable(train=train))
              and (cfg.resize_to is None or "ev_band_offsets" in batch)
              and (g.padded_height, g.padded_width)
              == (recon.height, recon.width)
              and tuple(cfg.output_size(train))
              == (recon.height, recon.width))
    if blocks and quad:
        return "s4d"
    if blocks and pipeline.stack_capable(train=train, batch=batch):
        return "stack"
    if blocks and pipeline.raw_capable(train=train, batch=batch):
        return "raw"
    return "s2d" if blocks and windows_s2d else "standard"


def _rollout(recon, batch: Dict[str, torch.Tensor],
             pipeline: Optional[EventPipeline], *,
             aug: AugmentParams = AugmentParams(), decode: bool = True,
             precompute: bool = True, train: bool = False,
             windows_s2d: bool = False):
    """The rollout of a batch in one of the three forms (module docstring)
    -> (final image or None, final latent, labels), JAX's ``_rollout``.
    ``aug`` applies to event batches only; ``train`` (a train step's
    rollout) and ``windows_s2d`` choose the branch (:func:`rollout_form`)."""
    if "events" in batch:
        events = batch["events"]
        device = next(recon.model.parameters()).device
        if events.device != device:
            raise ValueError(f"dense events on {events.device}, the model "
                             f"on {device}")
        img, _, latent = recon.rollout(events.permute(1, 0, 4, 2, 3),
                                       decode=decode)
        return img, latent, batch.get("label")
    if pipeline is None:
        raise ValueError("an event batch needs an EventPipeline")
    form = rollout_form(recon, batch, pipeline, train=train,
                        precompute=precompute, windows_s2d=windows_s2d)
    dtype = recon.model.dtype
    if form in ("stack", "raw"):
        build = (pipeline.build_all_stack if form == "stack"
                 else pipeline.build_all_raw)
        built, labels, window_map = build(batch, aug=aug, out_dtype=dtype)
        img, _, latent = recon.rollout_raw(built["raw"], built["stats"],
                                           window_map, decode=decode)
        return img, latent, labels
    if precompute:
        windows, labels = pipeline.build_all(
            batch, aug=aug, out_dtype=dtype,
            layout=form if form in ("s2d", "s4d") else "nchw")
        img, _, latent = recon.rollout(windows, decode=decode,
                                       windows_s2d=form in ("s2d", "s4d"))
        return img, latent, labels
    if "ev_xq" in batch:
        batch = pipeline.decode_packed(batch)
    voxel_fn = pipeline.make_window_fn(
        aug, t_prenormalized=bool(batch.get("ev_t_prenormalized", False)),
        offsets_kind="band" if "ev_band_offsets" in batch else "tile")
    labels = batch.get("label")
    if labels is not None:
        labels = pipeline.apply_label_transform(labels, aug)
    img, _, latent = recon.rollout_events(batch, voxel_fn, decode=decode)
    return img, latent, labels


def fused_final_fits(mods: ESSModules, labels_hw, latent2_hw=None) -> bool:
    """Whether a head pass runs its fused-final stage: the modules' choice
    (``mods.fused_final``), a skip-connect head, even label sides and a
    scale-2 latent at half their size (JAX's conditions); ``latent2_hw``
    None checks the sides alone (the UDA step's branches, JAX's ``f_img``
    and ``f_ev``)."""
    lh, lw = labels_hw
    return (mods.fused_final and mods.head.skip_connect
            and lh % 2 == 0 and lw % 2 == 0
            and (latent2_hw is None
                 or (lh // 2, lw // 2) == tuple(latent2_hw)))


def _step_augment(pipeline, batch, aug, seed: int, step: int,
                  draw=None) -> AugmentParams:
    """This rank's draws for an event batch (``aug``, the global batch's,
    else ``draw(pipeline, seed, step, rows)``, :func:`draw_augment` by
    default); none for a dense one."""
    if "events" in batch:
        return AugmentParams()
    rows = batch_size(batch) * dp.world()
    if aug is None:
        aug = (draw or draw_augment)(pipeline, seed, step, rows)
    return rank_rows(aug, rows)


def make_train_step(mods: ESSModules,
                    pipeline: Optional[EventPipeline] = None, *,
                    precompute: bool = True, windows_s2d: bool = False
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, batch, aug=None) -> {"loss", "semseg_sensor_b_loss"}``;
    updates ``state`` (the head's parameters through ``state.opt_back``,
    ``state.step``) in place. ``batch`` in any form of the module
    docstring (an event batch needs ``pipeline``; ``precompute`` and
    ``windows_s2d`` pick its rollout). ``aug`` (the global batch's draws)
    defaults to draws
    from a generator seeded by ``cfg.seed`` and ``state.step``; a dense
    batch takes none. Under data parallel ``batch`` is this rank's rows of
    the global batch, and the losses and the update are the global
    batch's."""
    cfg = mods.cfg
    recon = mods.recon_train

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             aug: Optional[AugmentParams] = None) -> Dict[str, torch.Tensor]:
        aug = _step_augment(pipeline, batch, aug, cfg.seed, state.step)
        with torch.no_grad():
            _, latent, labels = _rollout(recon, batch, pipeline, aug=aug,
                                         decode=False, precompute=precompute,
                                         train=True, windows_s2d=windows_s2d)
        params = [p for p in state.head.parameters() if p.requires_grad]
        fused = fused_final_fits(mods, labels.shape[1:3],
                                 latent[2].shape[2:4])
        if fused:
            labels = fold_labels_up2x(labels)
        logits = state.head(latent, fused_final=fused)[1]
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


def make_eval_step(mods: ESSModules,
                   pipeline: Optional[EventPipeline] = None, *,
                   precompute: bool = True, windows_s2d: bool = False
                   ) -> Callable[[Dict[str, torch.Tensor]],
                                 Dict[str, torch.Tensor]]:
    """``step(batch) -> {"loss", "cm", "pred", "img_fake", "latent8"}``;
    ``img_fake`` and ``latent8`` are NCHW f32. ``batch``, ``pipeline``,
    ``precompute`` and ``windows_s2d`` as for :func:`make_train_step`."""
    cfg = mods.cfg
    recon = mods.recon_val

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        img_fake, latent, labels = _rollout(recon, batch, pipeline,
                                            precompute=precompute,
                                            windows_s2d=windows_s2d)
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
