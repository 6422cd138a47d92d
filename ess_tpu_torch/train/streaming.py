"""Streaming long-horizon evaluation with carried recurrent state.

Counterpart of ``ess_tpu/train/streaming.py`` (``make_streaming_steps``,
``run_streaming_eval``): consecutive non-overlapping event windows roll
through the recurrent encoder with the recurrent state carried across
samples (reset only where ``is_first`` is set), and the segmentation head is
scored at the windows that carry a label. Windows without a label run
encoder-only; the state and the confusion matrix stay on the device.

A window batch holds ``ev_x, ev_y, ev_t, ev_p, ev_valid`` of shape (B, N) or
(B, 1, N), ``is_first`` (B,), for a scored window ``label`` (B, H, W), and
picks its voxelizer by key presence: ``ev_band_offsets`` the fold-free one,
``ev_tile_offsets`` or no offsets the halo-tiled one; the ``histogram`` and
``ev_segnet`` representations take raw events with or without tile offsets
(their scatter ignores them). A packed window (``ev_xq, ev_yq, ev_tq,
ev_pq`` and its offsets) is decoded where it lies before it is voxelized,
its time taken as normalized. A pipeline with a rectify map
(``PipelineConfig.rectify``) rectifies raw windows at sensor coordinates
on the device before it voxelizes them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ess_tpu_torch.data.pipeline import AugmentParams, EventPipeline, to_soa
from ess_tpu_torch.ops.resize import resize_nearest
from ess_tpu_torch.train.builder import ESSModules
from ess_tpu_torch.train.metrics import MetricsSemseg, confusion_matrix

Batch = Dict[str, torch.Tensor]


def make_streaming_steps(mods: ESSModules, pipeline: EventPipeline
                         ) -> Tuple[Callable, Callable]:
    """(encode_step, score_step) for streaming eval, both under
    ``torch.no_grad``.

    ``encode_step(recon_state, batch) -> recon_state`` advances the
    recurrent state over one unlabeled window (encoder only).
    ``score_step(recon_state, batch) -> (recon_state, cm)`` also decodes,
    runs the head and scores a labeled window. The state passed in is left
    as it was.
    """
    cfg = mods.cfg
    recon = mods.recon_val
    voxel_fns = {(kind, pre): pipeline.make_window_fn(
        AugmentParams(), t_prenormalized=pre, offsets_kind=kind)
        for kind in ("tile", "band") for pre in (False, True)}

    def _reset_where(is_first: torch.Tensor, recon_state):
        """Zero the state of the streams that start a sequence, on the
        state's device; every tensor ((h, c) of a ConvLSTM level, h of a
        ConvGRU one) comes out as a new channels-last buffer."""
        flag = is_first.to(torch.bool).view(-1, 1, 1, 1)
        reset = lambda s: torch.where(flag, 0.0, s).contiguous(
            memory_format=torch.channels_last)
        return tuple(tuple(map(reset, st)) if isinstance(st, tuple)
                     else reset(st) for st in recon_state)

    def _window(batch: Batch) -> torch.Tensor:
        if "ev_xq" in batch:
            batch = pipeline.decode_packed(batch)
        take = lambda a: a[:, 0] if a.ndim == 3 else a
        kind = "band" if "ev_band_offsets" in batch else "tile"
        voxel_fn = voxel_fns[kind, bool(batch.get("ev_t_prenormalized",
                                                  False))]
        offs = batch.get(f"ev_{kind}_offsets")
        return voxel_fn(take(batch["ev_x"]), take(batch["ev_y"]),
                        take(batch["ev_t"]), take(batch["ev_p"]),
                        take(batch["ev_valid"]),
                        tile_offsets=None if offs is None else take(offs))

    @torch.no_grad()
    def encode_step(recon_state, batch: Batch):
        recon_state = _reset_where(batch["is_first"], recon_state)
        _, new_state, _ = recon.step(_window(batch), recon_state,
                                     decode=False)
        return new_state

    @torch.no_grad()
    def score_step(recon_state, batch: Batch):
        recon_state = _reset_where(batch["is_first"], recon_state)
        _, new_state, latent = recon.step(_window(batch), recon_state,
                                          decode=True)
        logits = mods.head(latent)[1]
        labels = batch["label"]
        lh, lw = labels.shape[1], labels.shape[2]
        if tuple(logits.shape[2:]) != (lh, lw):
            logits = resize_nearest(logits, lh, lw)
        cm = confusion_matrix(logits.argmax(dim=1), labels,
                              num_classes=cfg.task.semseg_num_classes,
                              ignore_label=cfg.task.semseg_ignore_label)
        return new_state, cm

    return encode_step, score_step


def run_streaming_eval(mods: ESSModules, stream: Iterator[dict],
                       pipeline: EventPipeline) -> MetricsSemseg:
    """Drive a stream of single-window samples (numpy: ``raw_events``
    (1, N, 4) and ``valid`` (1, N), the SoA columns, or the packed columns
    ``ev_xq``...; ``is_first``, ``has_label``, ``label``; optionally host
    offsets) through the streaming steps on the modules' device, one stream
    (B=1), and return the accumulated metrics."""
    cfg = mods.cfg
    device = next(mods.e2vid.parameters()).device
    encode_step, score_step = make_streaming_steps(mods, pipeline)
    metrics = MetricsSemseg(cfg.task.semseg_num_classes,
                            cfg.task.semseg_ignore_label,
                            cfg.task.class_names)
    recon_state = None
    for sample in stream:
        if "raw_events" in sample or "ev_xq" in sample:
            sample = to_soa(sample)
        has_label = bool(np.asarray(sample["has_label"]))
        batch = {k: torch.from_numpy(np.ascontiguousarray(
                     np.asarray(v)[None])).to(device)
                 for k, v in sample.items()
                 if k != "has_label" and (k != "label" or has_label)}
        if recon_state is None:
            recon_state = mods.recon_val.init_state(
                batch["is_first"].shape[0], device)
        if has_label:
            recon_state, cm = score_step(recon_state, batch)
            metrics.update_confusion(cm.cpu().numpy())
        else:
            recon_state = encode_step(recon_state, batch)
    return metrics
