"""Event-sample pipeline: voxelize, normalize, crop, flip.

Counterpart of ``ess_tpu/data/pipeline.py`` (``PipelineConfig``,
``AugmentParams``, ``EventPipeline.sample_augment``,
``apply_label_transform`` and ``build_all`` with the horizontal flip): all
B*T windows of a host-folded batch voxelize in one launch, window-major.
DSEC drops the 40 bottom sensor rows (480 -> 440) after the per-window
normalization, which covers the full sensor grid; a flipped sample has its
windows and its label mirrored together. The random crop (DDD17 UDA) is not
ported yet.

Flip draws come from an explicit ``torch.Generator``; they cannot reproduce
JAX's PRNG bits, so parity tests pass :class:`AugmentParams` explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ess_tpu_torch.ops.batch_voxel import voxelize_band


@dataclass(frozen=True)
class PipelineConfig:
    """Static geometry of one event dataset."""

    sensor_height: int
    sensor_width: int
    num_bins: int = 5
    normalize: bool = False          # per-window nonzero normalization
    crop_bottom: int = 0             # rows dropped from the bottom
    random_flip: bool = False        # train-time horizontal flip

    @property
    def output_size(self) -> Tuple[int, int]:
        return (self.sensor_height - self.crop_bottom, self.sensor_width)


@dataclass(frozen=True)
class AugmentParams:
    """Per-sample augmentation draws, shared across a sample's windows."""

    flip: Optional[torch.Tensor] = None      # (B,) bool


def random_flip(x: torch.Tensor, flip: torch.Tensor, batch_dim: int
                ) -> torch.Tensor:
    """Mirror ``x`` along its last (width) axis where ``flip`` (one bool per
    entry of ``x``'s ``batch_dim``) is set."""
    shape = [1] * x.ndim
    shape[batch_dim] = -1
    sel = flip.to(device=x.device, dtype=torch.bool).view(shape)
    return torch.where(sel, x.flip(-1), x)


class EventPipeline:
    """Builds model-input windows from host-folded SoA event batches."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def sample_augment(self, generator: Optional[torch.Generator],
                       batch_size: int, *, train: bool) -> AugmentParams:
        """Draw one flip bit per sample (p = 0.5) from ``generator`` when
        training with ``random_flip``; no augmentation otherwise."""
        if not train or generator is None or not self.cfg.random_flip:
            return AugmentParams()
        return AugmentParams(
            flip=torch.rand(batch_size, generator=generator) < 0.5)

    def apply_label_transform(self, label: torch.Tensor, aug: AugmentParams
                              ) -> torch.Tensor:
        """The same spatial augmentation on (B, H, W) integer labels."""
        if aug.flip is not None:
            label = random_flip(label, aug.flip, 0)
        return label

    def build_all(self, batch: Dict[str, torch.Tensor], *,
                  aug: AugmentParams = AugmentParams(),
                  out_dtype: torch.dtype = torch.float32,
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Batch {"ev_x", "ev_y", "ev_t", "ev_p", "ev_valid": (B, T, N),
        "ev_band_offsets": (B, T, G + 1), "label": (B, H, W)} ->
        (windows (T, B, C, H', W') in ``out_dtype``, label), with ``aug``
        applied to each sample's windows and label alike.

        Windows come out time-major, so the recurrent rollout reads window
        ``t`` as one contiguous block.
        """
        cfg = self.cfg
        if "ev_band_offsets" not in batch:
            raise ValueError("the port reads host-folded batches only "
                             "(ev_band_offsets)")
        b, t_dim, n = batch["ev_x"].shape
        flat = lambda a: a.transpose(0, 1).reshape(t_dim * b, a.shape[-1])
        grids = voxelize_band(
            flat(batch["ev_x"]), flat(batch["ev_y"]), flat(batch["ev_t"]),
            flat(batch["ev_p"]), flat(batch["ev_valid"]),
            flat(batch["ev_band_offsets"]), num_bins=cfg.num_bins,
            height=cfg.sensor_height, width=cfg.sensor_width,
            normalize=cfg.normalize)
        grids = grids[:, :, :cfg.output_size[0]].to(out_dtype).contiguous()
        windows = grids.view(t_dim, b, *grids.shape[1:])
        label = batch.get("label")
        if aug.flip is not None:
            windows = random_flip(windows, aug.flip, 1)
            if label is not None:
                label = self.apply_label_transform(label, aug)
        return windows, label
