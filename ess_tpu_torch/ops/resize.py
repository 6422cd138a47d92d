"""Bilinear and nearest-neighbour resize (NCHW tensors, NHW label maps).

Counterpart of ``ess_tpu/ops/resize.py``. JAX's ``resize_bilinear`` with
``align_corners=True`` (the mode of the reference's event-tensor resizes,
DDD17's 346 -> 352 width) samples input ``i * (in - 1) / (out - 1)`` with no
antialiasing, which is torch's ``align_corners=True``; without it,
``jax.image.resize``'s 'linear' samples half-pixel centers and, when it
shrinks an axis, widens its triangle filter by the scale (antialiasing),
which is torch's ``antialias=True``. JAX's 'nearest' samples half-pixel
centers, which is torch's ``nearest-exact`` mode. The JAX package leaves
both to XLA; here they are library calls, not kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) features to (height, width)."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=align_corners,
                         antialias=not align_corners)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize (B, C, H, W) features or (B, H, W) labels to (height, width)."""
    if x.dim() == 3:
        return resize_nearest(x[:, None], height, width)[:, 0]
    if x.is_floating_point():
        return F.interpolate(x, size=(height, width), mode="nearest-exact")
    return F.interpolate(x.float(), size=(height, width),
                         mode="nearest-exact").to(x.dtype)
