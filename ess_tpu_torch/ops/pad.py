"""UNet pad geometry, reflection pad and crop (NCHW).

Counterpart of ``ess_tpu/ops/pad.py`` (``CropGeometry``, ``reflect_pad``,
``crop_output``): inputs are reflection-padded up to the next multiple of
2**num_encoders, centered (ceil on top/left), and outputs are cropped back
by the same amounts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


def optimal_crop_size(size: int, max_subsample_factor: int) -> int:
    """Smallest multiple of 2**max_subsample_factor that is >= size."""
    f = 2 ** max_subsample_factor
    return f * math.ceil(size / f)


@dataclass(frozen=True)
class CropGeometry:
    """Static pad amounts for a (height, width) input."""

    height: int
    width: int
    num_encoders: int

    @property
    def padded_height(self) -> int:
        return optimal_crop_size(self.height, self.num_encoders)

    @property
    def padded_width(self) -> int:
        return optimal_crop_size(self.width, self.num_encoders)

    @property
    def pads(self) -> tuple[int, int, int, int]:
        """(top, bottom, left, right)."""
        dh = self.padded_height - self.height
        dw = self.padded_width - self.width
        return (math.ceil(dh / 2), math.floor(dh / 2),
                math.ceil(dw / 2), math.floor(dw / 2))


def reflect_pad(x: torch.Tensor, geom: CropGeometry) -> torch.Tensor:
    """Reflection-pad an NCHW tensor to the UNet-divisible size."""
    top, bottom, left, right = geom.pads
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), mode="reflect")


def crop_output(x: torch.Tensor, geom: CropGeometry) -> torch.Tensor:
    """Crop an NCHW tensor back to the original (height, width)."""
    top, _, left, _ = geom.pads
    return x[:, :, top:top + geom.height, left:left + geom.width]
