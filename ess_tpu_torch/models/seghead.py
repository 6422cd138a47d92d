"""Semantic-segmentation head over the E2VID latent dict (NCHW).

Counterpart of ``ess_tpu/models/seghead.py::SegmentationHead`` with the
standard final stage (upstream SemSegE2VID). The skip-connect head:

  latent[8] --[5 x INSResBlock + ReLUINSConv]--> C/2 @ /8
  up2x + merge(latent[4]) --> 2 convs --> C/4 @ /4      (out[4])
  up2x + merge(latent[2]) --> 2 convs --> C/4 @ /2      (out[2])
  up2x --> conv --> C/8 --> 1x1 --> num_classes @ /1    (out[1])

and the plain one (``skip_connect=False``), which reads latent[8] alone:

  latent[8] --[3 x INSResBlock]--> C @ /8
  up2x --> conv --> C/2 @ /4                            (out[4])
  up2x --> conv --> C/4 @ /2                            (out[2])
  up2x --> conv --> C/8 --> 1x1 --> num_classes @ /1    (out[1])

with C = ``input_features``. Module names are upstream's
(``decoder_scale_1.{i}`` ... ``decoder_scale_5.0``; in the plain head the
upsample of a scale is its parameterless ``.0``). JAX's ``input_index_map``
option of the plain head is not ported: no config sets it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ess_tpu_torch.models.layers import (
    Conv2d, INSResBlock, ReLUINSConv2d, skip_merge, upsample2x_nearest)

Latent = Dict[int, torch.Tensor]


class SegmentationHead(nn.Module):
    """Multi-scale segmentation decoder; ``forward(latent)`` returns
    {8: latent[8], 4: feature, 2: feature, 1: logits (B, classes, H, W)}."""

    def __init__(self, num_classes: int, input_features: int = 256, *,
                 skip_connect: bool = True, skip_type: str = "concat",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        tch = input_features
        self.skip_connect = skip_connect
        self.skip_type = skip_type
        self.dtype = dtype
        if skip_connect:
            cat = skip_type == "concat"
            self.decoder_scale_1 = nn.Sequential(
                *(INSResBlock(tch, device=device) for _ in range(5)),
                ReLUINSConv2d(tch, tch // 2, device=device))
            self.decoder_scale_2 = nn.Sequential(
                ReLUINSConv2d(tch // 2 + (tch // 2 if cat else 0), tch // 2,
                              device=device),
                ReLUINSConv2d(tch // 2, tch // 4, device=device))
            self.decoder_scale_3 = nn.Sequential(
                ReLUINSConv2d(tch // 4 + (tch // 4 if cat else 0), tch // 4,
                              device=device),
                ReLUINSConv2d(tch // 4, tch // 4, device=device))
            self.decoder_scale_4 = nn.Sequential(
                ReLUINSConv2d(tch // 4, tch // 8, device=device))
        else:
            up = lambda cin, cout: nn.Sequential(
                nn.Upsample(scale_factor=2, mode="nearest"),
                ReLUINSConv2d(cin, cout, device=device))
            self.decoder_scale_1 = nn.Sequential(
                *(INSResBlock(tch, device=device) for _ in range(3)))
            self.decoder_scale_2 = up(tch, tch // 2)
            self.decoder_scale_3 = up(tch // 2, tch // 4)
            self.decoder_scale_4 = up(tch // 4, tch // 8)
        self.decoder_scale_5 = nn.Sequential(
            Conv2d(tch // 8, num_classes, 1, device=device))

    def forward(self, latent: Latent) -> Latent:
        x = latent[8].to(self.dtype)
        out: Latent = {8: latent[8]}
        x = self.decoder_scale_1(x)
        if self.skip_connect:
            x = skip_merge(self.skip_type, upsample2x_nearest(x), latent[4])
        x = self.decoder_scale_2(x)
        out[4] = x
        if self.skip_connect:
            x = skip_merge(self.skip_type, upsample2x_nearest(x), latent[2])
        x = self.decoder_scale_3(x)
        out[2] = x
        if self.skip_connect:
            x = upsample2x_nearest(x)
        x = self.decoder_scale_4(x)
        out[1] = self.decoder_scale_5(x)
        return out
