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

with C = ``input_features``. ``forward``'s two other evaluations of the
skip-connect head are JAX's, over the same parameters:

- ``fused_final``: the scale-1 stage's nearest-2x upsample folded into
  its conv (``ReLUINSConv2d(up2x_fused=True)``, instance norm pooled over
  the four parities) and the 1x1 class conv on the parity pseudo-pixels:
  ``out[1]`` comes as (B, classes, H/2, 2W) in (j, r, s) order along the
  width, the layout of ``train/losses.py::fold_labels_up2x`` (also in the
  plain head);
- ``block_space``: the scale-2 stage in 2x2 blocks (the skip concat as
  segments, ``in_segments``) and the scale-1 stage in 4x4 blocks, with the
  upsamples as channel broadcasts: ``out[2]`` in s2d and ``out[1]`` in s4d
  layout (``s4d_logits_class_minor``, ``fold_labels_s4d``).

Module names are upstream's
(``decoder_scale_1.{i}`` ... ``decoder_scale_5.0``; in the plain head the
upsample of a scale is its parameterless ``.0``). The plain head's
``input_index_map`` appends two coordinate channels to latent[8], its row
index i and its column index j in the head's dtype, before the residual
blocks (which then run at C + 2 channels), as JAX's does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ess_tpu_torch.models.layers import (
    BlockConv, Conv2d, INSResBlock, ReLUINSConv2d, skip_merge,
    upsample2x_nearest)
from ess_tpu_torch.ops.conv_s2d import (
    space_to_depth, tile_upsample2x_s2d, tile_upsample2x_s2d_to_s4d)

Latent = Dict[int, torch.Tensor]


class SegmentationHead(nn.Module):
    """Multi-scale segmentation decoder; ``forward(latent)`` returns
    {8: latent[8], 4: feature, 2: feature, 1: logits (B, classes, H, W)}."""

    def __init__(self, num_classes: int, input_features: int = 256, *,
                 skip_connect: bool = True, skip_type: str = "concat",
                 input_index_map: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        tch = input_features
        # an option of the plain head; the skip-connect head ignores it
        self.input_index_map = input_index_map and not skip_connect
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
            cin = tch + (2 if input_index_map else 0)
            self.decoder_scale_1 = nn.Sequential(
                *(INSResBlock(cin, device=device) for _ in range(3)))
            self.decoder_scale_2 = up(cin, tch // 2)
            self.decoder_scale_3 = up(tch // 2, tch // 4)
            self.decoder_scale_4 = up(tch // 4, tch // 8)
        self.decoder_scale_5 = nn.Sequential(
            Conv2d(tch // 8, num_classes, 1, device=device))
        self._logits_s4d = BlockConv(self.decoder_scale_5[0], None,
                                     in_block=4)

    def forward(self, latent: Latent, *, block_space: bool = False,
                fused_final: bool = False) -> Latent:
        if block_space and (fused_final or not self.skip_connect):
            raise ValueError("block_space takes the skip-connect head and "
                             "no fused_final")
        x = latent[8].to(self.dtype)
        out: Latent = {8: latent[8]}
        if self.input_index_map:
            n, _, h, w = x.shape
            ii = torch.arange(h, dtype=x.dtype, device=x.device)
            jj = torch.arange(w, dtype=x.dtype, device=x.device)
            x = torch.cat([x, ii[None, None, :, None].expand(n, 1, h, w),
                           jj[None, None, None, :].expand(n, 1, h, w)], 1)
        x = self.decoder_scale_1(x)
        if self.skip_connect:
            x = skip_merge(self.skip_type, upsample2x_nearest(x), latent[4])
        x = self.decoder_scale_2(x)
        out[4] = x
        if block_space:
            return self._blocked_tail(x, latent, out)
        if self.skip_connect:
            x = skip_merge(self.skip_type, upsample2x_nearest(x), latent[2])
        x = self.decoder_scale_3(x)
        out[2] = x
        if fused_final:
            x = self.decoder_scale_4[-1](x, up2x_fused=True)  # (B, 4C, h, w)
            b, c4, h, w = x.shape
            x = x.reshape(b, 4, c4 // 4, h, w).permute(0, 2, 3, 4, 1)
            # the 1x1 class conv on the parity pseudo-pixels (JAX's
            # _PointwiseConv): (B, C, h, 4w) in (j, r, s) order
            out[1] = self.decoder_scale_5(x.reshape(b, c4 // 4, h, 4 * w))
            return out
        if self.skip_connect:
            x = upsample2x_nearest(x)
        x = self.decoder_scale_4(x)
        out[1] = self.decoder_scale_5(x)
        return out

    def _blocked_tail(self, x, latent: Latent, out: Latent) -> Latent:
        """Scales 2 and 1 of the skip-connect head in 2x2 and 4x4 blocks."""
        cx, cs = x.shape[1], latent[2].shape[1]
        x = tile_upsample2x_s2d(x)                    # s2d of up2x(out[4])
        skip = space_to_depth(latent[2].to(x.dtype))
        segs = None
        if self.skip_type == "sum":
            x = x + skip
        else:
            x = torch.cat([x, skip], dim=1)
            segs = (cx, cs)
        s3_a, s3_b = self.decoder_scale_3
        x = s3_a(x, block_space=2, in_segments=segs)
        x = s3_b(x, block_space=2)
        out[2] = x                                    # s2d layout
        x = tile_upsample2x_s2d_to_s4d(x)             # s4d of up2x(out[2])
        x = self.decoder_scale_4[-1](x, block_space=4)
        out[1] = self._logits_s4d(x)                  # s4d layout
        return out
