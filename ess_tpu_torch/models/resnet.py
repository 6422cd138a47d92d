"""ResNet18 grayscale image encoder, the sensor-A front of ESS UDA (NCHW).

Counterpart of ``ess_tpu/models/resnet.py`` (``BasicBlock``,
``ResNet18Encoder``; upstream ``StyleEncoderE2VID``): a 1-channel 7x7/2
stem with batch norm and ReLU and no max-pool, then ResNet18's layer1 at
scale 2 (``base_width`` channels), layer2 at scale 4 and layer3 at scale 8
(2x and 4x the width), two basic blocks each, the first block of layers 2
and 3 strided with a 1x1 projection. The output is a latent dict whose
channel counts match the E2VID latent, so both domains share one
segmentation head.

Parameter names are torchvision's resnet18 (``conv1``, ``bn1``,
``layer{1,2,3}.{0,1}.{conv1,bn1,conv2,bn2}``, ``downsample.{0,1}``), the
names of the upstream encoder's checkpoints. ``stem_impl='auto'`` (JAX's
default; the port's is ``'xla'``, the blocked form having measured slower
on the H100, ``train/builder.py::DEFAULT_FORMS``) evaluates the stem and
layer1 in 2x2 block space where H and W divide by 4: the 7x7/2 conv on the image's 4x4 blocks as a 3x3 block conv
that emits 2x2 blocks (``block_kernel(k=7, bi=4, bo=2, stride=2)``, 16 ->
4*width channels), the batch norms pooled over the subpixels, layer1's
convs as 3x3 block convs, and one depth-to-space at the end; ``'xla'``
runs the plain convolutions. Same parameters, same function.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ess_tpu_torch.models.layers import BatchNorm2d, BlockConv, Conv2d
from ess_tpu_torch.ops.conv_s2d import depth_to_space, space_to_depth4

Latent = Dict[int, torch.Tensor]
STEM_IMPLS = ("auto", "xla")   # ResNet18Encoder.stem_impl


class BasicBlock(nn.Module):
    """relu(bn2(conv2(relu(bn1(conv1(x))))) + skip): two 3x3 convs without
    bias; the skip is x, or a 1x1 projection with batch norm
    (``downsample``) when the block strides or changes the width.
    ``block_space`` (stride-1 identity blocks): x and the output in 2x2
    space-to-depth form, both convs as block convs and the batch norms
    pooled over the subpixels."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1, *,
                 device=None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride, padding=1,
                            bias=False, device=device)
        self.bn1 = BatchNorm2d(channels, device=device)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=False,
                            device=device)
        self.bn2 = BatchNorm2d(channels, device=device)
        self.downsample = None
        if stride != 1 or in_channels != channels:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, channels, 1, stride, bias=False,
                       device=device),
                BatchNorm2d(channels, device=device))
        self._blocked = (BlockConv(self.conv1, None), BlockConv(self.conv2,
                                                                None))

    def forward(self, x: torch.Tensor, train: bool = False,
                block_space: bool = False) -> torch.Tensor:
        if block_space:
            if self.downsample is not None:
                raise ValueError("the blocked basic block takes stride-1 "
                                 "identity blocks")
            conv1, conv2 = self._blocked
            y = torch.relu(self.bn1(conv1(x), train, 2))
            return torch.relu(self.bn2(conv2(y), train, 2) + x)
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        skip = x
        if self.downsample is not None:
            skip = self.downsample[1](self.downsample[0](x), train)
        return torch.relu(y + skip)


class ResNet18Encoder(nn.Module):
    """Grayscale ResNet18 trunk. ``forward(x, train)`` takes (B, 1, H, W)
    images and returns {1: x, 2, 4, 8: features} (2 and 4 only with
    ``skip_connect``), computed in ``dtype`` with f32 parameters; ``train``
    normalizes with batch statistics and updates the running ones.
    ``stem_impl``: ``'auto'`` or ``'xla'`` (module docstring)."""

    def __init__(self, *, base_width: int = 64, skip_connect: bool = True,
                 stem_impl: str = "xla",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if stem_impl not in STEM_IMPLS:
            raise ValueError(f"unknown stem_impl {stem_impl!r}; use one of "
                             f"{STEM_IMPLS}")
        self.stem_impl = stem_impl
        w = base_width
        self.skip_connect = skip_connect
        self.dtype = dtype
        self.conv1 = Conv2d(1, w, 7, 2, padding=3, bias=False, device=device)
        self.bn1 = BatchNorm2d(w, device=device)
        self.layer1 = nn.ModuleList(
            BasicBlock(w, w, device=device) for _ in range(2))
        self.layer2 = nn.ModuleList(
            [BasicBlock(w, 2 * w, 2, device=device),
             BasicBlock(2 * w, 2 * w, device=device)])
        self.layer3 = nn.ModuleList(
            [BasicBlock(2 * w, 4 * w, 2, device=device),
             BasicBlock(4 * w, 4 * w, device=device)])
        self._stem_blocked = BlockConv(self.conv1, None, in_block=4)

    def blocked(self, x: torch.Tensor) -> bool:
        """Whether ``forward`` runs the stem and layer1 in block space."""
        return (self.stem_impl == "auto" and x.shape[2] % 4 == 0
                and x.shape[3] % 4 == 0)

    def forward(self, x: torch.Tensor, train: bool = False) -> Latent:
        out: Latent = {1: x}
        h = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        blocked = self.blocked(h)
        if blocked:   # the scale-2 trunk in 2x2 blocks
            h = self._stem_blocked(space_to_depth4(h).contiguous(
                memory_format=torch.channels_last))
            h = torch.relu(self.bn1(h, train, 2))
            for block in self.layer1:
                h = block(h, train, block_space=True)
            h = depth_to_space(h).contiguous(
                memory_format=torch.channels_last)
        else:
            h = torch.relu(self.bn1(self.conv1(h), train))
        for scale, layer in ((2, self.layer1), (4, self.layer2),
                             (8, self.layer3)):
            if not (blocked and scale == 2):
                for block in layer:
                    h = block(h, train)
            if self.skip_connect or scale == 8:
                out[scale] = h
        return out
