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
names of the upstream encoder's checkpoints. The JAX package evaluates the
stem and layer1 in 2x2 block space where H and W divide by 4, an exact
remap of the same parameters for the TPU's matrix unit; here they are
plain convolutions, the same function.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ess_tpu_torch.models.layers import BatchNorm2d, Conv2d

Latent = Dict[int, torch.Tensor]


class BasicBlock(nn.Module):
    """relu(bn2(conv2(relu(bn1(conv1(x))))) + skip): two 3x3 convs without
    bias; the skip is x, or a 1x1 projection with batch norm
    (``downsample``) when the block strides or changes the width."""

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
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
    normalizes with batch statistics and updates the running ones."""

    def __init__(self, *, base_width: int = 64, skip_connect: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
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

    def forward(self, x: torch.Tensor, train: bool = False) -> Latent:
        out: Latent = {1: x}
        h = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        h = torch.relu(self.bn1(self.conv1(h), train))
        for scale, layer in ((2, self.layer1), (4, self.layer2),
                             (8, self.layer3)):
            for block in layer:
                h = block(h, train)
            if self.skip_connect or scale == 8:
                out[scale] = h
        return out
