"""E2VID recurrent UNet (NCHW).

Counterpart of ``ess_tpu/models/e2vid.py`` (``RecurrentUNet``,
``zero_recurrent_state``): head 5x5 conv -> ``num_encoders`` x (stride-2 5x5
conv + ConvLSTM or ConvGRU cell) -> residual blocks -> bilinear-upsample
decoders with skip merges -> 1x1 prediction + sigmoid, every layer but the
head with the model's ``norm`` (None or ``'IN'``) before its activation.
The latent dict maps downsample factor to feature (1 = head, 2**(i+1) =
encoder i), as upstream ``unet.py`` does.

With ``block_input`` the window arrives as 2x2 space-to-depth blocks
(:func:`ess_tpu_torch.ops.conv_s2d.space_to_depth`) and the head conv and
the first encoder's stride-2 conv run as exact 3x3 convs in block space, on
the library conv or on the fused conv kernel (``block_conv_impl``); the
full-resolution head activation exists only on decode windows. Same
parameters, same function.

Activations and recurrent state live in channels-last memory: the kernels
read NHWC, and cuDNN runs bf16 convolutions natively in that layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ess_tpu_torch import resolve_device
from ess_tpu_torch.models.layers import (
    BLOCK_CONV_IMPLS, ConvLayer, RecurrentConvLayer, ResidualBlock,
    UpsampleConvLayer, skip_merge)
from ess_tpu_torch.ops.conv_lstm import resolve_lstm_impl
from ess_tpu_torch.ops.conv_s2d import depth_to_space

Latent = Dict[int, torch.Tensor]
# one entry per encoder: (h, c) of a ConvLSTM cell, h of a ConvGRU cell
State = Tuple[Union[Tuple[torch.Tensor, torch.Tensor], torch.Tensor], ...]


def zero_recurrent_state(batch: int, height: int, width: int, *,
                         num_encoders: int = 3, base_channels: int = 32,
                         recurrent_block: str = "convlstm",
                         dtype: torch.dtype = torch.float32,
                         device=None) -> State:
    """Zero state per encoder for a (height, width) input, channels-last,
    on ``device`` (None: the first CUDA device; raises where there is
    none): (h, c) for ``'convlstm'``, distinct buffers (the CUDA cell
    updates c in place), h alone for ``'convgru'``."""
    device = resolve_device(device)
    states = []
    h, w = height, width
    for i in range(num_encoders):
        h, w = h // 2, w // 2
        shape = (batch, base_channels * 2 ** (i + 1), h, w)
        zeros = lambda: torch.zeros(
            shape, dtype=dtype, device=device).contiguous(
                memory_format=torch.channels_last)
        states.append((zeros(), zeros()) if recurrent_block == "convlstm"
                      else zeros())
    return tuple(states)


class RecurrentUNet(nn.Module):
    """E2VID recurrent UNet; ``forward`` returns (image or None, new states,
    latent)."""

    def __init__(self, *, in_channels: int = 5, base_channels: int = 32,
                 num_encoders: int = 3, num_residual_blocks: int = 2,
                 num_output_channels: int = 1, skip_type: str = "sum",
                 recurrent_block: str = "convlstm",
                 norm: Optional[str] = None,
                 lstm_impl: str = "pallas", block_conv_impl: str = "xla",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.lstm_impl = resolve_lstm_impl(lstm_impl)
        if block_conv_impl not in BLOCK_CONV_IMPLS:
            raise ValueError(f"unknown block_conv_impl {block_conv_impl!r}; "
                             f"expected one of {BLOCK_CONV_IMPLS}")
        self.block_conv_impl = block_conv_impl
        self.base_channels = base_channels
        self.num_encoders = num_encoders
        self.skip_type = skip_type
        self.recurrent_block = recurrent_block
        self.norm = norm
        self.dtype = dtype
        self.head = ConvLayer(in_channels, base_channels, 5, 1, "relu",
                              device=device)
        self.encoders = nn.ModuleList(
            RecurrentConvLayer(base_channels * 2 ** i,
                               base_channels * 2 ** (i + 1),
                               recurrent_block=recurrent_block, norm=norm,
                               device=device)
            for i in range(num_encoders))
        top = base_channels * 2 ** num_encoders
        self.resblocks = nn.ModuleList(
            ResidualBlock(top, norm=norm, device=device)
            for _ in range(num_residual_blocks))
        cat = 2 if skip_type == "concat" else 1
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(cat * base_channels * 2 ** (num_encoders - i),
                              base_channels * 2 ** (num_encoders - i) // 2,
                              5, "relu", norm=norm, device=device)
            for i in range(num_encoders))
        self.pred = ConvLayer(cat * base_channels, num_output_channels, 1, 1,
                              "sigmoid", norm=norm, device=device)

    def forward(self, x: torch.Tensor, states: Sequence, *,
                decode: bool = True, lstm_impl: Optional[str] = None,
                block_input: bool = False,
                block_conv_impl: Optional[str] = None
                ) -> Tuple[Optional[torch.Tensor], State, Latent]:
        """One event window (B, C, H, W). ``decode=False`` runs only the head
        and the recurrent encoders (state update + latent) and returns
        ``(None, states, latent)``: only the last window of a rollout is
        decoded. ``lstm_impl`` (a resolved cell name) overrides the model's
        ConvLSTM cell for this call, as JAX's ``e2vid.clone(lstm_impl=...)``
        does over the same parameters; a ConvGRU model ignores it.

        ``block_input``: ``x`` is the space-to-depth window
        (B, 4C, H/2, W/2); the head conv and the first encoder's conv run in
        block space on ``block_conv_impl`` (None: the model's); a model with
        a norm has no block form. The
        full-resolution head activation, ``latent[1]``, is built only
        where it is consumed: with ``decode=False`` the latent has no entry
        1 (eager PyTorch drops no unused work)."""
        impl = self.lstm_impl if lstm_impl is None else lstm_impl
        bimpl = (self.block_conv_impl if block_conv_impl is None
                 else block_conv_impl)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        latent: Latent = {}
        if block_input:
            h = self.head(x, True, bimpl)
            head = depth_to_space(h) if decode else None
        else:
            h = head = self.head(x)
        if head is not None:
            latent[1] = head
        blocks = []
        new_states = []
        for i, enc in enumerate(self.encoders):
            h, st = enc(h, states[i], impl, block_input and i == 0, bimpl)
            new_states.append(st)
            blocks.append(h)
            latent[2 ** (i + 1)] = h
        if not decode:
            return None, tuple(new_states), latent
        for rb in self.resblocks:
            h = rb(h)
        for i, dec in enumerate(self.decoders):
            h = dec(skip_merge(self.skip_type, h,
                               blocks[self.num_encoders - i - 1]))
        img = self.pred(skip_merge(self.skip_type, h, head))
        return img.float(), tuple(new_states), latent
