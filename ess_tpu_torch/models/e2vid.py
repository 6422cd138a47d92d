"""E2VID model family (NCHW).

Counterpart of ``ess_tpu/models/e2vid.py`` (``RecurrentUNet``, ``UNet``,
``UNetDecoder``, ``UNetTaskDecoder``, ``zero_recurrent_state``). The
recurrent UNet: head 5x5 conv -> ``num_encoders`` x (stride-2 5x5 conv +
ConvLSTM or ConvGRU cell) -> residual blocks -> decoders with skip merges
-> 1x1 prediction + ``final_activation`` (sigmoid by default), every layer
but the head with the model's ``norm`` (None or ``'IN'``) before its
activation. The decoders are bilinear-upsample convs
(``use_upsample_conv``, the default) or stride-2 transposed convs
(``layers.py::TransposedConvLayer``). The latent dict maps downsample
factor to feature (1 = head, 2**(i+1) = encoder i), as upstream
``unet.py`` does. :class:`UNet` is the plain (non-recurrent) net;
:class:`UNetDecoder` decodes an image and :class:`UNetTaskDecoder` class
logits at four scales from a latent dict made elsewhere.

With ``block_input`` the window arrives as 2x2 space-to-depth blocks
(:func:`ess_tpu_torch.ops.conv_s2d.space_to_depth`) and the head conv and
the first encoder's stride-2 conv run as exact 3x3 convs in block space, on
the library conv or on the fused conv kernel (``block_conv_impl``); the
full-resolution head activation exists only on decode windows. With
``quad_block`` (JAX's opt-in quad-block rollout) the window arrives as 4x4
blocks (``space_to_depth4``): the head runs at quarter resolution (80 ->
512 channels at 5 bins and base 32), the first encoder's conv lands in 2x2
blocks (512 -> 256), its ConvLSTM cell runs on space-to-depth state
(``state_block=2``) and the second encoder's conv reads that s2d hidden
state in block form (256 -> 128). In the standard layout the head conv
takes ``head_conv_impl`` (``ConvLayer.conv_impl``, JAX's ``'auto'`` by
default), and the decoders' post-upsample convs ``decoder_conv_impl``
(``UpsampleConvLayer``; ``'xla'`` by default, where JAX's is ``'auto'``:
the blocked form measured slower on the H100, ``train/builder.py::
DEFAULT_FORMS``). Same parameters, same function in every form.

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
    TransposedConvLayer, UpsampleConvLayer, skip_merge)
from ess_tpu_torch.ops.conv_lstm import resolve_lstm_impl
from ess_tpu_torch.ops.conv_s2d import depth_to_space, depth_to_space4

Latent = Dict[int, torch.Tensor]
# one entry per encoder: (h, c) of a ConvLSTM cell, h of a ConvGRU cell
State = Tuple[Union[Tuple[torch.Tensor, torch.Tensor], torch.Tensor], ...]


def zero_recurrent_state(batch: int, height: int, width: int, *,
                         num_encoders: int = 3, base_channels: int = 32,
                         recurrent_block: str = "convlstm",
                         quad_block: bool = False,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> State:
    """Zero state per encoder for a (height, width) input, channels-last,
    on ``device`` (None: the first CUDA device; raises where there is
    none): (h, c) for ``'convlstm'``, distinct buffers (the CUDA cell
    updates c in place), h alone for ``'convgru'``. ``quad_block``: the
    first encoder's state in 2x2 space-to-depth form (B, 4C, H/4, W/4),
    the quad-block rollout's layout."""
    device = resolve_device(device)
    states = []
    h, w = height, width
    for i in range(num_encoders):
        h, w = h // 2, w // 2
        c = base_channels * 2 ** (i + 1)
        shape = ((batch, 4 * c, h // 2, w // 2) if quad_block and i == 0
                 else (batch, c, h, w))
        zeros = lambda: torch.zeros(
            shape, dtype=dtype, device=device).contiguous(
                memory_format=torch.channels_last)
        states.append((zeros(), zeros()) if recurrent_block == "convlstm"
                      else zeros())
    return tuple(states)


def decoder_stack(base_channels: int, num_encoders: int, skip_type: str,
                  norm: Optional[str], use_upsample_conv: bool,
                  decoder_conv_impl: str, device) -> nn.ModuleList:
    """The E2VID decoders: per scale from the deepest, a skip merge's
    channels -> half the scale's features, bilinear-upsample conv
    (``use_upsample_conv``) or stride-2 transposed conv."""
    cat = 2 if skip_type == "concat" else 1
    decs = []
    for i in range(num_encoders):
        feats = base_channels * 2 ** (num_encoders - i)
        if use_upsample_conv:
            decs.append(UpsampleConvLayer(cat * feats, feats // 2, 5, "relu",
                                          norm=norm,
                                          conv_impl=decoder_conv_impl,
                                          device=device))
        else:
            decs.append(TransposedConvLayer(cat * feats, feats // 2, 5,
                                            "relu", norm=norm,
                                            device=device))
    return nn.ModuleList(decs)


class RecurrentUNet(nn.Module):
    """E2VID recurrent UNet; ``forward`` returns (image or None, new states,
    latent)."""

    def __init__(self, *, in_channels: int = 5, base_channels: int = 32,
                 num_encoders: int = 3, num_residual_blocks: int = 2,
                 num_output_channels: int = 1, skip_type: str = "sum",
                 recurrent_block: str = "convlstm",
                 norm: Optional[str] = None,
                 use_upsample_conv: bool = True,
                 final_activation: Optional[str] = "sigmoid",
                 lstm_impl: str = "pallas", block_conv_impl: str = "xla",
                 head_conv_impl: str = "auto",
                 decoder_conv_impl: str = "xla", quad_block: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if quad_block and recurrent_block != "convlstm":
            raise ValueError("the quad-block rollout needs ConvLSTM cells")
        self.quad_block = quad_block
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
                              conv_impl=head_conv_impl, device=device)
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
        self.decoders = decoder_stack(base_channels, num_encoders, skip_type,
                                      norm, use_upsample_conv,
                                      decoder_conv_impl, device)
        self.pred = ConvLayer(cat * base_channels, num_output_channels, 1, 1,
                              final_activation, norm=norm, device=device)

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
        (B, 4C, H/2, W/2), or with ``quad_block`` the 4x4 one (B, 16C, H/4,
        W/4); the head conv and the first encoder's conv (with
        ``quad_block`` also the second's) run in block space on
        ``block_conv_impl`` (None: the model's); a model with a norm has no
        block form. The first encoder's state then lies in s2d form, and
        its hidden state reaches the decoder skips and the latent
        depth-to-spaced. The
        full-resolution head activation, ``latent[1]``, is built only
        where it is consumed: with ``decode=False`` the latent has no entry
        1 (eager PyTorch drops no unused work)."""
        impl = self.lstm_impl if lstm_impl is None else lstm_impl
        bimpl = (self.block_conv_impl if block_conv_impl is None
                 else block_conv_impl)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        latent: Latent = {}
        quad = block_input and self.quad_block
        if block_input:
            h = self.head(x, 4 if quad else True, bimpl)
            head = ((depth_to_space4 if quad else depth_to_space)(h)
                    if decode else None)
        else:
            h = head = self.head(x)
        if head is not None:
            latent[1] = head
        blocks = []
        new_states = []
        for i, enc in enumerate(self.encoders):
            if quad:
                bs = 4 if i == 0 else (True if i == 1 else False)
            else:
                bs = block_input and i == 0
            h, st = enc(h, states[i], impl, bs, bimpl)
            new_states.append(st)
            # the s2d hidden state of a quad level 0 feeds the next block
            # conv as it is; skips and latent take the standard layout
            h_std = depth_to_space(h) if bs == 4 else h
            blocks.append(h_std)
            latent[2 ** (i + 1)] = h_std
        if not decode:
            return None, tuple(new_states), latent
        h = blocks[-1]
        for rb in self.resblocks:
            h = rb(h)
        for i, dec in enumerate(self.decoders):
            h = dec(skip_merge(self.skip_type, h,
                               blocks[self.num_encoders - i - 1]))
        img = self.pred(skip_merge(self.skip_type, h, head))
        return img.float(), tuple(new_states), latent


class UNet(nn.Module):
    """Plain (non-recurrent) E2VID UNet: head 5x5 conv -> ``num_encoders``
    stride-2 5x5 convs -> residual blocks -> decoders with skip merges ->
    1x1 prediction + ``final_activation``; ``forward(x)`` returns the
    (B, out, H, W) f32 image. The encoders, residual blocks and decoders
    take ``norm``; the head and the prediction have none, as JAX's."""

    def __init__(self, *, in_channels: int = 5, base_channels: int = 32,
                 num_encoders: int = 3, num_residual_blocks: int = 2,
                 num_output_channels: int = 1, skip_type: str = "sum",
                 norm: Optional[str] = None, use_upsample_conv: bool = True,
                 final_activation: Optional[str] = "sigmoid",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_encoders = num_encoders
        self.skip_type = skip_type
        self.dtype = dtype
        self.head = ConvLayer(in_channels, base_channels, 5, 1, "relu",
                              device=device)
        self.encoders = nn.ModuleList(
            ConvLayer(base_channels * 2 ** i, base_channels * 2 ** (i + 1),
                      5, 2, "relu", norm=norm, device=device)
            for i in range(num_encoders))
        top = base_channels * 2 ** num_encoders
        self.resblocks = nn.ModuleList(
            ResidualBlock(top, norm=norm, device=device)
            for _ in range(num_residual_blocks))
        self.decoders = decoder_stack(base_channels, num_encoders, skip_type,
                                      norm, use_upsample_conv,
                                      "xla", device)
        cat = 2 if skip_type == "concat" else 1
        self.pred = ConvLayer(cat * base_channels, num_output_channels, 1, 1,
                              final_activation, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        head = h = self.head(x)
        blocks = []
        for enc in self.encoders:
            h = enc(h)
            blocks.append(h)
        for rb in self.resblocks:
            h = rb(h)
        for i, dec in enumerate(self.decoders):
            h = dec(skip_merge(self.skip_type, h,
                               blocks[self.num_encoders - i - 1]))
        return self.pred(skip_merge(self.skip_type, h, head)).float()


class _LatentDecoder(nn.Module):
    """The residual blocks and decoders over a latent dict {1, 2, ...,
    2**num_encoders} that :class:`UNetDecoder` and
    :class:`UNetTaskDecoder` share."""

    def __init__(self, base_channels: int, num_encoders: int,
                 num_residual_blocks: int, skip_type: str,
                 norm: Optional[str], use_upsample_conv: bool,
                 dtype: torch.dtype, device):
        super().__init__()
        self.num_encoders = num_encoders
        self.skip_type = skip_type
        self.dtype = dtype
        top = base_channels * 2 ** num_encoders
        self.resblocks = nn.ModuleList(
            ResidualBlock(top, norm=norm, device=device)
            for _ in range(num_residual_blocks))
        self.decoders = decoder_stack(base_channels, num_encoders, skip_type,
                                      norm, use_upsample_conv,
                                      "xla", device)

    def _decode(self, latent: Latent):
        """Yield the features after each decoder, then the last one merged
        with ``latent[1]``."""
        n = self.num_encoders
        lat = lambda s: latent[s].to(self.dtype).contiguous(  # noqa: E731
            memory_format=torch.channels_last)
        h = lat(2 ** n)
        for rb in self.resblocks:
            h = rb(h)
        for i, dec in enumerate(self.decoders):
            h = dec(skip_merge(self.skip_type, h, lat(2 ** (n - i))))
            yield h
        yield skip_merge(self.skip_type, h, lat(1))


class UNetDecoder(_LatentDecoder):
    """Decoder-only E2VID (upstream ``UNetDecoder`` / ``E2VIDDecoder``):
    ``forward(latent)`` decodes a latent dict made elsewhere into the
    (B, out, H, W) f32 image."""

    def __init__(self, *, base_channels: int = 32, num_encoders: int = 3,
                 num_residual_blocks: int = 2, num_output_channels: int = 1,
                 skip_type: str = "sum", norm: Optional[str] = None,
                 use_upsample_conv: bool = True,
                 final_activation: Optional[str] = "sigmoid",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(base_channels, num_encoders, num_residual_blocks,
                         skip_type, norm, use_upsample_conv, dtype,
                         device)
        cat = 2 if skip_type == "concat" else 1
        self.pred = ConvLayer(cat * base_channels, num_output_channels, 1, 1,
                              final_activation, device=device)

    def forward(self, latent: Latent) -> torch.Tensor:
        *_, h = self._decode(latent)
        return self.pred(h).float()


class UNetTaskDecoder(_LatentDecoder):
    """Multi-scale segmentation decoder over the E2VID latent dict (JAX's
    ``UNetTaskDecoder``, upstream ``UNetTask``): ``forward(latent)``
    returns {2**n: latent[2**n], 2**(n-1): feature, ..., 1: class logits
    (B, classes, H, W) f32}. Where upstream feeds a zero head at full
    scale, the real ``latent[1]`` is merged, as in JAX."""

    def __init__(self, num_classes: int, *, base_channels: int = 32,
                 num_encoders: int = 3, num_residual_blocks: int = 2,
                 skip_type: str = "sum", norm: Optional[str] = None,
                 use_upsample_conv: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(base_channels, num_encoders, num_residual_blocks,
                         skip_type, norm, use_upsample_conv, dtype,
                         device)
        cat = 2 if skip_type == "concat" else 1
        self.pred_hidden = ConvLayer(cat * base_channels, base_channels, 1,
                                     1, "relu", device=device)
        self.pred = ConvLayer(base_channels, num_classes, 1, 1, None,
                              device=device)

    def forward(self, latent: Latent) -> Latent:
        n = self.num_encoders
        out: Latent = {2 ** n: latent[2 ** n]}
        *feats, h = self._decode(latent)
        for i, f in enumerate(feats):
            out[2 ** (n - i - 1)] = f
        out[1] = self.pred(self.pred_hidden(h)).float()
        return out
