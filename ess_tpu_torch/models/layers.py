"""Layer primitives of the E2VID backbone and the segmentation head (NCHW).

Counterpart of ``ess_tpu/models/layers.py`` (``ConvLayer`` with its
block-space form ``_BlockConv`` at ``in_block=2``, ``ResidualBlock``,
``UpsampleConvLayer``, ``ConvLSTMCell``, ``ConvGRUCell``,
``RecurrentConvLayer``, ``ReLUINSConv2d``, ``INSResBlock``,
``upsample2x_nearest``, ``skip_merge``, ``TorchBatchNorm`` as
:class:`BatchNorm2d`, ``instance_norm``). The E2VID
layers take the JAX package's ``norm``: None or ``'IN'`` (instance norm
without affine parameters, eps 1e-5, before the activation); ``'BN'``
raises (:func:`check_norm`). The JAX
package's im2col, decoder and quad-block space-to-depth variants compute
the same functions with remapped weights; a plain convolution is the same
function here.

Submodule names follow upstream ESS/E2VID (``conv2d``,
``recurrent_block.Gates``, ``recurrent_block.{reset,update,out}_gate``,
``conv1``/``conv2``, ``model.<i>``), so a
module's ``state_dict`` is a reference-format checkpoint. Parameters stay
float32; every conv casts them to its input's dtype, the JAX package's
mixed-precision rule (bf16 compute, f32 params).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ess_tpu_torch.ops.conv3x3 import (
    IMPLS as BLOCK_CONV_IMPLS, conv3x3_fused, prepare_conv_weights)
from ess_tpu_torch.ops.conv_lstm import (
    conv_lstm_cell, int8_route, prepare_cell_weights)
from ess_tpu_torch.ops.conv_s2d import block_bias, block_kernel
from ess_tpu_torch.parallel import dp

_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                None: lambda x: x}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias follow the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm of the image front, the counterpart of JAX
    ``TorchBatchNorm``: eps 1e-5, momentum 0.1 (flax's 0.9), batch
    statistics with the biased variance and ``running_var`` updated with
    the unbiased one, as torch does. It normalizes in f32 with its f32
    parameters and casts back to the input's dtype; ``train`` picks batch
    statistics (and updates the running ones) or the running ones; under
    data parallel the batch statistics are the global batch's."""

    def __init__(self, num_features: int, *, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            self.num_batches_tracked.add_(1)
            if dp.world() > 1:
                return self._global_batch_norm(x)
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, train, self.momentum,
                         self.eps)
        return y.to(x.dtype)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode under data parallel: the statistics of the global
        batch (``dp.all_sum`` of the ranks' sums, mean first, then the
        biased variance about it), and the running ones updated with them
        on every rank alike."""
        xf = x.float()
        n = math.prod(dp.global_shape(x.shape)) // x.shape[1]
        mean = dp.all_sum(xf.sum((0, 2, 3))) / n
        centered = xf - mean[None, :, None, None]
        var = dp.all_sum((centered * centered).sum((0, 2, 3))) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(
                m * var.detach() * (n / max(n - 1, 1)))
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = centered * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear, half-pixel centers (align_corners=False), edge-clamped."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def skip_merge(kind: str, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """'sum' or 'concat' skip connection."""
    if kind == "sum":
        return x + skip.to(x.dtype)
    return torch.cat([x, skip.to(x.dtype)], dim=1)


class BlockConv:
    """A 5x5 conv (stride 1 or 2) + activation evaluated on a 2x2
    space-to-depth input, the JAX ``_BlockConv`` at ``in_block=2``. It owns
    no parameters: it reads the (C_out, C_in, 5, 5) weight and the bias of
    ``conv`` and remaps them to an exact 3x3 block conv at apply time
    (:func:`ess_tpu_torch.ops.conv_s2d.block_kernel`), so checkpoints do not
    change. Stride 1 gives the output in 2x2 blocks too, stride 2 at half
    resolution unblocked.

    ``impl``: ``'xla'`` is the library conv rounded to the input's dtype,
    then bias and activation; ``'pallas'`` and ``'pallas_int8'`` (the
    exact conv below the JAX package's int8 size rule, ``int8_route``) run
    :func:`ess_tpu_torch.ops.conv3x3.conv3x3_fused` with the bias and a ReLU
    fused. While the parameters need no gradient, the remapped weights (cast
    for ``'xla'``, kernel-ready for the others on CUDA) are kept per
    ``impl`` and dtype and rebuilt only when a parameter changes."""

    def __init__(self, conv: nn.Conv2d, activation: Optional[str]):
        if conv.kernel_size != (5, 5) or conv.stride[0] not in (1, 2):
            raise ValueError("the block-space form takes 5x5 convs of "
                             f"stride 1 or 2, got {conv}")
        self.conv = conv
        self.stride = conv.stride[0]
        self.activation = activation
        self._cache: Dict[tuple, Tuple[tuple, tuple]] = {}

    def _remap(self, weight, bias):
        bo = 2 // self.stride
        w2 = block_kernel(weight, bi=2, bo=bo, stride=self.stride)
        return w2, None if bias is None else block_bias(bias, bo)

    def _frozen_weights(self, impl: str, dtype: torch.dtype):
        w, b = self.conv.weight, self.conv.bias
        key = (w.data_ptr(), w._version, w.device,
               None if b is None else (b.data_ptr(), b._version))
        hit = self._cache.get((impl, dtype))
        if hit is None or hit[0] != key:
            with torch.no_grad():
                w2, b2 = self._remap(w.detach(),
                                     None if b is None else b.detach())
                prepared = None
                if impl == "xla":
                    w2 = w2.to(dtype)
                    b2 = None if b2 is None else b2.to(dtype)
                elif w.device.type == "cuda":
                    prepared = prepare_conv_weights(
                        w2, int8=impl == "pallas_int8")
            hit = (key, (w2, b2, prepared))
            self._cache[(impl, dtype)] = hit
        return hit[1]

    def __call__(self, x_blk: torch.Tensor, impl: str = "xla"
                 ) -> torch.Tensor:
        if impl not in BLOCK_CONV_IMPLS:
            raise ValueError(f"unknown block_conv_impl {impl!r}; expected "
                             f"one of {BLOCK_CONV_IMPLS}")
        w, b = self.conv.weight, self.conv.bias
        if torch.is_grad_enabled() and (
                w.requires_grad or (b is not None and b.requires_grad)):
            (w2, b2), prepared = self._remap(w, b), None
        else:   # prepared for the conv this shape runs
            w2, b2, prepared = self._frozen_weights(
                int8_route(impl, x_blk.shape), x_blk.dtype)
        if impl == "xla":
            out = F.conv2d(x_blk, w2.to(x_blk.dtype),
                           None if b2 is None else b2.to(x_blk.dtype),
                           padding=1)
            return _ACTIVATIONS[self.activation](out)
        fuse_relu = self.activation == "relu"
        out = conv3x3_fused(x_blk, w2, b2, relu=fuse_relu, impl=impl,
                            prepared=prepared)
        return out if fuse_relu else _ACTIVATIONS[self.activation](out)


NORMS = (None, "IN")   # the E2VID norms the port runs


def check_norm(norm: Optional[str]) -> None:
    """Raise unless the port runs ``norm``. The JAX package builds
    ``'BN'`` but cannot roll it out: its batch norms read a
    ``batch_stats`` collection that ``init_state`` does not keep (flax
    raises ``ScopeCollectionNotFound``), so the port refuses it here."""
    if norm == "BN":
        raise ValueError("e2vid_norm 'BN' is not run by the JAX package "
                         "either: its rollout needs batch statistics that "
                         "init_state drops")
    if norm not in NORMS:
        raise ValueError(f"unknown e2vid_norm {norm!r}; expected one of "
                         f"{NORMS}")


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel normalization over H and W (no affine,
    eps 1e-5), in x's memory format: the cell kernels read channels-last
    operands, and ``F.instance_norm`` returns NCHW-contiguous tensors."""
    y = F.instance_norm(x, eps=1e-5)
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y


def _norm_fn(norm: Optional[str]):
    check_norm(norm)
    return (lambda x: x) if norm is None else instance_norm


class ConvLayer(nn.Module):
    """Conv (padding k//2) + optional norm + optional activation. With
    ``block_space`` the input is a 2x2 space-to-depth tensor and the (5x5,
    norm-free) conv runs in block form (:class:`BlockConv`) on
    ``block_conv_impl``, over the same parameters."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: Optional[str] = "relu", *,
                 norm: Optional[str] = None, device=None):
        super().__init__()
        self.conv2d = Conv2d(in_channels, out_channels, kernel_size, stride,
                             padding=kernel_size // 2, device=device)
        self.norm = _norm_fn(norm)
        self.activation = _ACTIVATIONS[activation]
        self._block = (BlockConv(self.conv2d, activation)
                       if kernel_size == 5 and stride in (1, 2)
                       and norm is None else None)

    def forward(self, x: torch.Tensor, block_space: bool = False,
                block_conv_impl: str = "xla") -> torch.Tensor:
        if block_space:
            if self._block is None:
                raise ValueError("the block-space path takes norm-free 5x5 "
                                 f"convs of stride 1 or 2, got {self.conv2d}")
            return self._block(x, block_conv_impl)
        return self.activation(self.norm(self.conv2d(x)))


class ResidualBlock(nn.Module):
    """relu(norm(conv2(relu(norm(conv1(x))))) + x), 3x3 convs."""

    def __init__(self, channels: int, *, norm: Optional[str] = None,
                 device=None):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, padding=1, device=device)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, device=device)
        self.norm = _norm_fn(norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm(self.conv1(x)))
        return torch.relu(self.norm(self.conv2(y)) + x)


class UpsampleConvLayer(nn.Module):
    """Bilinear 2x upsample + conv + optional norm + activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, activation: Optional[str] = "relu", *,
                 norm: Optional[str] = None, device=None):
        super().__init__()
        self.conv2d = Conv2d(in_channels, out_channels, kernel_size,
                             padding=kernel_size // 2, device=device)
        self.norm = _norm_fn(norm)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(self.norm(self.conv2d(upsample2x_bilinear(x))))


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell: one 3x3 ``Gates`` conv over concat([x, h])
    producing (i, f, o, g) x hidden channels (:mod:`ess_tpu_torch.ops.conv_lstm`).
    ``forward`` takes the resolved cell name (``'pallas'``, ``'pallas_int8'``,
    ``'pallas_int8_interpret'`` or ``'xla'``), so one parameter set serves
    rollouts on different cells. The cell routes the name by the input's
    shape (``int8_route``: the JAX package's int8 size rule), and the
    weights are prepared for the routed cell, so an int8 weight matrix
    never reaches the exact cell."""

    def __init__(self, input_size: int, hidden_size: int, *, device=None):
        super().__init__()
        self.Gates = nn.Conv2d(input_size + hidden_size, 4 * hidden_size, 3,
                               padding=1, device=device)
        self._prepared: Dict[str, Tuple[tuple, torch.Tensor]] = {}

    def _prepared_weight(self, impl: str) -> Optional[torch.Tensor]:
        """What the cell kernel reads of the gate weight
        (``prepare_cell_weights``: the exact kernel's bf16 weight image, or
        the f32 gate matrix the int8 prep re-quantizes per call), rebuilt
        only when the weight changes."""
        w = self.Gates.weight
        if w.device.type != "cuda" or impl == "xla":
            return None
        key = (w.data_ptr(), w._version, w.device)
        hit = self._prepared.get(impl)
        if hit is None or hit[0] != key:
            hit = (key, prepare_cell_weights(w.detach(), impl))
            self._prepared[impl] = hit
        return hit[1]

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor],
                impl: str = "pallas"
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        h_prev, c_prev = state
        h, c = conv_lstm_cell(
            x, h_prev.to(x.dtype), c_prev.to(x.dtype), self.Gates.weight,
            self.Gates.bias, impl=impl,
            prepared=self._prepared_weight(int8_route(impl, x.shape)))
        return h, (h, c)


class ConvGRUCell(nn.Module):
    """Convolutional GRU cell: ``update_gate`` and ``reset_gate`` 3x3 convs
    over concat([x, h]), ``out_gate`` over concat([x, h * reset]), and
    h' = h (1 - update) + tanh(out) update, in the input's dtype. The JAX
    package computes it with XLA convs, not a Pallas kernel, so it runs on
    the library convs; it takes no cell name."""

    def __init__(self, input_size: int, hidden_size: int,
                 kernel_size: int = 3, *, device=None):
        super().__init__()
        gate = lambda: Conv2d(input_size + hidden_size, hidden_size,
                              kernel_size, padding=kernel_size // 2,
                              device=device)
        self.reset_gate, self.update_gate, self.out_gate = (
            gate(), gate(), gate())

    def forward(self, x: torch.Tensor, state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h_prev = state.to(x.dtype)
        xh = torch.cat([x, h_prev], dim=1)
        update = torch.sigmoid(self.update_gate(xh))
        reset = torch.sigmoid(self.reset_gate(xh))
        cand = torch.tanh(self.out_gate(torch.cat([x, h_prev * reset],
                                                  dim=1)))
        h = h_prev * (1.0 - update) + cand * update
        return h, h


RECURRENT_BLOCKS = ("convlstm", "convgru")


class RecurrentConvLayer(nn.Module):
    """Stride-2 5x5 conv (+ ``norm``) + ReLU followed by a recurrent cell:
    a ConvLSTM cell (``impl`` as :class:`ConvLSTMCell`) or, with
    ``recurrent_block='convgru'``, a :class:`ConvGRUCell` (state one tensor,
    ``impl`` unused). With ``block_space`` the input is a 2x2 space-to-depth
    tensor: the conv runs in block form and lands unblocked at half
    resolution, where the cell runs as always."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 2, *,
                 recurrent_block: str = "convlstm",
                 norm: Optional[str] = None, device=None):
        super().__init__()
        if recurrent_block not in RECURRENT_BLOCKS:
            raise ValueError(f"unknown recurrent block {recurrent_block!r}; "
                             f"expected one of {RECURRENT_BLOCKS}")
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride,
                              "relu", norm=norm, device=device)
        cell = (ConvLSTMCell if recurrent_block == "convlstm"
                else ConvGRUCell)
        self.recurrent_block = cell(out_channels, out_channels, device=device)

    def forward(self, x: torch.Tensor, state, impl: str = "pallas",
                block_space: bool = False, block_conv_impl: str = "xla"):
        x = self.conv(x, block_space, block_conv_impl)
        if isinstance(self.recurrent_block, ConvGRUCell):
            return self.recurrent_block(x, state)
        return self.recurrent_block(x, state, impl)


class ReLUINSConv2d(nn.Module):
    """conv -> InstanceNorm (no affine) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, *, device=None):
        super().__init__()
        self.model = nn.Sequential(
            Conv2d(in_channels, out_channels, kernel_size, stride,
                   padding=kernel_size // 2, device=device),
            nn.InstanceNorm2d(out_channels, affine=False),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class INSResBlock(nn.Module):
    """(conv3x3 -> IN -> ReLU -> conv3x3 -> IN) + residual."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.model = nn.Sequential(
            Conv2d(channels, channels, 3, padding=1, device=device),
            nn.InstanceNorm2d(channels, affine=False),
            nn.ReLU(),
            Conv2d(channels, channels, 3, padding=1, device=device),
            nn.InstanceNorm2d(channels, affine=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x) + x
