"""Layer primitives of the E2VID backbone and the segmentation head (NCHW).

Counterpart of ``ess_tpu/models/layers.py``: ``ConvLayer`` with its
``conv_impl`` forms (``'xla'``, ``'s2d'``, ``'xla_im2col'``, ``'auto'``)
and its block-space form ``_BlockConv`` (:class:`BlockConv`, any odd
kernel on 2x2 or 4x4 space-to-depth input, ``in_segments`` for a concat of
separately blocked operands), ``ResidualBlock``, ``UpsampleConvLayer``
(``conv_impl='auto'``: the post-upsample conv in 2x2 block space),
``ConvLSTMCell`` (``state_block=2``: operands and state in space-to-depth
form, the quad-block rollout's level 0), ``ConvGRUCell``,
``RecurrentConvLayer``, ``TransposedConvLayer``, ``activation_fn``,
``ReLUINSConv2d`` (``block_space``,
``in_segments``, ``up2x_fused``), ``INSResBlock``, ``_UpFusedConv``
(``ops/conv_s2d.py::up2x_conv_fused``), ``upsample2x_nearest``,
``skip_merge``,
``TorchBatchNorm`` as :class:`BatchNorm2d` (``block``: statistics pooled
over the subpixels of a space-to-depth input), ``instance_norm`` and
``instance_norm_blocked``. The E2VID layers take the JAX package's
``norm``: None or ``'IN'`` (instance norm without affine parameters, eps
1e-5, before the activation); ``'BN'`` raises (:func:`check_norm`). Every
block and im2col form is an exact remap of the same parameters: the same
function, evaluated over another layout.

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
from ess_tpu_torch.ops.conv_s2d import (
    block_bias, block_kernel, conv5x5_s2d, depth_to_space, gates_bias_s2d,
    gates_kernel_s2d, segment_input_perm, up2x_bilinear_s2d,
    up2x_conv_fused)
from ess_tpu_torch.parallel import dp

_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, None: lambda x: x}


def activation_fn(name: Optional[str]):
    """The activation ``name`` names (``'relu'``, ``'sigmoid'``,
    ``'tanh'``; None: the identity); another name raises ``KeyError``."""
    return _ACTIVATIONS[name]


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
    data parallel the batch statistics are the global batch's. With
    ``block`` b > 1 the input is a b x b space-to-depth tensor (channel
    ``sub*C + c``): statistics and parameters stay per original channel,
    pooled over the subpixels, the value set of the standard layout (JAX's
    ``TorchBatchNorm(block=2)``)."""

    def __init__(self, num_features: int, *, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                block: int = 1) -> torch.Tensor:
        if block > 1:
            b, cb, h, w = x.shape
            nsub = block * block
            xs = x.reshape(b, nsub, cb // nsub, h, w).transpose(1, 2)
            y = self.forward(xs.reshape(b, cb // nsub, nsub * h, w), train)
            y = y.reshape(b, cb // nsub, nsub, h, w).transpose(1, 2)
            return _like(y.reshape(b, cb, h, w), x)
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


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y in x's memory format (channels-last where x is)."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y


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
    """An odd-k conv + activation evaluated on a space-to-depth input, the
    JAX ``_BlockConv``. It owns no parameters: it reads the (C_out, C_in,
    k, k) weight and the bias (or none) of ``conv`` and remaps them to an
    exact stride-1 block conv at apply time
    (:func:`ess_tpu_torch.ops.conv_s2d.block_kernel`), so checkpoints do
    not change. ``in_block`` is the input's blocking (2: s2d, 4: the
    quad-block rollout's s4d); the output's is ``in_block // stride``, so a
    stride-2 conv on s2d lands unblocked at half resolution, and on s4d in
    s2d form. ``in_segments``: the input is a concat of separately blocked
    operands of these widths (a skip connection), and the weight's input
    dim is permuted to match (``segment_input_perm``).

    ``impl``: ``'xla'`` is the library conv rounded to the input's dtype,
    then bias and activation; ``'pallas'`` and ``'pallas_int8'`` (the
    exact conv below the JAX package's int8 size rule, ``int8_route``) run
    :func:`ess_tpu_torch.ops.conv3x3.conv3x3_fused` with the bias and a ReLU
    fused, which takes 3x3 block kernels only. While the parameters need no
    gradient, the remapped weights (cast for ``'xla'``, kernel-ready for
    the others on CUDA) are kept per ``impl`` and dtype and rebuilt only
    when a parameter changes."""

    def __init__(self, conv: nn.Conv2d, activation: Optional[str], *,
                 in_block: int = 2, in_segments: Optional[tuple] = None):
        k = conv.kernel_size[0]
        self.stride = conv.stride[0]
        if (conv.kernel_size[1] != k or k % 2 != 1
                or in_block % self.stride):
            raise ValueError(f"the block-space form takes odd square convs "
                             f"whose stride divides the block {in_block}, "
                             f"got {conv}")
        self.conv = conv
        self.activation = activation
        self.in_block = in_block
        self.in_segments = in_segments
        self._cache: Dict[tuple, Tuple[tuple, tuple]] = {}

    def _remap(self, weight, bias):
        bi = self.in_block
        bo = bi // self.stride
        w2 = block_kernel(weight, bi=bi, bo=bo, stride=self.stride)
        if self.in_segments is not None:
            perm = segment_input_perm(bi, self.in_segments)
            w2 = w2.index_select(1, torch.from_numpy(perm).to(w2.device))
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
                           padding=w2.shape[-1] // 2)
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


def instance_norm_blocked(x_blk: torch.Tensor, block: int) -> torch.Tensor:
    """:func:`instance_norm` of a block x block space-to-depth tensor in
    block space: an original channel's statistics pool over H, W and its
    ``block**2`` subpixel channels, the value set of the standard
    layout."""
    b, cb, h, w = x_blk.shape
    nsub = block * block
    xs = x_blk.reshape(b, nsub, cb // nsub, h, w).transpose(1, 2)
    y = F.instance_norm(xs.reshape(b, cb // nsub, nsub * h, w), eps=1e-5)
    y = y.reshape(b, cb // nsub, nsub, h, w).transpose(1, 2)
    return _like(y.reshape(b, cb, h, w), x_blk)


def _norm_fn(norm: Optional[str]):
    check_norm(norm)
    return (lambda x: x) if norm is None else instance_norm


CONV_IMPLS = ("xla", "s2d", "xla_im2col", "auto")   # ConvLayer.conv_impl


def im2col_conv(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Stride-1 SAME conv as an explicit patch contraction over
    k*k*C_in (JAX's ``_Im2ColConv`` with ``impl='xla'``), in x's dtype."""
    b, _, h, w = x.shape
    cout, _, k, _ = weight.shape
    cols = F.unfold(x, k, padding=k // 2)             # (B, C_in*k*k, H*W)
    out = torch.matmul(weight.reshape(cout, -1).to(x.dtype), cols)
    out = out.view(b, cout, h, w)
    if bias is not None:
        out = out + bias.to(x.dtype)[None, :, None, None]
    return _like(out, x)


class ConvLayer(nn.Module):
    """Conv (padding k//2) + optional norm + optional activation.

    ``conv_impl`` picks the evaluation of the standard-layout conv, as JAX
    ``ConvLayer``: ``'xla'`` the library conv; ``'s2d'`` a stride-1 5x5
    conv in 2x2 block space (``conv5x5_s2d``, bias included, the other
    shapes the library conv); ``'xla_im2col'`` a stride-1 conv as a patch
    contraction (:func:`im2col_conv`); ``'auto'`` ``'s2d'`` for a stride-1
    5x5 conv on even H and W, else ``'xla'``. An unknown name raises.

    With ``block_space`` the input is space-to-depth (2 or True: 2x2
    blocks, 4: the quad-block rollout's 4x4) and the (5x5, norm-free)
    conv runs in block form (:class:`BlockConv`) on ``block_conv_impl``,
    over the same parameters."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: Optional[str] = "relu", *,
                 norm: Optional[str] = None, conv_impl: str = "xla",
                 device=None):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r}; use one of "
                             f"{CONV_IMPLS}")
        self.conv_impl = conv_impl
        self.conv2d = Conv2d(in_channels, out_channels, kernel_size, stride,
                             padding=kernel_size // 2, device=device)
        self.norm = _norm_fn(norm)
        self.activation = _ACTIVATIONS[activation]
        ok = kernel_size == 5 and stride in (1, 2) and norm is None
        self._block = BlockConv(self.conv2d, activation) if ok else None
        self._block4 = (BlockConv(self.conv2d, activation, in_block=4)
                        if ok else None)

    def _resolve_impl(self, x: torch.Tensor) -> str:
        k, stride = self.conv2d.kernel_size[0], self.conv2d.stride[0]
        impl = self.conv_impl
        if impl == "auto":
            ok = (stride == 1 and k == 5 and x.shape[2] % 2 == 0
                  and x.shape[3] % 2 == 0)
            impl = "s2d" if ok else "xla"
        if stride != 1 or (impl == "s2d" and k != 5):
            impl = "xla"
        return impl

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        impl = self._resolve_impl(x)
        w, b = self.conv2d.weight, self.conv2d.bias
        if impl == "s2d":
            return _like(conv5x5_s2d(x, w, b, dtype=x.dtype), x)
        if impl == "xla_im2col":
            return im2col_conv(x, w, b)
        return self.conv2d(x)

    def forward(self, x: torch.Tensor, block_space=False,
                block_conv_impl: str = "xla") -> torch.Tensor:
        if block_space:
            block = self._block4 if block_space == 4 else self._block
            if block is None:
                raise ValueError("the block-space path takes norm-free 5x5 "
                                 f"convs of stride 1 or 2, got {self.conv2d}")
            return block(x, block_conv_impl)
        return self.activation(self.norm(self._conv(x)))


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


UPSAMPLE_CONV_IMPLS = ("auto", "xla")   # UpsampleConvLayer.conv_impl


class UpsampleConvLayer(nn.Module):
    """Bilinear 2x upsample + conv + optional norm + activation.

    ``conv_impl='auto'`` (JAX's default) evaluates a norm-free 5x5 conv
    with fewer than 128 output channels in 2x2 block space: the upsample
    lands in s2d form at source resolution (``up2x_bilinear_s2d``), the
    conv runs as its exact 3x3 block remap (:class:`BlockConv`) and one
    depth-to-space restores the layout; ``'xla'`` upsamples and convolves
    in the standard layout. Same parameters, same function."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, activation: Optional[str] = "relu", *,
                 norm: Optional[str] = None, conv_impl: str = "auto",
                 device=None):
        super().__init__()
        if conv_impl not in UPSAMPLE_CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r}; use one of "
                             f"{UPSAMPLE_CONV_IMPLS}")
        self.conv_impl = conv_impl
        self.conv2d = Conv2d(in_channels, out_channels, kernel_size,
                             padding=kernel_size // 2, device=device)
        self.norm = _norm_fn(norm)
        self.activation = _ACTIVATIONS[activation]
        self._block = (BlockConv(self.conv2d, None)
                       if kernel_size == 5 and norm is None
                       and out_channels < 128 else None)

    @property
    def blocked(self) -> bool:
        """Whether ``forward`` runs the block form."""
        return self.conv_impl == "auto" and self._block is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.blocked:
            y = depth_to_space(self._block(up2x_bilinear_s2d(x)))
            return self.activation(_like(y, x))
        return self.activation(self.norm(self.conv2d(upsample2x_bilinear(x))))


class TransposedConvLayer(nn.Module):
    """Stride-2 transposed conv (the output twice the input's size) +
    optional norm + activation, JAX's ``TransposedConvLayer``: flax's
    ``ConvTranspose(padding='SAME')``, which pads the stride-dilated input
    by (k+1)//2 before and (k-2)//2 after (3, 2 at k=5) and correlates it
    with the kernel unflipped. No ``nn.ConvTranspose2d`` padding pair gives
    that alignment, so the layer keeps upstream's ``transposed_conv2d``
    parameters, (C_in, C_out, k, k) with flax's kernel unflipped in them,
    and evaluates ``conv_transpose2d`` of the spatially flipped kernel at
    the padding that pads (k+1)//2 before, cropped to 2H x 2W: the same
    function. ``'IN'`` is instance norm; ``'BN'`` raises
    (:func:`check_norm`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, activation: Optional[str] = "relu", *,
                 norm: Optional[str] = None, device=None):
        super().__init__()
        self.norm = _norm_fn(norm)
        self.activation = _ACTIVATIONS[activation]
        self.transposed_conv2d = nn.ConvTranspose2d(
            in_channels, out_channels, kernel_size, stride=2,
            padding=kernel_size - 1 - (kernel_size + 1) // 2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.transposed_conv2d
        w = conv.weight.to(x.dtype).flip(2, 3)
        b = None if conv.bias is None else conv.bias.to(x.dtype)
        h, w_ = x.shape[2:]
        y = F.conv_transpose2d(x, w, b, stride=2, padding=conv.padding)
        y = y[:, :, :2 * h, :2 * w_]
        return self.activation(self.norm(_like(y.contiguous(), x)))


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell: one 3x3 ``Gates`` conv over concat([x, h])
    producing (i, f, o, g) x hidden channels (:mod:`ess_tpu_torch.ops.conv_lstm`).
    ``forward`` takes the resolved cell name (``'pallas'``, ``'pallas_int8'``,
    ``'pallas_int8_interpret'`` or ``'xla'``), so one parameter set serves
    rollouts on different cells. The cell routes the name by the input's
    shape (``int8_route``: the JAX package's int8 size rule), and the
    weights are prepared for the routed cell, so an int8 weight matrix
    never reaches the exact cell.

    ``state_block=2`` (JAX's, the quad-block rollout's level 0): x, h and
    c arrive and leave in 2x2 space-to-depth form (4x the channels), and
    the same cell runs on the remapped gate weights
    (``gates_kernel_s2d``: input ``[s2d(x) | s2d(h)]``, output gate-major),
    so on the card the same kernels run at 4x the channel counts."""

    def __init__(self, input_size: int, hidden_size: int, *, device=None):
        super().__init__()
        self.Gates = nn.Conv2d(input_size + hidden_size, 4 * hidden_size, 3,
                               padding=1, device=device)
        self._prepared: Dict[str, Tuple[tuple, torch.Tensor]] = {}
        self._s2d: Dict[str, Tuple[tuple, tuple]] = {}

    def _weight_key(self) -> tuple:
        w, b = self.Gates.weight, self.Gates.bias
        return (w.data_ptr(), w._version, w.device, b.data_ptr(), b._version)

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

    def _s2d_weights(self, impl: str):
        """(gate weight, bias, prepared) of the ``state_block=2`` cell:
        remapped at apply time while the parameters take a gradient, else
        kept per routed cell name and rebuilt only when they change."""
        w, b = self.Gates.weight, self.Gates.bias
        if torch.is_grad_enabled() and (w.requires_grad or b.requires_grad):
            return gates_kernel_s2d(w), gates_bias_s2d(b), None
        key = self._weight_key()
        hit = self._s2d.get(impl)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                w2, b2 = gates_kernel_s2d(w.detach()), gates_bias_s2d(
                    b.detach())
                prepared = (prepare_cell_weights(w2, impl)
                            if w.device.type == "cuda" and impl != "xla"
                            else None)
            hit = (key, (w2, b2, prepared))
            self._s2d[impl] = hit
        return hit[1]

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor],
                impl: str = "pallas", state_block: int = 1
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        h_prev, c_prev = state
        routed = int8_route(impl, x.shape)
        if state_block == 2:
            weight, bias, prepared = self._s2d_weights(routed)
        else:
            weight, bias = self.Gates.weight, self.Gates.bias
            prepared = self._prepared_weight(routed)
        h, c = conv_lstm_cell(
            x, h_prev.to(x.dtype), c_prev.to(x.dtype), weight, bias,
            impl=impl, prepared=prepared)
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
    ``impl`` unused). ``block_space``: False, a standard input; True or 2,
    a 2x2 space-to-depth input, the conv in block form landing unblocked
    at half resolution, where the cell runs as always; 4, the quad-block
    rollout's 4x4 input, the conv landing in 2x2 blocks and the ConvLSTM
    cell running on space-to-depth state (``state_block=2``)."""

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
                block_space=False, block_conv_impl: str = "xla"):
        x = self.conv(x, block_space, block_conv_impl)
        if isinstance(self.recurrent_block, ConvGRUCell):
            if block_space == 4:
                raise ValueError("the quad-block rollout needs ConvLSTM "
                                 "cells")
            return self.recurrent_block(x, state)
        return self.recurrent_block(x, state, impl,
                                    2 if block_space == 4 else 1)


class ReLUINSConv2d(nn.Module):
    """conv -> InstanceNorm (no affine) -> ReLU.

    ``forward``'s forms, over the same parameters (JAX's): ``block_space``
    2 or 4, a stride-1 conv on a space-to-depth input (:class:`BlockConv`,
    ``in_segments`` for a concat of separately blocked operands) with the
    statistics pooled over the subpixels (:func:`instance_norm_blocked`);
    ``up2x_fused``, ``conv(up2x_nearest(x))`` at source resolution with the
    upsample folded into the weights (``up2x_conv_fused``), output in s2d
    form."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, *, device=None):
        super().__init__()
        self.model = nn.Sequential(
            Conv2d(in_channels, out_channels, kernel_size, stride,
                   padding=kernel_size // 2, device=device),
            nn.InstanceNorm2d(out_channels, affine=False),
            nn.ReLU())
        self._blocks: Dict[tuple, BlockConv] = {}

    def forward(self, x: torch.Tensor, block_space: int = 0,
                in_segments: Optional[tuple] = None,
                up2x_fused: bool = False) -> torch.Tensor:
        conv = self.model[0]
        if up2x_fused:
            if conv.stride[0] != 1 or block_space:
                raise ValueError("up2x_fused takes a stride-1 conv on a "
                                 "standard input")
            y = _like(up2x_conv_fused(x, conv.weight, conv.bias), x)
            return torch.relu(instance_norm_blocked(y, 2))
        if block_space:
            if conv.stride[0] != 1:
                raise ValueError("the blocked instance-norm conv is stride-1 "
                                 "only")
            key = (block_space, in_segments)
            if key not in self._blocks:
                self._blocks[key] = BlockConv(conv, None, in_block=block_space,
                                              in_segments=in_segments)
            y = _like(self._blocks[key](x), x)
            return torch.relu(instance_norm_blocked(y, block_space))
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
