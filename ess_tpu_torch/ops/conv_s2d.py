"""Space-to-depth (block) evaluation of 5x5 convs (NCHW).

Counterpart of ``ess_tpu/ops/conv_s2d.py`` on the parts the block-space
rollout and the fused encoder level use: ``space_to_depth``,
``depth_to_space``, ``block_kernel``, ``block_bias``, ``s2d_kernel``,
``s2d_kernel_stride2``, ``conv5x5_s2d_blocks`` and ``conv5x5_s2d_stride2``. A 5x5 SAME conv over an image equals a 3x3 SAME conv over
its 2x2 space-to-depth blocks with remapped weights: at stride 1 it yields
all four output phases at once (``bi=bo=2``: the E2VID head conv, 5 -> 32
channels becomes 20 -> 128), at stride 2 it lands at half resolution
unblocked (``bi=2, bo=1``: the first encoder's conv, 128 -> 64). The remap
is a gather of the original weights, so parameters and checkpoints do not
change and gradients flow through it.

Channel order is the JAX package's: blocked channel ``(r*2 + s)*C + c``
holds pixel ``(2Y + r, 2X + s)`` of channel ``c``.
``torch.pixel_unshuffle`` orders channels ``c*4 + r*2 + s`` and is another
function. Tensors are NCHW; results come out in channels-last memory, the
layout the kernels and cuDNN read.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2); channel = (r*2 + s)*C + c."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H and W, got {(h, w)}")
    x = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return x.permute(0, 3, 1, 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, H/2, W/2) -> (B, C, H, W); inverse of :func:`space_to_depth`."""
    b, c4, hh, ww = x.shape
    if c4 % 4:
        raise ValueError(f"depth_to_space needs 4*C channels, got {c4}")
    c = c4 // 4
    x = x.permute(0, 2, 3, 1).reshape(b, hh, ww, 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * hh, 2 * ww, c)
    return x.permute(0, 3, 1, 2)


def block_kernel(weight: torch.Tensor, *, bi: int, bo: int,
                 stride: int = 1) -> torch.Tensor:
    """(C_out, C_in, K, K) weight of a SAME conv (pad K//2) with ``stride``
    -> the weight (bo^2*C_out, bi^2*C_in, KB, KB) of the stride-1 SAME conv
    that computes the same function from an input stored in bi x bi blocks
    (channel ``(r*bi + s)*C_in + c``) to an output in bo x bo blocks
    (channel ``(p*bo + q)*C_out + n``). Needs ``stride * bo == bi`` so that
    the block grids align, and an odd block-kernel size with centred
    support (K=5 with ``bi=2``: KB=3)."""
    cout, cin, k, k2 = weight.shape
    if k != k2 or k % 2 != 1:
        raise ValueError(f"block_kernel needs an odd square kernel, got "
                         f"{tuple(weight.shape)}")
    if stride * bo != bi:
        raise ValueError(f"block_kernel needs stride*bo == bi, got stride "
                         f"{stride}, bo {bo}, bi {bi}")
    pad = k // 2
    imax = stride * (bo - 1) + k - 1 - pad
    dymin = -pad // bi
    kb = imax // bi - dymin + 1
    if kb % 2 != 1 or -dymin != kb // 2:
        raise ValueError(
            f"block_kernel needs an odd block-kernel size with centred "
            f"support (kb={kb}, dymin={dymin}); (k={k}, bi={bi}, bo={bo}, "
            f"stride={stride}) would need explicit conv padding")
    # gather index into the kernel axis; k = the appended zero row (taps
    # that fall outside the kernel's support)
    idx = np.full((kb, bi, bo), k, np.int64)
    for ky in range(kb):
        for r in range(bi):
            for p in range(bo):
                dy = (ky + dymin) * bi + r - stride * p + pad
                if 0 <= dy < k:
                    idx[ky, r, p] = dy
    flat = torch.from_numpy(idx.reshape(-1)).to(weight.device)
    wp = F.pad(weight, (0, 1, 0, 1))                 # (cout, cin, k+1, k+1)
    w = wp.index_select(2, flat).index_select(3, flat)
    w = w.reshape(cout, cin, kb, bi, bo, kb, bi, bo)
    #             n     c    ky  r   p   kx  s   q
    w = w.permute(4, 7, 0, 3, 6, 1, 2, 5)            # p q n r s c ky kx
    return w.reshape(bo * bo * cout, bi * bi * cin, kb, kb)


def block_bias(bias: torch.Tensor, bo: int) -> torch.Tensor:
    """Tile a conv bias for bo x bo blocked output channels."""
    return bias.repeat(bo * bo)


def s2d_kernel(weight: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 5, 5) weight of a stride-1 conv (pad 2) ->
    (4*C_out, 4*C_in, 3, 3): the 3x3 SAME conv over space-to-depth blocks
    that yields all four output phases at once. It is :func:`block_kernel`
    with ``bi=bo=2, stride=1``, kept under the JAX package's name."""
    if tuple(weight.shape[2:]) != (5, 5):
        raise ValueError(f"s2d_kernel needs a 5x5 kernel, got "
                         f"{tuple(weight.shape)}")
    return block_kernel(weight, bi=2, bo=2, stride=1)


def conv5x5_s2d_blocks(x_s2d: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stride-1 5x5 conv evaluated in block space: space-to-depth input
    (B, 4*C_in, H/2, W/2) -> space-to-depth output (B, 4*C_out, H/2, W/2)
    in ``dtype``, the library conv on operands cast to ``dtype``. Equals
    ``space_to_depth`` of the full-resolution conv with padding 2."""
    out = F.conv2d(x_s2d.to(dtype), s2d_kernel(weight).to(dtype), padding=1)
    if bias is not None:
        out = out + block_bias(bias, 2).to(dtype)[None, :, None, None]
    return out


def s2d_kernel_stride2(weight: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 5, 5) weight of a stride-2 conv (pad 2) ->
    (C_out, 4*C_in, 3, 3): the stride-1 SAME conv over the space-to-depth
    input that computes the same function at half resolution. It is
    :func:`block_kernel` with ``bi=2, bo=1, stride=2``, kept under the JAX
    package's name for the 5x5 case."""
    if tuple(weight.shape[2:]) != (5, 5):
        raise ValueError(f"s2d_kernel_stride2 needs a 5x5 kernel, got "
                         f"{tuple(weight.shape)}")
    return block_kernel(weight, bi=2, bo=1, stride=2)


def conv5x5_s2d_stride2(x_s2d: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stride-2 5x5 conv evaluated on a space-to-depth input:
    (B, 4*C_in, H/2, W/2) -> (B, C_out, H/2, W/2) in ``dtype``, the library
    conv on operands cast to ``dtype``. Equals the conv of the
    full-resolution input with stride 2 and padding 2."""
    out = F.conv2d(x_s2d.to(dtype), s2d_kernel_stride2(weight).to(dtype),
                   padding=1)
    if bias is not None:
        out = out + bias.to(dtype)[None, :, None, None]
    return out
