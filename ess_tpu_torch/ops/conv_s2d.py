"""Space-to-depth (block) evaluation of 5x5 convs (NCHW).

Counterpart of ``ess_tpu/ops/conv_s2d.py``: ``space_to_depth`` and
``depth_to_space`` (2x2 blocks), ``space_to_depth4`` and
``depth_to_space4`` (4x4 blocks, the quad-block rollout's s4d),
``block_kernel``, ``block_bias``, ``segment_input_perm``, ``s2d_kernel``,
``s2d_kernel_stride2``, ``conv5x5_s2d_blocks``, ``conv5x5_s2d_stride2``,
``conv5x5_s2d``, the ConvLSTM gate remap ``gates_kernel_s2d`` /
``gates_bias_s2d``, and the upsamples emitted in block form
(``up2x_bilinear_s2d``, ``tile_upsample2x_s2d``,
``tile_upsample2x_s2d_to_s4d``, ``fold_up2x_into_conv``,
``up2x_conv_fused``). A 5x5 SAME conv over an image equals a 3x3 SAME conv
over its 2x2 space-to-depth blocks with remapped weights: at stride 1 it
yields all four output phases at once (``bi=bo=2``: the E2VID head conv, 5
-> 32 channels becomes 20 -> 128), at stride 2 it lands at half resolution
unblocked (``bi=2, bo=1``: the first encoder's conv, 128 -> 64). The remap
is a gather of the original weights, so parameters and checkpoints do not
change and gradients flow through it.

Channel order is the JAX package's: blocked channel ``(r*b + s)*C + c``
holds pixel ``(bY + r, bX + s)`` of channel ``c`` for b x b blocks.
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


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 16C, H/4, W/4); channel = (r*4 + s)*C + c."""
    b, c, h, w = x.shape
    if h % 4 or w % 4:
        raise ValueError(f"space_to_depth4 needs H and W divisible by 4, "
                         f"got {(h, w)}")
    x = x.permute(0, 2, 3, 1).reshape(b, h // 4, 4, w // 4, 4, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 4, w // 4, 16 * c)
    return x.permute(0, 3, 1, 2)


def depth_to_space4(x: torch.Tensor) -> torch.Tensor:
    """(B, 16C, H/4, W/4) -> (B, C, H, W); inverse of
    :func:`space_to_depth4`."""
    b, c16, hh, ww = x.shape
    if c16 % 16:
        raise ValueError(f"depth_to_space4 needs 16*C channels, got {c16}")
    c = c16 // 16
    x = x.permute(0, 2, 3, 1).reshape(b, hh, ww, 4, 4, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 4 * hh, 4 * ww, c)
    return x.permute(0, 3, 1, 2)


def segment_input_perm(bi: int, segments) -> np.ndarray:
    """Input-channel permutation for a concat of separately blocked
    operands: :func:`block_kernel` expects the input blocked as one tensor
    (channel ``sub*C_total + c``); for ``[blk(a) | blk(b)]`` (a skip
    connection's concat) gather the block weight's input dim with it:
    ``w_seg = w_blk[:, segment_input_perm(bi, (Ca, Cb))]``."""
    ctot = int(sum(segments))
    nsub = bi * bi
    perm = np.empty(nsub * ctot, np.int64)
    base = off = 0
    for seg in segments:
        for sub in range(nsub):
            a = base + sub * seg
            perm[a:a + seg] = sub * ctot + off + np.arange(seg)
        base += nsub * seg
        off += seg
    return perm


def gates_kernel_s2d(weight: torch.Tensor) -> torch.Tensor:
    """ConvLSTM gate weight (4*CH, CX + CH, 3, 3), gates i, f, o, g ->
    (16*CH, 4*(CX + CH), 3, 3) for space-to-depth operands: the input is
    ``concat(s2d(x), s2d(h))`` and the output stays gate-major, gate g in
    rows ``[g*4*CH, (g+1)*4*CH)`` with (phase, c) inside, so the cell's
    i/f/o/g split and the s2d state layout work unchanged. Exact
    (:func:`block_kernel` at ``bi=bo=2``)."""
    cout, cin = weight.shape[:2]
    ch = cout // 4
    cx = cin - ch
    w = block_kernel(weight, bi=2, bo=2, stride=1)  # (4*cout, 4*cin, 3, 3)
    ph = np.arange(4)[:, None]
    in_perm = np.concatenate([
        (ph * cin + np.arange(cx)[None, :]).reshape(-1),
        (ph * cin + cx + np.arange(ch)[None, :]).reshape(-1)])
    old = (np.arange(4)[:, None, None] * cout
           + np.arange(4)[None, :, None] * ch
           + np.arange(ch)[None, None, :])          # (ph, g, c)
    out_perm = old.transpose(1, 0, 2).reshape(-1)    # (g, ph, c)
    dev = weight.device
    return w.index_select(0, torch.from_numpy(out_perm).to(dev)).index_select(
        1, torch.from_numpy(in_perm).to(dev))


def gates_bias_s2d(bias: torch.Tensor) -> torch.Tensor:
    """Gate bias (4*CH,) -> the (16*CH,) gate-major bias of
    :func:`gates_kernel_s2d`."""
    ch = bias.shape[0] // 4
    return bias.repeat(4).view(4, 4, ch).transpose(0, 1).reshape(-1)


def up2x_bilinear_s2d(x: torch.Tensor) -> torch.Tensor:
    """``space_to_depth(upsample2x_bilinear(x))`` at source resolution:
    half-pixel 2x bilinear writes output row parity 0 as
    ``0.25 x[i-1] + 0.75 x[i]`` and parity 1 as ``0.75 x[i] + 0.25 x[i+1]``
    (edge-clamped), separably per axis, so each of the four subchannels is
    a weighted sum of edge-replicated shifts of x. (B, C, h, w) ->
    (B, 4C, h, w)."""
    xp = F.pad(x, (0, 0, 1, 1), mode="replicate")
    h, w = x.shape[2], x.shape[3]
    r0 = 0.25 * xp[:, :, :h] + 0.75 * x
    r1 = 0.75 * x + 0.25 * xp[:, :, 2:]
    xp0 = F.pad(r0, (1, 1, 0, 0), mode="replicate")
    xp1 = F.pad(r1, (1, 1, 0, 0), mode="replicate")
    p00 = 0.25 * xp0[..., :w] + 0.75 * r0
    p01 = 0.75 * r0 + 0.25 * xp0[..., 2:]
    p10 = 0.25 * xp1[..., :w] + 0.75 * r1
    p11 = 0.75 * r1 + 0.25 * xp1[..., 2:]
    return torch.cat([p00, p01, p10, p11], dim=1)


def tile_upsample2x_s2d(x: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsample emitted in s2d form: every subpixel of a block
    equals its source pixel, so it is a channel tile. (B, C, h, w) ->
    (B, 4C, h, w)."""
    return x.repeat(1, 4, 1, 1)


def fold_up2x_into_conv(weight: torch.Tensor) -> torch.Tensor:
    """Fold a nearest-2x upsample into the following conv:
    ``conv_kxk(up2x_nearest(x)) == depth_to_space(conv(x, W'))``. Output
    pixel (2i+r, 2j+s) taps ``x[i + floor((r + ky - k//2) / 2)]``, so each
    output parity is a small conv on x, taps that land on one source pixel
    summed. (C_out, C_in, k, k) -> (4*C_out, C_in, kp, kp), output channel
    ``(r*2 + s)*C_out + co`` (k=3: kp=3)."""
    cout, cin, k, k2 = weight.shape
    if k != k2 or k % 2 != 1:
        raise ValueError(f"fold_up2x_into_conv needs an odd square kernel, "
                         f"got {tuple(weight.shape)}")
    p = k // 2
    deltas = sorted({(r + ky - p) // 2 for r in (0, 1) for ky in range(k)})
    tap = np.zeros((2, len(deltas), k), np.float32)   # tap[r, d, ky]
    for r in (0, 1):
        for ky in range(k):
            tap[r, deltas.index((r + ky - p) // 2), ky] = 1.0
    t = torch.from_numpy(tap).to(device=weight.device, dtype=weight.dtype)
    w4 = torch.einsum("ray,sbx,oiyx->rsoiab", t, t, weight)
    return w4.reshape(4 * cout, cin, len(deltas), len(deltas))


def up2x_conv_fused(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """``conv_kxk(up2x_nearest(x))`` at source resolution, in x's dtype;
    the output is the s2d form (B, 4*C_out, h, w) of the (B, C_out, 2h, 2w)
    result (:func:`fold_up2x_into_conv`)."""
    w4 = fold_up2x_into_conv(weight).to(x.dtype)
    b4 = None if bias is None else block_bias(bias, 2).to(x.dtype)
    return F.conv2d(x, w4, b4, padding=w4.shape[-1] // 2)


def tile_upsample2x_s2d_to_s4d(x_s2d: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsample of an s2d tensor emitted in s4d form: s4d
    subchannel (r, s) of a block reads s2d subchannel (r//2, s//2).
    (B, 4C, h, w) -> (B, 16C, h, w)."""
    b, c4, h, w = x_s2d.shape
    c = c4 // 4
    x = x_s2d.view(b, 2, 1, 2, 1, c, h, w).expand(b, 2, 2, 2, 2, c, h, w)
    return x.reshape(b, 16 * c, h, w)


def conv5x5_s2d(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Drop-in 5x5 stride-1 SAME conv evaluated in block space (even H and
    W): space-to-depth, :func:`conv5x5_s2d_blocks`, depth-to-space."""
    return depth_to_space(conv5x5_s2d_blocks(space_to_depth(x), weight, bias,
                                             dtype=dtype))
