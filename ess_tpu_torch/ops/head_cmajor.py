"""The E2VID head conv on a C-major space-to-depth window, normalize fused.

Counterpart of the JAX tool ``tools/bench_head.py`` (``kern``, the body its
``make_pallas`` hands to ``pl.pallas_call``): the block-space head conv
(a 3x3 SAME conv over 2x2 space-to-depth blocks, 20 -> 128 channels for
5 bins and a 32-channel E2VID head) read straight from a window stored
channel-major (NCHW-contiguous, as the voxelizers write it), with the
per-window nonzero normalize applied on the way in:

1. every input value ``v`` becomes ``where(v != 0, (v - shift) * scale, 0)``
   in f32, one subtraction and one multiplication each rounded on its own,
   then rounded once to bf16;
2. a zero-padded 3x3 conv over the normalized image (the padding is applied
   after the normalize), f32 accumulation of bf16 products;
3. ``+ bias``, ReLU, one rounding to bf16, stored NHWC (B, H, W, C_out) or
   NCHW (B, C_out, H, W).

The weights are the block-space head weights (``conv_s2d.s2d_kernel`` of
the 5x5 head kernel, (C_out, C_in, 3, 3)) and the bias their tiled bias
(``conv_s2d.block_bias(bias, 2)``). ``shift`` and ``scale`` are runtime
floats (the JAX tool's compile-time constants).

On a CPU tensor :func:`head_cmajor` runs :func:`head_cmajor_ref`; on a CUDA
tensor it launches the kernel of ``csrc/head_cmajor.cu`` (the halo-tile
core, tile plan :func:`conv_halo.head_plan`) or raises. There is no size
gate and no route to the plain version on CUDA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ess_tpu_torch.ops import conv_halo
from ess_tpu_torch.ops.conv3x3 import prepare_conv_weights, tap_channels
from ess_tpu_torch.ops.conv_lstm import _check_aligned, _check_matrix

launches = 0   # kernel launches of head_cmajor (CUDA tensors only)

MAX_CIN = 32   # input channels the kernel holds per tap (one K chunk)


def normalize_apply(x: torch.Tensor, shift: float, scale: float
                    ) -> torch.Tensor:
    """``where(v != 0, (v - shift) * scale, 0)`` in f32, rounded once to
    bf16: the per-window nonzero normalize with its statistics given."""
    v = x.float()
    return torch.where(v != 0, (v - shift) * scale,
                       torch.zeros_like(v)).to(torch.bfloat16)


def head_cmajor_ref(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, *, shift: float, scale: float,
                    nchw_out: bool) -> torch.Tensor:
    """Plain version: normalize, the 3x3 SAME conv in f32 on the
    bf16-rounded operands, bias, ReLU, one rounding to bf16. x (B, C_in, H,
    W) bf16, weight (C_out, C_in, 3, 3), bias (C_out,) -> bf16 (B, C_out,
    H, W) if ``nchw_out`` else (B, H, W, C_out), both contiguous."""
    xn = normalize_apply(x, shift, scale)
    out = F.conv2d(xn.float(), weight.to(torch.bfloat16).float(),
                   bias.float(), padding=1)
    out = torch.relu(out).to(torch.bfloat16)
    return out if nchw_out else out.permute(0, 2, 3, 1).contiguous()


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    if x.ndim != 4 or weight.ndim != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"head_cmajor: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} are not (B, C_in, H, W) and "
                         "(C_out, C_in, 3, 3)")
    b, cin, hh, ww = x.shape
    cout = weight.shape[0]
    if weight.shape[1] != cin or tuple(bias.shape) != (cout,):
        raise ValueError(f"head_cmajor: weight {tuple(weight.shape)} or bias "
                         f"{tuple(bias.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    return b, cin, hh, ww, cout


def head_cmajor(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                *, shift: float, scale: float, nchw_out: bool,
                prepared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalize + 3x3 head conv + bias + ReLU on a C-major window (module
    docstring). CPU tensors: :func:`head_cmajor_ref`. CUDA tensors: the
    kernel, which takes x as a contiguous bf16 (B, C_in, H, W) tensor with
    C_in <= 32 and C_out a multiple of 8, any H and W; ``prepared`` is
    ``conv3x3.prepare_conv_weights(weight)``, computed here when not
    given."""
    b, cin, hh, ww, cout = _check(x, weight, bias)
    if x.device.type == "cpu":
        return head_cmajor_ref(x, weight, bias, shift=shift, scale=scale,
                               nchw_out=nchw_out)
    if x.device.type != "cuda":
        raise ValueError(f"head_cmajor: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"head_cmajor: x must be a contiguous bfloat16 "
                         f"NCHW tensor, got {x.dtype} with strides "
                         f"{x.stride()}")
    if cin > MAX_CIN or cout % 8:
        raise ValueError(f"head_cmajor: C_in={cin} must be at most "
                         f"{MAX_CIN} and C_out={cout} a multiple of 8")
    if prepared is None:
        prepared = prepare_conv_weights(weight.detach())
    _check_matrix("head_cmajor", prepared, torch.bfloat16,
                  (cout, 9 * tap_channels(cin)), x.device)
    bias = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    shape = (b, cout, hh, ww) if nchw_out else (b, hh, ww, cout)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    _check_aligned("head_cmajor", prepared, out)
    aligned = ww % 8 == 0 and x.data_ptr() % 16 == 0
    plan = conv_halo.head_plan(b, hh, ww, cin, cout, nchw_out=nchw_out,
                               aligned=aligned,
                               sm_count=conv_halo.sm_count(x.device))
    from ess_tpu_torch import kernels

    global launches
    lib = kernels.get_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ess_head_cmajor(
        x.data_ptr(), prepared.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, hh, ww, cin, cout, float(shift), float(scale),
        int(nchw_out), int(aligned), plan.th, plan.tw, plan.grid_x,
        plan.smem, stream)
    kernels.check(err, "head_cmajor kernel")
    launches += 1
    return out
