"""Micro-benchmark: the E2VID head conv on a C-major window, normalize fused.

Counterpart of the JAX package's ``tools/bench_head.py``. Input: a
(B, 20, 220, 320) bf16 space-to-depth voxel window stored channel-major
(NCHW-contiguous, as the voxelizers write it; a 440x640 crop with 5 bins),
about half of it zero; a 5x5 head kernel (5 -> 32) and its bias, seeded.
Each variant computes the function of the JAX tool's Pallas kernel
``kern``: the per-window nonzero normalize ``where(v != 0, (v - shift) *
scale, 0)`` (shift 0.1, scale 1.5), then the 3x3 block-space conv 20 -> 128
(``conv_s2d.s2d_kernel`` of the 5x5 kernel), f32 accumulation, the tiled
bias and a ReLU, bf16 out:

  xla    relayout from C-major to channels-last, the normalize in ATen,
         then the library's conv + bias + ReLU on the block-space weights
         (``torch.cudnn_convolution_relu``; on the CPU the plain conv).
         The JAX tool's ``run_xla`` applies no ReLU and sums in bf16; this
         variant computes ``kern``'s function on purpose, so that the three
         variants agree;
  tform  T1 (``ops/head_cmajor.py``, ``csrc/head_cmajor.cu``), NHWC out;
  nchw   T1, NCHW out.

Each variant prints its max |d| against ``xla`` and its time per call over
a 20-call chain (CUDA events, best of three). On the TPU neither Pallas
variant built (the JAX tool's docstring), so there is no TPU time to set
beside these.

Usage: python -m ess_tpu_torch.tools.bench_head
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ess_tpu_torch import resolve_device
from ess_tpu_torch.ops import head_cmajor as hc
from ess_tpu_torch.ops.conv3x3 import conv3x3_ref, prepare_conv_weights
from ess_tpu_torch.ops.conv_s2d import block_bias, s2d_kernel
from ess_tpu_torch.tools import STEPS, device_line, parse_args, time_best

# (B, C_in, HH, WW, C_out): the s2d window of a 440x640 crop with 5 bins
SHAPE = (8, 20, 220, 320, 128)
SHIFT, SCALE = 0.1, 1.5
VARIANTS = ("xla", "tform", "nchw")


def make_inputs(seed: int, shape: Sequence[int], device: torch.device):
    """The JAX tool's recipe: x standard normal with |x| < 0.5 set to zero
    (bf16, C-major), k5 a (C_out/4, C_in/4, 5, 5) kernel at 1/sqrt(125),
    bias at 0.1. Returns x, the block-space weight and the tiled bias."""
    b, cin, hh, ww, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, cin, hh, ww, generator=g)
    x = torch.where(x.abs() < 0.5, 0.0, x).to(device, torch.bfloat16)
    k5 = torch.randn(cout // 4, cin // 4, 5, 5, generator=g) / 125 ** 0.5
    bias = torch.randn(cout // 4, generator=g) * 0.1
    return x, s2d_kernel(k5).to(device), block_bias(bias, 2).to(device)


def library_conv(xn: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """The library conv + bias + ReLU on a channels-last bf16 window:
    ``torch.cudnn_convolution_relu`` on the card, the plain conv on the
    CPU."""
    if xn.device.type != "cuda":
        return conv3x3_ref(xn, w, b, relu=True)
    return torch.cudnn_convolution_relu(xn, w, b, [1, 1], [1, 1], [1, 1], 1)


def make_variants(x: torch.Tensor, w2: torch.Tensor, b4: torch.Tensor
                  ) -> Dict[str, Callable[[], torch.Tensor]]:
    """The three calls on a fixed C-major window, weights prepared once."""
    cl = torch.channels_last
    w_lib = w2.to(torch.bfloat16).contiguous(memory_format=cl)
    b_lib = b4.to(torch.bfloat16) if x.device.type == "cuda" else b4
    prep = (prepare_conv_weights(w2) if x.device.type == "cuda" else None)

    def xla():
        xn = hc.normalize_apply(x.contiguous(memory_format=cl), SHIFT, SCALE)
        return library_conv(xn.contiguous(memory_format=cl), w_lib, b_lib)

    def t1(nchw_out: bool):
        return lambda: hc.head_cmajor(x, w2, b4, shift=SHIFT, scale=SCALE,
                                      nchw_out=nchw_out, prepared=prep)

    return {"xla": xla, "tform": t1(False), "nchw": t1(True)}


def as_nchw(name: str, out: torch.Tensor) -> torch.Tensor:
    """A variant's output as an NCHW-shaped f32 tensor."""
    return (out.permute(0, 3, 1, 2) if name == "tform" else out).float()


def main(argv: Optional[List[str]] = None, *, device=None,
         shape: Sequence[int] = SHAPE, steps: int = STEPS
         ) -> Dict[str, Dict[str, float]]:
    """Run the three variants and print the tool's lines; returns, by
    variant, ``max_abs_diff_vs_xla``, ``absmax`` (of ``xla``'s output) and
    ``ms_per_call`` over a ``steps``-call chain."""
    parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    print(device_line(device), flush=True)
    x, w2, b4 = make_inputs(0, shape, device)
    fns = make_variants(x, w2, b4)
    ref = as_nchw("xla", fns["xla"]())
    absmax = ref.abs().max().item()
    results: Dict[str, Dict[str, float]] = {}
    for name in VARIANTS:
        d = (as_nchw(name, fns[name]()) - ref).abs().max().item()
        ms = time_best(lambda: [fns[name]() for _ in range(steps)], device)
        results[name] = {"max_abs_diff_vs_xla": d, "absmax": absmax,
                         "ms_per_call": ms / steps}
        print(f"  {name:6s}: {ms / steps:7.3f} ms per call, max|d| vs xla "
              f"{d:.3e} (absmax {absmax:.3e})", flush=True)
    return results


if __name__ == "__main__":
    main()
