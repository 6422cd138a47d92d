"""Arithmetic precision of the plain reference.

``F32`` is the reference itself: float32 with TF32 off (set by
:func:`f32_matmuls`). ``Lowered`` is its control, the reference computed
one precision below the configuration's: every conv's input and weight
rounded to float8 e4m3 (the step below bfloat16), and where the
configuration runs a layer in int8 (the int8 ConvLSTM cells of the train
rollout), that layer's operands rounded to int4 (the step below int8).
Both roundings scale per tensor by its absolute maximum; the rounding is
applied in the forward pass and passed straight through in the backward
pass.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

FP8_MAX = 448.0     # largest finite float8 e4m3 value
INT4_MAX = 7.0


@contextlib.contextmanager
def f32_matmuls():
    """Run float32 convolutions and matmuls in float32, not TF32, inside
    the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _straight_through(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return _straight_through(x, q)


def round_int4(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to symmetric int4 at a per-tensor scale."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = INT4_MAX / amax
    q = torch.round(x.detach() * scale).clamp(-INT4_MAX, INT4_MAX) / scale
    return _straight_through(x, q)


@dataclass(frozen=True)
class Precision:
    """How the reference rounds a conv's operands: ``lowered`` False is
    float32; True rounds bf16 layers to fp8 and int8 layers to int4."""

    lowered: bool = False

    def operands(self, x: torch.Tensor, w: torch.Tensor, *,
                 int8_layer: bool = False):
        if not self.lowered:
            return x, w
        fn = round_int4 if int8_layer else round_fp8
        return fn(x), fn(w)


F32 = Precision(False)
LOWERED = Precision(True)
