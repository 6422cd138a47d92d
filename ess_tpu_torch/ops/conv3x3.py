"""Fused 3x3 SAME conv + bias + optional ReLU, exact bf16 or int8.

Counterpart of ``ess_tpu/ops/conv3x3_pallas.py`` (``conv3x3_ref``,
``_quantize_weights``, ``conv3x3_fused`` with the bf16 and the int8
``_conv_kernel``): the E2VID head conv and the first encoder's stride-2
conv in space-to-depth block form (:mod:`ess_tpu_torch.ops.conv_s2d`).
The conv accumulates in f32 (int8: exactly, in i32), adds the f32 bias,
applies the ReLU and rounds once to the input's dtype.

By ``impl`` name:

- ``'pallas'``: the exact conv; on CUDA the kernel of ``csrc/conv3x3.cu``
  on the halo-tile core (tile plan: :func:`conv_halo.conv_plan`);
- ``'pallas_int8'``: per-call absmax scale ``s_x`` for x (over the global
  batch under data parallel), x quantized to s8,
  the weights ``W * s_x`` quantized per output channel, i32 accumulation,
  ``acc * ws + bias``; on CUDA the kernels of ``csrc/conv3x3_int8.cu``:
  two prep launches (x's absmax; the scales and the weight
  re-quantization, :func:`int8_prep`), then the same halo-tile conv with
  s8 operands, which quantizes x as it stages it (tile plan:
  :func:`conv_halo.conv_plan` with ``int8=True``);
  as in the JAX package, only where ``conv_lstm.int8_size_rule`` holds
  (an input of at least 4M elements whose height has a row tile); elsewhere
  it is the exact conv on the route ``'pallas'`` takes
  (``conv_lstm.int8_route``);
- ``'pallas_int8_interpret'``: the int8 conv at every size, as the JAX
  package's ``_interpret`` names skip the size half of its rule (a height
  with no row tile still runs the exact conv);
- ``'xla'``: the plain exact conv on every device (an explicit choice, as
  in the JAX package).

Tensors are NCHW, weights (C_out, C_in, 3, 3). On CPU a conv runs its plain
version. On CUDA a kernel reads bf16 x in channels-last memory
(``torch.channels_last``) and writes a new channels-last tensor; C_in must
be a multiple of 4 and C_out of 8, any H and W. Apart from the JAX
package's int8 rule there is no size gate and no route to the plain version
on CUDA: a shape the kernel does not take raises. The backward of a kernel and of the plain int8 conv recomputes
:func:`conv3x3_ref`, as the JAX package's ``custom_vjp`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ess_tpu_torch.ops import conv_halo
from ess_tpu_torch.ops.conv_lstm import (
    PREP_PARTIALS, _check_aligned, _check_matrix, _div127, global_partials,
    input_scale, int8_route, quantize)
from ess_tpu_torch.parallel import dp

launches = 0        # exact-conv kernel launches (CUDA tensors only)
launches_int8 = 0   # int8-conv kernel launches (CUDA only)
launches_int8_prep = 0   # the int8 convs' prep kernel launches (2 a conv)

IMPLS = ("xla", "pallas", "pallas_int8", "pallas_int8_interpret")
STAGE_ROW_BYTES = 64   # bytes of one input-channel chunk in the kernels


def tap_channels(cin: int, *, int8: bool = False) -> int:
    """Input channels per tap in the prepared matrix: ``cin`` rounded up to
    one 64-byte chunk of the kernel's operand type (32 bf16 or 64 s8
    values); the tail is zero."""
    per = STAGE_ROW_BYTES // (1 if int8 else 2)
    return -(-cin // per) * per


def _check_weight(weight: torch.Tensor) -> None:
    if weight.ndim != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3: weight {tuple(weight.shape)} is not "
                         "(C_out, C_in, 3, 3)")


def prepare_conv_weights(weight: torch.Tensor, *, int8: bool = False
                         ) -> torch.Tensor:
    """(C_out, C_in, 3, 3) weight -> the kernels' (C_out, 9*CP) matrix with
    CP = :func:`tap_channels`: column ``(dy*3 + dx)*CP + cin``, zero for
    ``cin >= C_in``. bf16 for the exact kernel; f32 for the int8 one, which
    re-quantizes it on every call (:func:`quantize_conv_weights`)."""
    _check_weight(weight)
    cout, cin = weight.shape[:2]
    cp = tap_channels(cin, int8=int8)
    w = F.pad(weight.permute(0, 2, 3, 1), (0, cp - cin))
    return w.reshape(cout, 9 * cp).to(
        torch.float32 if int8 else torch.bfloat16).contiguous()


def quantize_conv_weights(w2: torch.Tensor, s_x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the input scale into a (C_out, K) f32 tap matrix and quantize
    per output channel, as the JAX ``_quantize_weights``:
    ``W~ = W * s_x``, ``ws = max(absmax_k W~, 1e-20) / 127``,
    ``wq = clip(round(W~ / ws), -127, 127)``. Returns ``wq`` int8 and ``ws``
    (C_out,) f32."""
    wt = w2.float() * s_x.float()
    ws = _div127(torch.clamp(wt.abs().amax(dim=1), min=1e-20))
    wq = torch.clamp(torch.round(wt / ws[:, None]), -127, 127)
    return wq.to(torch.int8), ws


def int8_prep_ref(x: torch.Tensor, prepared: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the int8 conv's prep kernels, step by step as they
    compute: ``(scal, wq, ws)`` with ``scal = (s_x, 1/s_x)`` (the absmax
    over bf16 bits, then ``max(., 1e-8) / 127`` and the reciprocal, in
    f32) and ``wq`` (C_out, 9*CP) int8, ``ws`` (C_out,) f32 of
    :func:`quantize_conv_weights`. x bf16; ``prepared`` the f32 tap matrix
    of ``prepare_conv_weights(w, int8=True)``."""
    bits = x.contiguous().view(torch.int16).to(torch.int32) & 0x7FFF
    amax = dp.all_max((bits.max() << 16).view(torch.float32))
    s_x = _div127(torch.clamp(amax, min=1e-8))
    return (torch.stack([s_x, torch.reciprocal(s_x)]),
            *quantize_conv_weights(prepared, s_x))


def _finish(out: torch.Tensor, relu: bool, dtype: torch.dtype) -> torch.Tensor:
    return (torch.relu(out) if relu else out).to(dtype)


def conv3x3_ref(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], *, relu: bool) -> torch.Tensor:
    """Plain 3x3 SAME conv: f32 accumulation of operands rounded to x's
    dtype, f32 bias, ReLU, then one rounding to x's dtype."""
    _check_weight(weight)
    out = F.conv2d(x.float(), weight.to(x.dtype).float(),
                   None if bias is None else bias.float(), padding=1)
    return _finish(out, relu, x.dtype)


def conv3x3_int8_ref(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], *, relu: bool
                     ) -> torch.Tensor:
    """Plain int8 conv (the JAX ``_conv_kernel`` with ``int8=True``): x
    quantized by ``1/s_x`` (:func:`input_scale`), the weights by
    :func:`quantize_conv_weights`; the integer conv runs in float64, where
    every partial sum is exact (|acc| reaches 9*C_in*127^2 > 2^24 at
    C_in = 128, beyond f32's integers); then ``f32(acc) * ws + bias``,
    ReLU and one rounding to x's dtype."""
    _check_weight(weight)
    cout, cin = weight.shape[:2]
    s_x = input_scale(x)
    xq = quantize(x, torch.reciprocal(s_x))
    wq, ws = quantize_conv_weights(
        weight.permute(0, 2, 3, 1).reshape(cout, 9 * cin), s_x)
    w_conv = wq.view(cout, 3, 3, cin).permute(0, 3, 1, 2)
    acc = F.conv2d(xq.double(), w_conv.double(), padding=1)
    out = acc.float() * ws[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return _finish(out, relu, x.dtype)


def _check_x(name: str, x: torch.Tensor) -> None:
    if (x.dtype != torch.bfloat16
            or not x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{name}: x must be a channels-last bfloat16 tensor,"
                         f" got {x.dtype} {tuple(x.shape)} with strides "
                         f"{x.stride()}")


def _check_operands(name: str, x: torch.Tensor, weight: torch.Tensor
                    ) -> Tuple[int, ...]:
    b, cin, hh, ww = x.shape
    cout = weight.shape[0]
    _check_x(name, x)
    if weight.shape[1] != cin:
        raise ValueError(f"{name}: weight {tuple(weight.shape)} does not "
                         f"take {cin} input channels")
    if cin % 4 or cout % 8:
        raise ValueError(f"{name}: C_in={cin} must be a multiple of 4 and "
                         f"C_out={cout} of 8")
    return b, cin, hh, ww, cout


def _bias_vector(name: str, bias: Optional[torch.Tensor], n: int, device
                 ) -> torch.Tensor:
    if bias is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    bias = bias.detach().to(device=device, dtype=torch.float32).contiguous()
    if tuple(bias.shape) != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != {(n,)}")
    return bias


def _launch_exact(x, weight, bias, relu, prepared):
    name = "conv3x3_fused"
    b, cin, hh, ww, cout = _check_operands(name, x, weight)
    if prepared is None:
        prepared = prepare_conv_weights(weight.detach())
    _check_matrix(name, prepared, torch.bfloat16,
                  (cout, 9 * tap_channels(cin)), x.device)
    bias = _bias_vector(name, bias, cout, x.device)
    out = torch.empty((b, cout, hh, ww), dtype=torch.bfloat16,
                      device=x.device, memory_format=torch.channels_last)
    _check_aligned(name, x, prepared, out)
    from ess_tpu_torch import kernels

    global launches
    plan = conv_halo.conv_plan(b, hh, ww, cin, cout,
                               sm_count=conv_halo.sm_count(x.device))
    lib = kernels.get_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ess_conv3x3(x.data_ptr(), prepared.data_ptr(), bias.data_ptr(),
                          out.data_ptr(), b, hh, ww, cin, cout, int(relu),
                          plan.th, plan.tw, int(plan.resident), plan.grid_x,
                          plan.smem, stream)
    kernels.check(err, "conv3x3 kernel")
    launches += 1
    return out


def int8_prep(x: torch.Tensor, prepared: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 conv's prep on CUDA tensors, two kernel launches (counted
    in ``launches_int8_prep``), no host sync: ``(scal, wq, ws)`` as
    :func:`int8_prep_ref` returns them. x: channels-last bf16;
    ``prepared``: ``prepare_conv_weights(w, int8=True)``."""
    global launches_int8_prep
    name = "conv3x3_fused int8 prep"
    _check_x(name, x)
    b, cin, hh, ww = x.shape
    cout = prepared.shape[0]
    _check_matrix(name, prepared, torch.float32,
                  (cout, 9 * tap_channels(cin, int8=True)), x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    partials = torch.empty(PREP_PARTIALS, **f32)
    scal = torch.empty(2, **f32)
    wq = torch.empty(prepared.shape, dtype=torch.int8, device=x.device)
    ws = torch.empty(cout, **f32)
    _check_aligned(name, x, prepared, wq)
    from ess_tpu_torch import kernels

    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = kernels.get_lib().ess_conv3x3_int8_prep(
        x.data_ptr(), prepared.data_ptr(), partials.data_ptr(),
        global_partials(x, partials, stream), scal.data_ptr(),
        wq.data_ptr(), ws.data_ptr(), b, hh, ww, cin, cout, stream)
    kernels.check(err, "conv3x3 int8 prep kernels")
    launches_int8_prep += 2
    return scal, wq, ws


def _launch_int8(x, weight, bias, relu, prepared):
    name = "conv3x3_fused int8"
    b, cin, hh, ww, cout = _check_operands(name, x, weight)
    if prepared is None:
        prepared = prepare_conv_weights(weight.detach(), int8=True)
    _check_matrix(name, prepared, torch.float32,
                  (cout, 9 * tap_channels(cin, int8=True)), x.device)
    bias = _bias_vector(name, bias, cout, x.device)
    out = torch.empty((b, cout, hh, ww), dtype=torch.bfloat16,
                      device=x.device, memory_format=torch.channels_last)
    _check_aligned(name, out)
    scal, wq, ws = int8_prep(x, prepared)
    from ess_tpu_torch import kernels

    global launches_int8
    plan = conv_halo.conv_plan(b, hh, ww, cin, cout, int8=True,
                               sm_count=conv_halo.sm_count(x.device))
    err = kernels.get_lib().ess_conv3x3_int8(
        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), scal.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, hh, ww, cin, cout, int(relu),
        plan.th, plan.tw, int(plan.resident), plan.q_stages, plan.grid_x,
        plan.smem, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "conv3x3 int8 kernel")
    launches_int8 += 1
    return out


class _RecomputeBackward(torch.autograd.Function):
    """A conv whose forward is ``fn`` (a kernel, or the plain int8 conv) and
    whose backward differentiates :func:`conv3x3_ref` at the saved inputs,
    as the JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, weight, bias, relu, fn):
        ctx.relu = relu
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight, *((bias,) if ctx.has_bias else ()))
        return fn(x, weight, bias)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:len(saved)]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = conv3x3_ref(ins[0], ins[1],
                              ins[2] if ctx.has_bias else None, relu=ctx.relu)
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(out, wanted, dout))
        grads = [next(got) if n else None for n in need]
        return (*grads, *(() if ctx.has_bias else (None,)), None, None)


_LAUNCH = {"pallas": _launch_exact, "pallas_int8": _launch_int8}


def conv3x3_fused(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], *, relu: bool = True,
                  impl: str = "xla",
                  prepared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 SAME conv + bias + optional ReLU with ``impl`` (module
    docstring); x (B, C_in, H, W), ``weight`` (C_out, C_in, 3, 3).

    CPU tensors, or ``impl='xla'``: the plain version of the conv. CUDA
    tensors: the conv's kernel, at any H and W. ``prepared`` is
    ``prepare_conv_weights(weight)`` for the exact kernel and
    ``prepare_conv_weights(weight, int8=True)`` for the int8 one, computed
    here when not given (prepare for the name ``conv_lstm.int8_route``
    gives at x's shape: ``'pallas_int8'`` below the JAX size rule is the
    exact conv). Gradients of the kernels and of the plain int8 conv are
    those of :func:`conv3x3_ref`. A kernel that is not 3x3 raises.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown conv impl {impl!r}; expected one of "
                         f"{IMPLS}")
    _check_weight(weight)
    impl = int8_route(impl, x.shape)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_fused: unsupported device {x.device}")
    if impl == "xla" or (x.device.type == "cpu" and impl == "pallas"):
        return conv3x3_ref(x, weight, bias, relu=relu)
    if x.device.type == "cpu":
        fn = lambda x_, w_, b_: conv3x3_int8_ref(x_, w_, b_, relu=relu)
    else:
        fn = lambda x_, w_, b_: _LAUNCH[impl](x_, w_, b_, relu, prepared)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias))
    if grad:
        return _RecomputeBackward.apply(x, weight, bias, relu, fn)
    return fn(x, weight, bias)
