"""Fused ConvLSTM cell: 3x3 gate conv over concat(x, h) + LSTM pointwise.

Counterpart of ``ess_tpu/ops/conv_lstm_pallas.py`` (``conv_lstm_ref``,
``pick_row_tile``, ``quant_cols``/``quantize_gate_weights``,
``resolve_lstm_impl`` and ``conv_lstm_cell`` with the exact bf16 and the
int8 ``_fused_kernel``).
Gate order is i, f, o, g over the output channels of one conv on
``concat([x, h])``: ``c' = sigmoid(f) * c + sigmoid(i) * tanh(g)``,
``h' = sigmoid(o) * tanh(c')``, gates accumulated in f32 (exact cell) or
int32 (int8 cell).

Cells, by resolved ``impl`` name (:func:`resolve_lstm_impl`):

- ``'pallas'``: the exact cell; on CUDA the kernel of ``csrc/conv_lstm.cu``;
- ``'pallas_int8'``: the int8 cell (per-call absmax scale for x, static
  1/127 for h, per-output-channel weight scales); on CUDA the kernels of
  ``csrc/conv_lstm_int8.cu``;
- ``'xla'``: the plain exact cell on every device (an explicit choice, as
  in the JAX package).

Tensors are NCHW. On CPU a cell runs its plain version. On CUDA a kernel
reads x, h and c in channels-last memory (``torch.channels_last``) and
bf16, writes h' to a new tensor and updates c in place; under autograd the
kernel runs on a copy of c. The backward of a kernel and of the plain int8
cell recomputes :func:`conv_lstm_ref`, as the JAX package's ``custom_vjp``
does.

The kernels also exist with their epilogue or their operand gather replaced
at compile time (``MODES``, :func:`launch_variant`): the attribution
variants that ``ess_tpu_torch/tools/bench_lstm_breakdown.py`` times.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

launches = 0        # exact-cell kernel launches (CUDA tensors only)
launches_int8 = 0   # int8-cell launches, quantize pre-pass + GEMM (CUDA only)
launches_variant = 0   # launches of a kernel in a mode other than 'full'

# Compile-time variants of the two cell kernels, by the index the CUDA entry
# points take: 'full' is the cell itself.
MODES = ("full", "ptw_bf16", "ptw_mul", "no_ptw", "no_build")

GATE_GROUP = 8   # channels per gate run in the prepared weight columns
IMPLS = ("auto", "xla", "pallas", "pallas_int8")


def resolve_lstm_impl(requested: str) -> str:
    """``'auto'`` -> ``'pallas'``; validates the explicit names. The device
    decides at call time whether a kernel or its plain version runs."""
    if requested not in IMPLS:
        raise ValueError(f"unknown lstm_impl {requested!r}; expected one of "
                         f"{IMPLS}")
    return "pallas" if requested == "auto" else requested


def pick_row_tile(height: int, lo: int = 2, hi: int = 24) -> Optional[int]:
    """Divisor of ``height`` in [lo, hi] closest to 22 (the larger wins a
    tie), or None. The CUDA cell kernels tile pixels, not rows, and do not
    use it; the fused encoder level (:mod:`ess_tpu_torch.ops.level`)
    quantizes per (sample, row tile of this height), so its result depends
    on this choice and the port keeps the JAX package's."""
    cands = [t for t in range(lo, hi + 1) if height % t == 0]
    if not cands:
        return None
    return min(cands, key=lambda t: (abs(t - 22), -t))


def quant_cols(w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) f32 -> int8 weights quantized per column (output channel) and
    the (N,) f32 column scales ``max(absmax_k, 1e-20) / 127``; the weights
    are divided by the scale, then rounded half to even and clipped."""
    ws = torch.clamp(w2.abs().amax(dim=0), min=1e-20) / 127.0
    wq = torch.clamp(torch.round(w2 / ws), -127, 127).to(torch.int8)
    return wq, ws


@functools.lru_cache(maxsize=None)
def gate_column_order(ch: int, device=None) -> torch.Tensor:
    """Column order of the prepared gate matrix: prepared column
    ``(c // 8) * 32 + gate * 8 + c % 8`` holds original column
    ``gate * ch + c``, so each 32-column group carries all four gates of 8
    channels. Built once per ``(ch, device)``: the int8 cell indexes with it
    on every call, and a host-to-device copy per call would synchronize the
    stream. Callers must not modify it."""
    n = torch.arange(4 * ch)
    grp, within = n // (4 * GATE_GROUP), n % (4 * GATE_GROUP)
    gate, c = within // GATE_GROUP, grp * GATE_GROUP + within % GATE_GROUP
    return (gate * ch + c).to(device)


def prepare_gate_weights(weight: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(4*CH, CIN, 3, 3) gate conv weight -> (4*CH, 9*CIN) ``dtype`` matrix
    for the CUDA kernels: row ``n`` is prepared gate column ``n``
    (:func:`gate_column_order`), column ``(dy*3 + dx)*CIN + cin``."""
    cout, cin, kh, kw = weight.shape
    if (kh, kw) != (3, 3) or cout % 4:
        raise ValueError(f"gate conv weight {tuple(weight.shape)} is not "
                         "(4*CH, CIN, 3, 3)")
    w2 = weight.permute(0, 2, 3, 1).reshape(cout, 9 * cin)
    order = gate_column_order(cout // 4, weight.device)
    return w2[order].to(dtype).contiguous()


def input_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-call x scale ``max(absmax(x), 1e-8) / 127`` as an f32 device
    scalar (no host sync)."""
    return torch.clamp(x.abs().amax().float(), min=1e-8) / 127.0


def quantize_gate_weights(weight: torch.Tensor, s_x: torch.Tensor, cx: int,
                          *, prepared: torch.Tensor | None = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the input scales into the gate matrix and quantize per output
    channel, as the JAX ``quantize_gate_weights``: ``W~[k, n] = W[k, n] *
    s(k)`` with ``s = s_x`` on x rows and ``1/127`` on h rows, then
    ``ws = max(absmax_k W~, 1e-20) / 127`` and
    ``wq = clip(round(W~ / ws), -127, 127)``.

    Returns ``wq`` (4*CH, 9*CIN) int8 in prepared row order (the kernel's
    B matrix) and ``ws`` (4*CH,) f32 in the original i, f, o, g column
    order. ``prepared`` is ``prepare_gate_weights(weight, torch.float32)``.
    """
    w = (prepared if prepared is not None
         else prepare_gate_weights(weight, torch.float32))
    cin = w.shape[1] // 9
    is_x = (torch.arange(cin, device=w.device) < cx).repeat(9)
    row_scale = torch.where(is_x, s_x.float(), 1.0 / 127.0)
    wt = w * row_scale
    ws_perm = torch.clamp(wt.abs().amax(dim=1), min=1e-20) / 127.0
    wq = torch.clamp(torch.round(wt / ws_perm[:, None]), -127, 127)
    ws = torch.empty_like(ws_perm)
    ws[gate_column_order(w.shape[0] // 4, w.device)] = ws_perm
    return wq.to(torch.int8), ws


def quantize(v: torch.Tensor, inv_scale) -> torch.Tensor:
    """``clip(round(v * inv_scale), -127, 127)`` as int8, in f32 with ties
    to even (``jnp.round``, ``__float2int_rn``)."""
    return torch.clamp(torch.round(v.float() * inv_scale), -127, 127).to(
        torch.int8)


def _pointwise(gates: torch.Tensor, c_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    i, f, o, g = torch.chunk(gates, 4, dim=1)
    c_new = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def conv_lstm_ref(x: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ConvLSTM cell: the gate conv runs in f32 on operands rounded to
    x's dtype (f32 accumulation of bf16 products), the pointwise in f32;
    h' returns in x's dtype and c' in c_prev's."""
    h_new, c_new = _pointwise(gates_ref(x, h_prev, weight, bias), c_prev)
    return h_new.to(x.dtype), c_new.to(c_prev.dtype)


def gates_ref(x: torch.Tensor, h_prev: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The f32 gates (B, 4*CH, H, W; i, f, o, g) of the plain exact cell."""
    xh = torch.cat([x, h_prev.to(x.dtype)], dim=1)
    return F.conv2d(xh.float(), weight.to(x.dtype).float(), bias.float(),
                    padding=1)


def conv_lstm_int8_ref(x: torch.Tensor, h_prev: torch.Tensor,
                       c_prev: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain int8 ConvLSTM cell (the JAX ``_fused_kernel`` with
    ``int8=True``): x quantized by ``1/s_x`` (:func:`input_scale`), h
    (rounded to x's dtype) by 127, the weights by
    :func:`quantize_gate_weights`; the integer 3x3 conv runs in float64,
    where every partial sum is exact (|acc| reaches 9*CIN*127^2 ~ 7.4e7 >
    2^24 at CIN = 512, beyond f32's integers); then
    ``gates = f32(acc) * ws + bias`` and the pointwise in f32. h' returns
    in x's dtype and c' in c_prev's."""
    h_new, c_new = _pointwise(gates_int8_ref(x, h_prev, weight, bias),
                              c_prev)
    return h_new.to(x.dtype), c_new.to(c_prev.dtype)


def unpermute_gate_rows(wq: torch.Tensor, cin: int) -> torch.Tensor:
    """A prepared (4*CH, 9*cin) gate matrix (:func:`gate_column_order` row
    order) -> the (4*CH, cin, 3, 3) conv weight in i, f, o, g order."""
    n = wq.shape[0]
    w_conv = torch.empty_like(wq)
    w_conv[gate_column_order(n // 4, wq.device)] = wq
    return w_conv.view(n, 3, 3, cin).permute(0, 3, 1, 2)


def gates_int8_ref(x: torch.Tensor, h_prev: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The f32 gates of the plain int8 cell: ``f32(acc) * ws + bias``."""
    cx, ch = x.shape[1], h_prev.shape[1]
    s_x = input_scale(x)
    xq = quantize(x, torch.reciprocal(s_x))
    hq = quantize(h_prev.to(x.dtype), 127.0)
    wq, ws = quantize_gate_weights(weight, s_x, cx)
    acc = F.conv2d(torch.cat([xq, hq], dim=1).double(),
                   unpermute_gate_rows(wq, cx + ch).double(), padding=1)
    return (acc.float() * ws[None, :, None, None]
            + bias.float()[None, :, None, None])


def _check_operands(name: str, x, h_prev, c_prev) -> Tuple[int, ...]:
    b, cx, hh, ww = x.shape
    ch = h_prev.shape[1]
    for what, t, cc in (("x", x, cx), ("h_prev", h_prev, ch),
                        ("c_prev", c_prev, ch)):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (b, cc, hh, ww)
                or not t.is_contiguous(memory_format=torch.channels_last)
                or t.device != x.device):
            raise ValueError(
                f"{name}: {what} must be a channels-last bfloat16 "
                f"{(b, cc, hh, ww)} tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)}")
    if c_prev.data_ptr() == h_prev.data_ptr():
        raise ValueError(f"{name}: h_prev and c_prev share storage "
                         "(c is updated in place while h is read)")
    if cx % 32 or ch % 32:
        raise ValueError(f"{name}: CX={cx} and CH={ch} must be multiples "
                         "of 32")
    return b, cx, hh, ww, ch


def _check_matrix(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name}: prepared weights must be a contiguous "
                         f"{dtype} {shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _check_aligned(name: str, *ts: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: operands must be 16-byte aligned "
                         "(cp.async)")


def _f32_vector(name: str, v: torch.Tensor, n: int, device) -> torch.Tensor:
    v = v.to(device=device, dtype=torch.float32).contiguous()
    if tuple(v.shape) != (n,):
        raise ValueError(f"{name}: vector {tuple(v.shape)} != {(n,)}")
    return v


def _count_launch(int8: bool, mode: int) -> None:
    global launches, launches_int8, launches_variant
    if mode:
        launches_variant += 1
    elif int8:
        launches_int8 += 1
    else:
        launches += 1


def _launch_exact(x, h_prev, c_prev, weight, bias, prepared, mode=0):
    """Exact kernel (in variant ``MODES[mode]``); returns (h', c_prev
    updated in place)."""
    b, cx, hh, ww, ch = _check_operands("conv_lstm_cell", x, h_prev, c_prev)
    if prepared is None:
        prepared = prepare_gate_weights(weight)
    _check_matrix("conv_lstm_cell", prepared, torch.bfloat16,
                  (4 * ch, 9 * (cx + ch)), x.device)
    _check_aligned("conv_lstm_cell", x, h_prev, c_prev, prepared)
    bias = _f32_vector("conv_lstm_cell bias", bias, 4 * ch, x.device)
    from ess_tpu_torch import kernels

    lib = kernels.get_lib()
    h_new = torch.empty_like(h_prev, memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
            prepared.data_ptr(), bias.data_ptr(), h_new.data_ptr(), b, hh, ww,
            cx, ch)
    err = (lib.ess_conv_lstm_mode(*args, mode, stream) if mode
           else lib.ess_conv_lstm(*args, stream))
    kernels.check(err, f"conv_lstm kernel ({MODES[mode]})")
    _count_launch(False, mode)
    return h_new, c_prev


def _launch_int8(x, h_prev, c_prev, weight, bias, prepared, mode=0):
    """Int8 kernels (quantize pre-pass + GEMM, the GEMM in variant
    ``MODES[mode]``); returns (h', c_prev updated in place). ``prepared``
    is the f32 prepared gate matrix."""
    name = "conv_lstm_int8_cell"
    b, cx, hh, ww, ch = _check_operands(name, x, h_prev, c_prev)
    if prepared is None:
        prepared = prepare_gate_weights(weight, torch.float32)
    _check_matrix(name, prepared, torch.float32, (4 * ch, 9 * (cx + ch)),
                  x.device)
    s_x = input_scale(x)
    inv_sx = torch.reciprocal(s_x)
    wq, ws = quantize_gate_weights(weight, s_x, cx, prepared=prepared)
    bias = _f32_vector(f"{name} bias", bias, 4 * ch, x.device)
    xq = torch.empty((b, hh, ww, cx), dtype=torch.int8, device=x.device)
    hq = torch.empty((b, hh, ww, ch), dtype=torch.int8, device=x.device)
    _check_aligned(name, x, h_prev, c_prev, wq, xq, hq)
    from ess_tpu_torch import kernels

    lib = kernels.get_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ess_conv_lstm_quant(x.data_ptr(), h_prev.data_ptr(),
                                  inv_sx.data_ptr(), xq.data_ptr(),
                                  hq.data_ptr(), xq.numel(), hq.numel(),
                                  stream)
    kernels.check(err, "conv_lstm int8 quantize kernel")
    h_new = torch.empty_like(h_prev, memory_format=torch.channels_last)
    args = (xq.data_ptr(), hq.data_ptr(), c_prev.data_ptr(), wq.data_ptr(),
            ws.data_ptr(), bias.data_ptr(), h_new.data_ptr(), b, hh, ww, cx,
            ch)
    err = (lib.ess_conv_lstm_int8_mode(*args, mode, stream) if mode
           else lib.ess_conv_lstm_int8(*args, stream))
    kernels.check(err, f"conv_lstm int8 kernel ({MODES[mode]})")
    _count_launch(True, mode)
    return h_new, c_prev


def launch_variant(x: torch.Tensor, h_prev: torch.Tensor,
                   c_prev: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, *, mode: str, int8: bool,
                   prepared: torch.Tensor | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the exact or the int8 cell kernel on CUDA tensors with its
    epilogue or operand gather replaced as ``mode`` (one of ``MODES``)
    says; operands and ``prepared`` as :func:`conv_lstm_cell` takes them.
    Returns (h', c' in ``c_prev``'s storage). ``'full'`` is the cell itself
    and counts as its launch; every other mode counts in
    ``launches_variant``. No autograd, no CPU route."""
    if mode not in MODES:
        raise ValueError(f"unknown cell mode {mode!r}; expected one of "
                         f"{MODES}")
    if x.device.type != "cuda":
        raise ValueError(f"launch_variant: the kernels run on CUDA tensors, "
                         f"got {x.device}")
    fn = _launch_int8 if int8 else _launch_exact
    return fn(x, h_prev, c_prev, weight, bias, prepared, MODES.index(mode))


class _RecomputeBackward(torch.autograd.Function):
    """A cell whose forward is ``fn`` (a kernel, or the plain int8 cell)
    and whose backward differentiates :func:`conv_lstm_ref` at the saved
    inputs, as the JAX package's ``custom_vjp``. ``fn`` must leave its
    inputs intact (a kernel gets a copy of c)."""

    @staticmethod
    def forward(ctx, x, h_prev, c_prev, weight, bias, fn):
        ctx.save_for_backward(x, h_prev, c_prev, weight, bias)
        return fn(x, h_prev, c_prev, weight, bias)

    @staticmethod
    def backward(ctx, dh, dc):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            outs = conv_lstm_ref(*ins)
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(outs, wanted, (dh, dc)))
        return (*(next(got) if n else None for n in need), None)


_LAUNCH = {"pallas": _launch_exact, "pallas_int8": _launch_int8}


def conv_lstm_cell(x: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor, *,
                   impl: str = "pallas",
                   prepared: torch.Tensor | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvLSTM cell update with the resolved ``impl`` (module docstring);
    returns (h', c').

    CPU tensors, or ``impl='xla'``: the plain version of the cell. CUDA
    tensors: the cell's kernel, which needs bf16 channels-last x
    (B, CX, H, W), h and c (B, CH, H, W) with CX and CH multiples of 32,
    and returns c' in ``c_prev``'s storage (outside autograd). ``prepared``
    is ``prepare_gate_weights(weight)`` for the exact kernel and
    ``prepare_gate_weights(weight, torch.float32)`` for the int8 one,
    computed here when not given. Gradients of the kernels and of the
    plain int8 cell are those of :func:`conv_lstm_ref`.
    """
    if impl not in ("xla", "pallas", "pallas_int8"):
        raise ValueError(f"conv_lstm_cell: impl {impl!r} is not a resolved "
                         "name (see resolve_lstm_impl)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_lstm_cell: unsupported device {x.device}")
    if impl == "xla" or (x.device.type == "cpu" and impl == "pallas"):
        return conv_lstm_ref(x, h_prev, c_prev, weight, bias)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, h_prev, c_prev, weight, bias))
    if x.device.type == "cpu":
        fn = conv_lstm_int8_ref
    elif not grad:
        return _LAUNCH[impl](x, h_prev, c_prev, weight, bias, prepared)
    else:   # the kernel updates c in place: give it a copy of c_prev
        fn = (lambda x_, h_, c_, w_, b_: _LAUNCH[impl](
            x_, h_, c_.clone(memory_format=torch.channels_last), w_, b_,
            prepared))
    if grad:
        return _RecomputeBackward.apply(x, h_prev, c_prev, weight, bias, fn)
    return fn(x, h_prev, c_prev, weight, bias)
