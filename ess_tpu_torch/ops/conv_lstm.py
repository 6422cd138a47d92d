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
- ``'pallas_int8'``: the int8 cell (per-call absmax scale for x, over the
  global batch under data parallel (:func:`global_partials`), static
  1/127 for h, per-output-channel weight scales); on CUDA the kernels of
  ``csrc/conv_lstm_int8.cu``: two prep launches (x's absmax; the weight
  re-quantization and the x/h quantize), then the cell. As in the JAX
  package, only where :func:`int8_size_rule` holds (a cell input of at
  least 4M elements whose height has a row tile); elsewhere
  ``'pallas_int8'`` is the exact cell, on the exact kernel on CUDA
  (:func:`int8_route`);
- ``'pallas_int8_interpret'``: the int8 cell at every size, as the JAX
  package's ``_interpret`` names skip the size half of its rule (tests
  compare the int8 math at small shapes with it); a height with no row tile
  still runs the exact cell, as there;
- ``'xla'``: the plain exact cell on every device (an explicit choice, as
  in the JAX package).

Tensors are NCHW. On CPU a cell runs its plain version. On CUDA a kernel
reads x, h and c in channels-last memory (``torch.channels_last``) and
bf16, writes h' to a new tensor and updates c in place; under autograd the
kernel runs on a copy of c. Both cell kernels run on the halo-tile core
(``csrc/conv_halo.cuh``) with the plan of ``ops/conv_halo.py::cell_plan``
and read the gate weights as the kernel's own image
(:func:`gate_weight_image`, or the int8 prep's). The backward of a kernel
and of the plain int8 cell recomputes :func:`conv_lstm_ref`, as the JAX
package's ``custom_vjp`` does.

The kernels also exist with their epilogue or their operand gather replaced
at compile time (``MODES``, :func:`launch_variant`): the attribution
variants that ``ess_tpu_torch/tools/bench_lstm_breakdown.py`` times.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ess_tpu_torch.ops import conv_halo
from ess_tpu_torch.parallel import dp

launches = 0        # exact-cell kernel launches (CUDA tensors only)
launches_int8 = 0   # int8-cell kernel launches (CUDA only)
launches_int8_prep = 0   # the int8 cells' prep kernel launches (2 a cell)
launches_variant = 0   # launches of a kernel in a mode other than 'full'

PREP_PARTIALS = 512   # absmax partials of the int8 prep (its kMaxPartials)
INT8_KC = 64          # int8 channels per chunk (64 bytes a halo pixel)

# Compile-time variants of the two cell kernels, by the index the CUDA entry
# points take: 'full' is the cell itself.
MODES = ("full", "ptw_bf16", "ptw_mul", "no_ptw", "no_build")

GATE_GROUP = 8   # channels per gate run in the prepared weight columns
IMPLS = ("auto", "xla", "pallas", "pallas_int8", "pallas_int8_interpret")
INT8_MIN_ELEMENTS = 4_000_000   # the JAX package's size rule for int8


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


def int8_size_rule(shape) -> bool:
    """The JAX package's rule for its ``'pallas_int8'`` cell and block conv
    (``conv_lstm_cell``, ``conv3x3_fused``): the int8 kernel runs iff the
    input has at least :data:`INT8_MIN_ELEMENTS` elements and
    :func:`pick_row_tile` finds a row tile of its height; elsewhere the JAX
    package computes the exact function. ``shape`` is the input's NCHW
    shape (H is ``shape[2]``). The JAX rule also asks for a 3x3 kernel,
    which is the only kernel the port's cells and block convs accept."""
    return (math.prod(shape) >= INT8_MIN_ELEMENTS
            and pick_row_tile(shape[2]) is not None)


def int8_route(impl: str, shape) -> str:
    """The function an op of resolved name ``impl`` computes on an input of
    NCHW ``shape``: ``'pallas_int8'`` below :func:`int8_size_rule` is the
    exact ``'pallas'``; ``'pallas_int8_interpret'`` skips the rule's size
    half only, as the JAX package's ``_interpret`` names do, so it is
    ``'pallas_int8'`` wherever :func:`pick_row_tile` finds a row tile and
    ``'pallas'`` elsewhere; other names are unchanged. Under data parallel
    the rule reads the global batch's shape (``dp.global_shape``), as the
    JAX package traces it, so every rank routes alike."""
    shape = dp.global_shape(shape)
    if impl == "pallas_int8_interpret":
        return "pallas_int8" if pick_row_tile(shape[2]) is not None \
            else "pallas"
    if impl == "pallas_int8" and not int8_size_rule(shape):
        return "pallas"
    return impl


def quant_cols(w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) f32 -> int8 weights quantized per column (output channel) and
    the (N,) f32 column scales ``max(absmax_k, 1e-20) / 127``; the weights
    are divided by the scale, then rounded half to even and clipped. The
    scale is one IEEE division on every device (:func:`_div127`)."""
    ws = _div127(torch.clamp(w2.abs().amax(dim=0), min=1e-20))
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


def _weight_image(p: torch.Tensor, cx: int, kc: int) -> torch.Tensor:
    """A prepared (4*CH, 9*CIN) matrix -> the cell kernels' weight image
    ``(4*CH/128, chunks, 36, 128, kc/4)``: per N tile of 128 prepared
    columns and chunk of ``kc`` channels (x's channels padded with zeros to
    a multiple of ``kc``, then h's), the 36 k groups (tap x 4 pieces of
    ``kc/4`` channels) of wgmma's K-major core matrices, each 128 rows of
    16 bytes: one contiguous stage a bulk copy moves as it is."""
    n, cin = p.shape[0], p.shape[1] // 9
    ch = cin - cx
    cxp, chp = -(-cx // kc) * kc, -(-ch // kc) * kc
    w = p.reshape(n, 9, cin)
    if (cxp, chp) != (cx, ch):
        pad = w.new_zeros(n, 9, cxp + chp)
        pad[:, :, :cx] = w[:, :, :cx]
        pad[:, :, cxp:cxp + ch] = w[:, :, cx:]
        w = pad
    chunks = (cxp + chp) // kc
    nb = conv_halo.CELL_BN
    return (w.reshape(n // nb, nb, 9, chunks, 4, kc // 4)
            .permute(0, 3, 2, 4, 1, 5)
            .reshape(n // nb, chunks, 36, nb, kc // 4).contiguous())


def gate_weight_image(prepared: torch.Tensor) -> torch.Tensor:
    """The exact cell kernel's weight image from
    ``prepare_gate_weights(weight)``: ``(4*CH/128, (CX+CH)/32, 36, 128, 8)``
    bf16 (CX and CH multiples of 32, so x's and h's 32-channel chunks are
    those of concat(x, h))."""
    return _weight_image(prepared, 0, 32)


def prepare_cell_weights(weight: torch.Tensor, impl: str) -> torch.Tensor:
    """What a cell kernel reads of a gate conv weight, computed once per
    weight: the exact kernel's bf16 image (:func:`gate_weight_image`) for
    ``'pallas'``, the f32 prepared matrix the int8 prep re-quantizes per
    call for ``'pallas_int8'`` (and ``'pallas_int8_interpret'``). Prepare
    for the cell a shape runs: :func:`int8_route`."""
    if impl in ("pallas_int8", "pallas_int8_interpret"):
        return prepare_gate_weights(weight, torch.float32)
    return gate_weight_image(prepare_gate_weights(weight))


def _div127(v: torch.Tensor) -> torch.Tensor:
    """``v / 127`` rounded once (IEEE division) on every device: a CUDA
    division by a Python scalar multiplies by its reciprocal instead, which
    differs in the last bit for some ``v``."""
    return torch.div(v, torch.full((), 127.0, device=v.device))


def input_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-call x scale ``max(absmax(x), 1e-8) / 127`` as an f32 device
    scalar (no host sync); under data parallel the absmax of the global
    batch (``dp.all_max``)."""
    return _div127(torch.clamp(dp.all_max(x.abs().amax().float()),
                               min=1e-8))


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
    ws_perm = _div127(torch.clamp(wt.abs().amax(dim=1), min=1e-20))
    wq = torch.clamp(torch.round(wt / ws_perm[:, None]), -127, 127)
    ws = torch.empty_like(ws_perm)
    ws[gate_column_order(w.shape[0] // 4, w.device)] = ws_perm
    return wq.to(torch.int8), ws


def quantize(v: torch.Tensor, inv_scale) -> torch.Tensor:
    """``clip(round(v * inv_scale), -127, 127)`` as int8, in f32 with ties
    to even (``jnp.round``, ``__float2int_rn``)."""
    return torch.clamp(torch.round(v.float() * inv_scale), -127, 127).to(
        torch.int8)


def int8_prep_ref(x: torch.Tensor, h_prev: torch.Tensor,
                  prepared: torch.Tensor, cx: int) -> Tuple[torch.Tensor, ...]:
    """Plain version of the int8 cell's prep kernels, step by step as they
    compute: ``(scal, w_img, ws, xq, hq)`` with ``scal = (s_x, 1/s_x)``
    (the absmax over bf16 bits, then ``max(., 1e-8) / 127`` and the
    reciprocal, in f32), ``w_img`` the int8 weight image (64-channel
    chunks, zeros past CX and CH), ``ws`` (4*CH,) in i, f, o, g order and
    ``xq``, ``hq`` int8 NHWC with channels padded with zeros to a multiple
    of 64. ``prepared`` is the f32 prepared matrix; x and h_prev bf16."""
    ch = h_prev.shape[1]
    bits = x.contiguous().view(torch.int16).to(torch.int32) & 0x7FFF
    amax = dp.all_max((bits.max() << 16).view(torch.float32))
    s_x = _div127(torch.clamp(amax, min=1e-8))
    inv_sx = torch.reciprocal(s_x)
    cin = cx + ch
    is_x = (torch.arange(cin, device=x.device) < cx).repeat(9)
    rs = torch.where(is_x, s_x, torch.full_like(s_x, 1.0 / 127.0))
    wt = prepared.float() * rs
    s_row = _div127(torch.clamp(wt.abs().amax(dim=1), min=1e-20))
    wq = torch.clamp(torch.round(wt / s_row[:, None]), -127, 127).to(
        torch.int8)
    ws = torch.empty_like(s_row)
    n = torch.arange(4 * ch, device=x.device)
    ws[((n % 32) // 8) * ch + (n // 32) * 8 + n % 8] = s_row

    def padded(v, scale):
        c = v.shape[1]
        out = torch.zeros(v.shape[0], v.shape[2], v.shape[3],
                          -(-c // INT8_KC) * INT8_KC, dtype=torch.int8,
                          device=v.device)
        out[..., :c] = quantize(v, scale).permute(0, 2, 3, 1)
        return out

    return (torch.stack([s_x, inv_sx]), _weight_image(wq, cx, INT8_KC), ws,
            padded(x, inv_sx), padded(h_prev.to(x.dtype), 127.0))


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
    """Shapes of a cell's operands (``c_prev`` None: x and h_prev only)."""
    b, cx, hh, ww = x.shape
    ch = h_prev.shape[1]
    for what, t, cc in (("x", x, cx), ("h_prev", h_prev, ch),
                        ("c_prev", c_prev, ch)):
        if t is None:
            continue
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (b, cc, hh, ww)
                or not t.is_contiguous(memory_format=torch.channels_last)
                or t.device != x.device):
            raise ValueError(
                f"{name}: {what} must be a channels-last bfloat16 "
                f"{(b, cc, hh, ww)} tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)}")
    if c_prev is not None and c_prev.data_ptr() == h_prev.data_ptr():
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


@functools.lru_cache(maxsize=None)
def _plan(b, hh, ww, cx, ch, int8, sms) -> conv_halo.CellPlan:
    return conv_halo.cell_plan(b, hh, ww, cx, ch, int8=int8, sm_count=sms)


def _cell_plan(b, hh, ww, cx, ch, int8, device) -> conv_halo.CellPlan:
    return _plan(b, hh, ww, cx, ch, int8, conv_halo.sm_count(device))


def _plan_args(plan: conv_halo.CellPlan) -> Tuple[int, ...]:
    return (plan.th, plan.tw, plan.grid, plan.smem)


def _launch_exact(x, h_prev, c_prev, weight, bias, prepared, mode=0):
    """Exact kernel (in variant ``MODES[mode]``); returns (h', c_prev
    updated in place). ``prepared`` is :func:`gate_weight_image`'s."""
    name = "conv_lstm_cell"
    b, cx, hh, ww, ch = _check_operands(name, x, h_prev, c_prev)
    if prepared is None:
        prepared = gate_weight_image(prepare_gate_weights(weight))
    _check_matrix(name, prepared, torch.bfloat16,
                  (4 * ch // conv_halo.CELL_BN, (cx + ch) // 32, 36,
                   conv_halo.CELL_BN, 8), x.device)
    _check_aligned(name, x, h_prev, c_prev, prepared)
    bias = _f32_vector(f"{name} bias", bias, 4 * ch, x.device)
    from ess_tpu_torch import kernels

    lib = kernels.get_lib()
    plan = _cell_plan(b, hh, ww, cx, ch, False, x.device)
    h_new = torch.empty_like(h_prev, memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
            prepared.data_ptr(), bias.data_ptr(), h_new.data_ptr(), b, hh, ww,
            cx, ch, *_plan_args(plan))
    err = (lib.ess_conv_lstm_mode(*args, mode, stream) if mode
           else lib.ess_conv_lstm(*args, stream))
    kernels.check(err, f"conv_lstm kernel ({MODES[mode]})")
    _count_launch(False, mode)
    return h_new, c_prev


def global_partials(x: torch.Tensor, partials: torch.Tensor, stream) -> int:
    """Under data parallel, the int8 preps' x absmax over the global
    batch: the absmax kernel's partials (``ess_int8_absmax``, the first of
    a prep's two launches), their maximum reduced over the ranks
    (``dp.all_max``) into ``partials[0]``; returns the partial count the
    prep then reads, 1. Otherwise 0, and the prep launches the absmax
    kernel itself."""
    if dp.world() == 1:
        return 0
    from ess_tpu_torch import kernels

    partials.zero_()
    kernels.check(kernels.get_lib().ess_int8_absmax(
        x.data_ptr(), x.numel(), partials.data_ptr(), stream),
        "int8 absmax kernel")
    partials[:1] = dp.all_max(partials.amax().view(1))
    return 1


def int8_prep(x: torch.Tensor, h_prev: torch.Tensor, prepared: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """The int8 cell's prep on CUDA tensors, two kernel launches (counted in
    ``launches_int8_prep``), no host sync: ``(scal, w_img, ws, xq, hq)`` as
    :func:`int8_prep_ref` returns them. x, h_prev: channels-last bf16;
    ``prepared``: the f32 prepared gate matrix."""
    global launches_int8_prep
    name = "conv_lstm_int8_cell"
    b, cx, hh, ww, ch = _check_operands(name, x, h_prev, None)
    _check_matrix(name, prepared, torch.float32, (4 * ch, 9 * (cx + ch)),
                  x.device)
    dev = x.device
    kc = INT8_KC
    cxp, chp = -(-cx // kc) * kc, -(-ch // kc) * kc
    f32 = dict(dtype=torch.float32, device=dev)
    i8 = dict(dtype=torch.int8, device=dev)
    partials = torch.empty(PREP_PARTIALS, **f32)
    scal = torch.empty(2, **f32)
    w_img = torch.empty(4 * ch // conv_halo.CELL_BN, (cxp + chp) // kc, 36,
                        conv_halo.CELL_BN, 16, **i8)
    ws = torch.empty(4 * ch, **f32)
    xq = torch.empty(b, hh, ww, cxp, **i8)
    hq = torch.empty(b, hh, ww, chp, **i8)
    _check_aligned(name, x, h_prev, prepared, w_img, xq, hq)
    from ess_tpu_torch import kernels

    lib = kernels.get_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ess_conv_lstm_int8_prep(
        x.data_ptr(), h_prev.data_ptr(), prepared.data_ptr(),
        partials.data_ptr(), global_partials(x, partials, stream),
        scal.data_ptr(), w_img.data_ptr(), ws.data_ptr(), xq.data_ptr(),
        hq.data_ptr(), b, hh, ww, cx, ch, stream)
    kernels.check(err, "conv_lstm int8 prep kernels")
    launches_int8_prep += 2
    return scal, w_img, ws, xq, hq


def _launch_int8(x, h_prev, c_prev, weight, bias, prepared, mode=0):
    """Int8 kernels (two prep launches + the cell, the cell in variant
    ``MODES[mode]``); returns (h', c_prev updated in place). ``prepared``
    is the f32 prepared gate matrix."""
    name = "conv_lstm_int8_cell"
    b, cx, hh, ww, ch = _check_operands(name, x, h_prev, c_prev)
    if prepared is None:
        prepared = prepare_gate_weights(weight, torch.float32)
    bias = _f32_vector(f"{name} bias", bias, 4 * ch, x.device)
    _, w_img, ws, xq, hq = int8_prep(x, h_prev, prepared)
    _check_aligned(name, c_prev)
    from ess_tpu_torch import kernels

    lib = kernels.get_lib()
    plan = _cell_plan(b, hh, ww, cx, ch, True, x.device)
    h_new = torch.empty_like(h_prev, memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (xq.data_ptr(), hq.data_ptr(), c_prev.data_ptr(), w_img.data_ptr(),
            ws.data_ptr(), bias.data_ptr(), h_new.data_ptr(), b, hh, ww, cx,
            ch, *_plan_args(plan))
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
    returns (h', c'). ``impl`` is routed by :func:`int8_route` at x's shape
    first: ``'pallas_int8'`` on a cell below the JAX size rule is the exact
    cell.

    CPU tensors, or ``impl='xla'``: the plain version of the cell. CUDA
    tensors: the cell's kernel, which needs bf16 channels-last x
    (B, CX, H, W), h and c (B, CH, H, W) with CX and CH multiples of 32,
    and returns c' in ``c_prev``'s storage (outside autograd). ``prepared``
    is ``prepare_cell_weights(weight, impl)``: the exact kernel's bf16
    weight image (:func:`gate_weight_image`, 5-D) for ``'pallas'``, the
    f32 prepared gate matrix for ``'pallas_int8'``; it is computed here
    when not given, and one of another form is refused with a
    ``ValueError``: prepare for the routed name. Gradients of the kernels
    and of the plain int8 cell are those of :func:`conv_lstm_ref`.
    """
    if impl not in IMPLS[1:]:
        raise ValueError(f"conv_lstm_cell: impl {impl!r} is not a resolved "
                         "name (see resolve_lstm_impl)")
    impl = int8_route(impl, x.shape)
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
