"""Fused E2VID encoder level: stride-2 5x5 conv + ReLU + int8 ConvLSTM cell.

Counterpart of ``ess_tpu/ops/level_pallas.py`` (``encoder_level_ref``,
``_level_kernel`` / ``_level_forward`` and ``encoder_level_int8``): one
recurrent encoder level of the frozen E2VID rollout with no quantization
reduce outside the kernels. The 5x5 stride-2 conv runs as an int8 3x3 conv
over the 2x2 space-to-depth view of the level input u, its output x is
quantized in place, and the gate conv runs as two int8 products (x and h
carry different scales) whose dequantized sums add before the LSTM
pointwise.

The quantization groups are (sample, row tile of ``th`` output rows) with
``th = pick_row_tile(HO)``, so the result depends on this tiling and the
port keeps the JAX package's, whatever its thread blocks cover. Per group:

- ``amax_u`` = max |u| over the group's space-to-depth rows
  ``r0-2 .. r0+th+1`` (zeros past the image), floored at 1e-6; u is
  quantized by ``v * (127 / amax_u)``, rounded half to even, clipped to
  +-127;
- ``x = f32(acc) * (wse * (amax_u / 127)) + enc_bias``, ReLU, on the
  ``th+2`` rows ``r0-1 .. r0+th`` with this group's u scale (a group's halo
  rows of x differ from its neighbour's values of the same rows), rows
  outside the image set to 0;
- ``amax_x`` = max x over those rows, floored at 1e-6; x quantized by
  ``127 / amax_x``, h (rounded to u's dtype) by 127;
- ``gates = f32(acc_x) * (wsx * (amax_x / 127)) + f32(acc_h) * (wsh / 127)
  + gate_bias``, gate order i, f, o, g, pointwise in f32; h' and c' return
  in u's dtype.

Tensors are NCHW; u is the full-resolution level input (B, C_in, 2*HO,
2*WO) or, with ``u_s2d=True``, its space-to-depth form (B, 4*C_in, HO, WO)
(:func:`ess_tpu_torch.ops.conv_s2d.space_to_depth`). On CPU the level runs
its plain version :func:`encoder_level_int8_ref`. On CUDA it runs the three
kernels of ``csrc/level_int8.cu`` on bf16 channels-last tensors (the group
absmax of u; the conv on the halo-tile core, u quantized as it is staged;
the gate conv and the pointwise on the int8 cell kernel's machinery, x and
h quantized as they are staged), with the plan of
``ops/conv_halo.py::level_plan``, writes h' to a new tensor and updates c
in place (outside autograd); there is no route to the plain version: a
shape the kernels do not take raises. On CUDA tensors the entry keeps JAX's
size rule (:func:`fuses`): an ``h_prev`` of fewer than
``FUSE_MIN_ELEMENTS`` elements gets None before any launch, as on JAX's
non-interpret path, and the caller takes the split level; the CPU's plain
version answers at every size, as JAX's interpret mode does. No model or
rollout uses the level, as in the JAX package:
``ess_tpu_torch/tools/bench_level.py`` drives it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ess_tpu_torch.ops import conv_halo
from ess_tpu_torch.ops.conv_lstm import (
    _check_aligned, _check_matrix, _div127, _pointwise, _weight_image,
    conv_lstm_ref, gate_column_order, pick_row_tile, quant_cols, quantize,
    unpermute_gate_rows)
from ess_tpu_torch.ops.conv_s2d import (
    conv5x5_s2d_stride2, s2d_kernel_stride2, space_to_depth)

launches = 0   # fused-level calls on CUDA, each the three kernels

AMAX_FLOOR = 1e-6
# JAX's size rule (ops/level_pallas.py::encoder_level_int8, not interpret):
# a smaller h_prev takes the split level
FUSE_MIN_ELEMENTS = 1_000_000

State = Tuple[torch.Tensor, torch.Tensor]


class LevelWeights(NamedTuple):
    """The per-level weight preparation (:func:`prepare_level_weights`)."""
    we_q: torch.Tensor   # (CH, 9*CU) int8: row n, column (dy*3+dx)*CU + cu
    wx_q: torch.Tensor   # (4*CH, 9*CH) int8, gate_column_order row order
    wh_q: torch.Tensor   # (4*CH, 9*CH) int8, gate_column_order row order
    sbe: torch.Tensor    # (2, CH) f32: wse, enc_bias
    sbg: torch.Tensor    # (3, 4*CH) f32: wsx, wsh / 127, gate_bias (i,f,o,g)
    # what the CUDA kernels load, where CH is a multiple of 32 (else None):
    we_k: Optional[torch.Tensor]     # (CH, 9*CUP) int8, CU padded to 64s
    wg_img: Optional[torch.Tensor]   # int8 gate weight image (4*CH/128,
                                     # 2*CHP/64, 2, 9, 2, 128, 16): wx's
                                     # chunks, then wh's, in half chunks


def prepare_level_weights(enc_weight: torch.Tensor, enc_bias: torch.Tensor,
                          gate_weight: torch.Tensor, gate_bias: torch.Tensor
                          ) -> LevelWeights:
    """Quantize a level's weights per output channel: the encoder conv in
    its space-to-depth 3x3 form and the x and h halves of the gate conv
    (three :func:`quant_cols`), with their scales and the biases stacked as
    the kernels read them, and the two layouts the CUDA kernels load: the
    conv's matrix with its input channels padded to a multiple of 64
    (``we_k``) and the gate kernel's weight image (``wg_img``: the cell
    kernel's layout of ``conv_lstm._weight_image`` with each chunk's 36 k
    groups cut in two halves of 32 channels, [half][tap][2 k groups], one
    bulk copy a half), where CH is a multiple of 32 as the kernels need
    (else None). The JAX package does this on every call; here it may be
    computed once for frozen parameters and passed as ``prepared``.
    """
    ch = enc_weight.shape[0]
    if tuple(gate_weight.shape) != (4 * ch, 2 * ch, 3, 3):
        raise ValueError(f"level: gate weight {tuple(gate_weight.shape)} is "
                         f"not {(4 * ch, 2 * ch, 3, 3)}")
    we2 = s2d_kernel_stride2(enc_weight.detach()).float()  # (CH, CU, 3, 3)
    cu = we2.shape[1]
    we_q, wse = quant_cols(we2.permute(2, 3, 1, 0).reshape(9 * cu, ch))
    gk = gate_weight.detach().float().permute(2, 3, 1, 0)  # (3, 3, 2CH, 4CH)
    wx_q, wsx = quant_cols(gk[:, :, :ch].reshape(9 * ch, 4 * ch))
    wh_q, wsh = quant_cols(gk[:, :, ch:].reshape(9 * ch, 4 * ch))
    order = gate_column_order(ch, gate_weight.device)
    we_t = we_q.t().contiguous()
    wx_t, wh_t = wx_q.t()[order].contiguous(), wh_q.t()[order].contiguous()
    we_k = wg_img = None
    if ch % 32 == 0:
        cup = -(-cu // 64) * 64
        we_k = we_t.new_zeros(ch, 9, cup)
        we_k[:, :, :cu] = we_t.view(ch, 9, cu)
        we_k = we_k.view(ch, 9 * cup)
        wg = torch.cat([wx_t.view(4 * ch, 9, ch), wh_t.view(4 * ch, 9, ch)],
                       2)
        img = _weight_image(wg.view(4 * ch, 18 * ch), ch, 64)
        nn, chunks = img.shape[:2]
        wg_img = (img.view(nn, chunks, 9, 2, 2, 128, 16)
                  .permute(0, 1, 3, 2, 4, 5, 6).contiguous())
    return LevelWeights(
        we_t, wx_t, wh_t, torch.stack([wse, enc_bias.detach().float()]),
        torch.stack([wsx, _div127(wsh), gate_bias.detach().float()]),
        we_k, wg_img)


def encoder_level_ref(u: torch.Tensor, h_prev: torch.Tensor,
                      c_prev: torch.Tensor, enc_weight: torch.Tensor,
                      enc_bias: torch.Tensor, gate_weight: torch.Tensor,
                      gate_bias: torch.Tensor, *, u_s2d: bool) -> State:
    """The exact chain on the library conv: ``x = relu(stride-2 5x5
    conv(u))`` in u's dtype, then :func:`conv_lstm_ref`."""
    if u_s2d:
        x = conv5x5_s2d_stride2(u, enc_weight, enc_bias, dtype=u.dtype)
    else:
        x = (F.conv2d(u, enc_weight.to(u.dtype), stride=2, padding=2)
             + enc_bias.to(u.dtype)[None, :, None, None])
    return conv_lstm_ref(torch.relu(x), h_prev, c_prev, gate_weight,
                         gate_bias)


def _row_tiles(a: torch.Tensor, th: int, d: int) -> torch.Tensor:
    """(B, C, H, W) -> (B*NT, C, th+2d, W): rows ``r0-d .. r0+th+d-1`` of
    every row tile, zeros past the image, tiles unfolded into the batch."""
    b, c, h, w = a.shape
    t = F.pad(a, (0, 0, d, d)).unfold(2, th + 2 * d, th)  # (B, C, NT, W, R)
    return t.permute(0, 2, 1, 4, 3).reshape(b * (h // th), c, th + 2 * d, w)


def level_x_ref(u: torch.Tensor, prepared: LevelWeights, *, u_s2d: bool,
                th: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first half of :func:`level_int8_ref`: the conv's output x of
    every group, (G, CH, th+2, WO) f32 on the group's rows ``r0-1 ..
    r0+th`` with its u scale (rows outside the image 0), and the floored
    ``amax_u`` (G,)."""
    ch = prepared.sbe.shape[1]
    us = (u if u_s2d else space_to_depth(u)).float()
    cu, ho = us.shape[1], us.shape[2]
    nt = ho // th
    c127 = torch.full((), 127.0, device=u.device)
    col = lambda v: v[None, :, None, None]
    grp = lambda v: v[:, None, None, None]

    ut = _row_tiles(us, th, 2)                          # (G, CU, th+4, WO)
    amax_u = torch.clamp(ut.abs().amax(dim=(1, 2, 3)), min=AMAX_FLOOR)
    uq = quantize(ut, grp(torch.div(c127, amax_u)))
    we = prepared.we_q.view(ch, 3, 3, cu).permute(0, 3, 1, 2)
    acc_e = F.conv2d(uq.double(), we.double(), padding=(0, 1))
    x = (acc_e.float() * (col(prepared.sbe[0])
                          * grp(torch.div(amax_u, c127)))
         + col(prepared.sbe[1]))
    x = torch.relu(x)                                   # (G, CH, th+2, WO)
    # the gate conv's zero padding: from zero-padded u these rows would be
    # relu(bias)
    x[0::nt, :, 0] = 0.0
    x[nt - 1::nt, :, th + 1] = 0.0
    return x, amax_u


def level_int8_ref(u: torch.Tensor, h_prev: torch.Tensor,
                   c_prev: torch.Tensor, prepared: LevelWeights, *,
                   u_s2d: bool, th: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The plain version of the fused level, step by step on tensors (module
    docstring), with the row tiles unfolded into the batch axis. The
    integer convs run in float64, where every partial sum is exact
    (9*512*127^2 exceeds f32's integers). Every scale is built from IEEE
    f32 divisions and products in the kernels' order (a tensor divided by a
    tensor: dividing by a Python number multiplies by its reciprocal on
    CUDA). Returns (h', c', amax_u, amax_x), the scales per group
    (B*NT,)."""
    b, ch, ho, wo = h_prev.shape
    nt = ho // th
    c127 = torch.full((), 127.0, device=u.device)
    col = lambda v: v[None, :, None, None]
    grp = lambda v: v[:, None, None, None]
    x, amax_u = level_x_ref(u, prepared, u_s2d=u_s2d, th=th)
    amax_x = torch.clamp(x.amax(dim=(1, 2, 3)), min=AMAX_FLOOR)
    xq = quantize(x, grp(torch.div(c127, amax_x)))
    hq = quantize(_row_tiles(h_prev.to(u.dtype), th, 1), 127.0)
    acc_x = F.conv2d(xq.double(), unpermute_gate_rows(prepared.wx_q, ch)
                     .double(), padding=(0, 1))
    acc_h = F.conv2d(hq.double(), unpermute_gate_rows(prepared.wh_q, ch)
                     .double(), padding=(0, 1))
    gates = (acc_x.float() * (col(prepared.sbg[0])
                              * grp(torch.div(amax_x, c127)))
             + acc_h.float() * col(prepared.sbg[1])
             + col(prepared.sbg[2]))                    # (G, 4CH, th, WO)
    gates = gates.view(b, nt, 4 * ch, th, wo).permute(0, 2, 1, 3, 4).reshape(
        b, 4 * ch, ho, wo)
    h_new, c_new = _pointwise(gates, c_prev)
    return h_new.to(u.dtype), c_new.to(c_prev.dtype), amax_u, amax_x


def encoder_level_int8_ref(u: torch.Tensor, h_prev: torch.Tensor,
                           c_prev: torch.Tensor, enc_weight: torch.Tensor,
                           enc_bias: torch.Tensor, gate_weight: torch.Tensor,
                           gate_bias: torch.Tensor, *, u_s2d: bool,
                           prepared: Optional[LevelWeights] = None) -> State:
    """Plain fused level (:func:`level_int8_ref`) from the level's
    parameters; returns (h', c')."""
    th = pick_row_tile(h_prev.shape[2])
    if th is None:
        raise ValueError(f"level: no row tile divides {h_prev.shape[2]} rows")
    if prepared is None:
        prepared = prepare_level_weights(enc_weight, enc_bias, gate_weight,
                                         gate_bias)
    return level_int8_ref(u, h_prev, c_prev, prepared, u_s2d=u_s2d,
                          th=th)[:2]


def level_int8_cuda(u: torch.Tensor, h_prev: torch.Tensor,
                    c_prev: torch.Tensor, prepared: LevelWeights, *,
                    u_s2d: bool, th: int,
                    x_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The three kernels of ``csrc/level_int8.cu`` on CUDA tensors: returns
    (h', c_prev updated in place, amax_u, amax_x) as
    :func:`level_int8_ref`, the scales as the kernels found them, before
    the floor they apply where they use them (no torch operation runs here
    beyond allocating the outputs and the scratch). Checks what the kernels
    need and raises otherwise; the plan is
    ``conv_halo.level_plan``'s. ``x_out``: a contiguous f32 (G, th+2, WO,
    CH) tensor that receives the conv's output x in the group layout
    (:func:`level_x_ref`'s, channels last), else scratch."""
    name = "encoder_level_int8"
    b, ch, ho, wo = h_prev.shape
    cu = u.shape[1] if u_s2d else 4 * u.shape[1]
    want_u = (b, cu, ho, wo) if u_s2d else (b, cu // 4, 2 * ho, 2 * wo)
    for what, t, shape in (("u", u, want_u), ("h_prev", h_prev,
                                              (b, ch, ho, wo)),
                           ("c_prev", c_prev, (b, ch, ho, wo))):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or not t.is_contiguous(memory_format=torch.channels_last)
                or t.device != u.device or t.device.type != "cuda"):
            raise ValueError(
                f"{name}: {what} must be a channels-last bfloat16 {shape} "
                f"CUDA tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if c_prev.data_ptr() == h_prev.data_ptr():
        raise ValueError(f"{name}: h_prev and c_prev share storage (c is "
                         "updated in place while h is read)")
    if ch % 32 or cu % (16 if u_s2d else 32) or ho % th:
        raise ValueError(f"{name}: CH={ch} must be a multiple of 32, the "
                         f"input channels {cu // 4} of {4 if u_s2d else 8}, "
                         f"and th={th} must divide {ho} rows")
    _check_matrix(name, prepared.we_q, torch.int8, (ch, 9 * cu), u.device)
    _check_matrix(name, prepared.wx_q, torch.int8, (4 * ch, 9 * ch), u.device)
    _check_matrix(name, prepared.wh_q, torch.int8, (4 * ch, 9 * ch), u.device)
    _check_matrix(name, prepared.sbe, torch.float32, (2, ch), u.device)
    _check_matrix(name, prepared.sbg, torch.float32, (3, 4 * ch), u.device)
    cup, chp = -(-cu // 64) * 64, -(-ch // 64) * 64
    _check_matrix(name, prepared.we_k, torch.int8, (ch, 9 * cup), u.device)
    _check_matrix(name, prepared.wg_img, torch.int8,
                  (4 * ch // 128, 2 * chp // 64, 2, 9, 2, 128, 16), u.device)
    plan = conv_halo.level_plan(b, ho, wo, cu, ch, th,
                                sm_count=conv_halo.sm_count(u.device))
    g = plan.groups
    scratch = torch.empty((2 + plan.amax_blocks) * g, dtype=torch.float32,
                          device=u.device)
    xs = x_out
    if xs is None:
        xs = torch.empty((g, th + 2, wo, ch), dtype=torch.float32,
                         device=u.device)
    if (xs.dtype != torch.float32 or tuple(xs.shape) != (g, th + 2, wo, ch)
            or not xs.is_contiguous() or xs.device != u.device):
        raise ValueError(f"{name}: x_out must be a contiguous float32 "
                         f"{(g, th + 2, wo, ch)} tensor on {u.device}")
    h_new = torch.empty_like(h_prev, memory_format=torch.channels_last)
    _check_aligned(name, u, h_prev, c_prev, prepared.we_k, prepared.wg_img,
                   scratch, xs, h_new)
    from ess_tpu_torch import kernels

    global launches
    lib = kernels.get_lib()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    cp, gp = plan.conv, plan.gates
    err = lib.ess_level_int8(
        u.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
        prepared.we_k.data_ptr(), prepared.wg_img.data_ptr(),
        prepared.sbe.data_ptr(), prepared.sbg.data_ptr(), scratch.data_ptr(),
        xs.data_ptr(), h_new.data_ptr(), b, ho, wo, cu, ch, th, int(u_s2d),
        plan.amax_blocks, cp.th, cp.tw, int(cp.resident), cp.grid_x, cp.smem,
        gp.th, gp.tw, plan.gate_halves, gp.grid, gp.smem, stream)
    kernels.check(err, "level_int8 kernels")
    launches += 1
    return h_new, c_prev, scratch[:g], scratch[g:2 * g]


class _RecomputeBackward(torch.autograd.Function):
    """A level whose forward is ``fn`` (the kernels, or the plain fused
    level) and whose backward differentiates :func:`encoder_level_ref` at
    the saved inputs, as the JAX package's ``custom_vjp``. ``fn`` must
    leave its inputs intact (the kernels get a copy of c)."""

    @staticmethod
    def forward(ctx, u, h_prev, c_prev, enc_weight, enc_bias, gate_weight,
                gate_bias, u_s2d, fn):
        ctx.u_s2d = u_s2d
        ctx.save_for_backward(u, h_prev, c_prev, enc_weight, enc_bias,
                              gate_weight, gate_bias)
        return fn(u, h_prev, c_prev)

    @staticmethod
    def backward(ctx, dh, dc):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            outs = encoder_level_ref(*ins, u_s2d=ctx.u_s2d)
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(outs, wanted, (dh, dc)))
        return (*(next(got) if n else None for n in need), None, None)


def fuses(h_prev_elements: int) -> bool:
    """JAX's size rule for the fused level on the device: an ``h_prev``
    of at least ``FUSE_MIN_ELEMENTS`` elements."""
    return h_prev_elements >= FUSE_MIN_ELEMENTS


def encoder_level_int8(u: torch.Tensor, state: State,
                       enc_weight: torch.Tensor, enc_bias: torch.Tensor,
                       gate_weight: torch.Tensor, gate_bias: torch.Tensor, *,
                       u_s2d: bool,
                       prepared: Optional[LevelWeights] = None
                       ) -> Optional[Tuple[torch.Tensor, State]]:
    """Fused stride-2 conv + int8 ConvLSTM encoder level; returns
    ``(h, (h, c))``, or None where the geometry does not tile, as the JAX
    entry does: an encoder kernel that is not 5x5 or a gate kernel that is
    not 3x3, a full-resolution u that is not (2*HO, even), or no row tile
    for HO rows; on CUDA tensors also below the size rule (:func:`fuses`).

    ``state`` is (h, c), (B, CH, HO, WO), cast to u's dtype. CPU tensors:
    the plain version. CUDA tensors: the kernels, which need bf16
    channels-last tensors with CH a multiple of 32 and C_in a multiple of 4
    (``u_s2d``) or 8, and return c' in c's storage (outside autograd).
    ``prepared`` is :func:`prepare_level_weights` of the four parameters,
    computed here when not given. Gradients are those of
    :func:`encoder_level_ref`.
    """
    h_prev, c_prev = state
    ho = h_prev.shape[2]
    if (tuple(enc_weight.shape[2:]) != (5, 5)
            or tuple(gate_weight.shape[2:]) != (3, 3)):
        return None
    if not u_s2d and (u.shape[2] != 2 * ho or u.shape[3] % 2
                      or u.shape[2] % 2):
        return None
    th = pick_row_tile(ho)
    if th is None:
        return None
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"encoder_level_int8: unsupported device {u.device}")
    if u.device.type == "cuda" and not fuses(h_prev.numel()):
        return None
    want_w = h_prev.shape[3] * (1 if u_s2d else 2)
    if u.shape[3] != want_w or (u_s2d and u.shape[2] != ho):
        raise ValueError(f"encoder_level_int8: u {tuple(u.shape)} does not "
                         f"match the state {tuple(h_prev.shape)}")
    if prepared is None:
        prepared = prepare_level_weights(enc_weight, enc_bias, gate_weight,
                                         gate_bias)
    cuda = u.device.type == "cuda"
    cl = torch.channels_last
    h_prev = h_prev.to(u.dtype)
    c_prev = c_prev.to(u.dtype)
    impl = level_int8_cuda if cuda else level_int8_ref
    run = lambda u_, h_, c_: impl(u_, h_, c_, prepared, u_s2d=u_s2d,
                                  th=th)[:2]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, h_prev, c_prev, enc_weight, enc_bias,
                                  gate_weight, gate_bias))
    if not grad:
        h, c = run(u, h_prev, c_prev)
    else:   # the kernels update c in place: give them a copy of c_prev
        fn = ((lambda u_, h_, c_: run(u_, h_, c_.clone(memory_format=cl)))
              if cuda else run)
        h, c = _RecomputeBackward.apply(u, h_prev, c_prev, enc_weight,
                                        enc_bias, gate_weight, gate_bias,
                                        u_s2d, fn)
    return h, (h, c)
