"""The int8 fused 3x3 conv (B4-int8) on the halo-tile core, on the CPU.

B4-int8 runs the halo-tile conv kernel of ``csrc/conv_halo.cuh`` with s8
operands after two prep kernels (``ess_tpu_torch.ops.conv3x3.int8_prep``:
x's absmax, then the scales and the weight re-quantization). The card is
not here, so this file holds:

- the int8 plan (``conv_halo.conv_plan(..., int8=True)``) to its contract
  at the two DSEC block convs at B = 1, 2 and 8 and at every shape of the
  CUDA tests: the coverage and budget of ``test_torch_conv_halo``'s
  ``check_plan``, the shared-memory layout the launcher rebuilds, a second
  s8 halo tile only where it costs no block an SM, and at the DSEC shapes
  resident weights, two blocks an SM (one s8 halo) for the head and one
  block (two s8 halos) for encoder 0;
- the prep's plain version (``int8_prep_ref``: the absmax over bf16 bits,
  then the scales and the weights) equal to ``input_scale`` +
  ``quantize_conv_weights``, and the loader's quantize arithmetic (round
  by adding 1.5 * 2^23, no clip: it cannot bind with x's own scale) equal
  to ``quantize``, ties included;
- a plain emulation of the kernel's indexing (per pixel tile and 64-channel
  chunk the raw bf16 halo with zero fill, quantized into the s8 halo, each
  tap an offset into it, the s8 weight matrix, exact integer sums, then
  ``f32(acc) * ws + bias``, ReLU, one rounding) bit-identical to
  ``conv3x3_int8_ref``, and against the JAX Pallas int8 conv in interpret
  mode within ``test_torch_conv3x3.py``'s int8 bounds (outputs within 1e-5
  of the output's absmax, quantized weights identical).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops.conv3x3_pallas import _quantize_weights as jax_quant
from ess_tpu.ops.conv3x3_pallas import conv3x3_fused as jax_fused

from ess_tpu_torch.ops import conv3x3 as c3
from ess_tpu_torch.ops import conv_halo as ch
from ess_tpu_torch.ops.conv_lstm import input_scale, quantize

from test_torch_conv_halo import DSEC_CONV, check_plan, conv_data
from test_torch_kernels_cuda import CONV_SHAPES


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


DSEC_B = [(b, *s[1:]) for s in DSEC_CONV for b in (1, 2, 8)]


@pytest.mark.parametrize("shape", DSEC_B + list(CONV_SHAPES))
def test_int8_conv_plan_contract(shape):
    b, h, w, cin, cout = shape
    plan = ch.conv_plan(b, h, w, cin, cout, int8=True)
    check_plan(plan, b, h, w)
    assert (plan.th, plan.tw, plan.bn) == (
        lambda p: (p.th, p.tw, p.bn))(ch.conv_plan(b, h, w, cin, cout))
    assert plan.chunks * ch.KC_INT8 == c3.tap_channels(cin, int8=True)
    # the layout conv_halo.cuh::conv_smem rebuilds: weights (every chunk,
    # or two stages), two raw stages, q_stages s8 halo tiles, the slots
    npix = (plan.th + 2) * (plan.tw + 2)
    wchunk = plan.bn * ch.W_ROW_BYTES

    def smem(resident, q):
        return ((plan.chunks if resident else 2) * wchunk
                + 2 * npix * min(cin, 64) * 2 + q * npix * ch.PIX_BYTES
                + ch.WARPS * ch.SLOT_NHWC)

    assert plan.q_stages in (1, 2)
    assert plan.smem == smem(plan.resident, plan.q_stages)
    assert plan.resident == (smem(True, plan.q_stages) <= ch.MAX_SMEM)
    # a second s8 halo (the producer kernel) only where it fits beside
    # every weight chunk and costs no block an SM
    one = min(smem(True, 1), smem(False, 1))
    two = smem(True, 2)
    assert plan.q_stages == (2 if two <= ch.MAX_SMEM and ch.blocks_per_sm(
        plan.bn, two) == ch.blocks_per_sm(plan.bn, one) else 1)
    assert plan.resident or plan.q_stages == 1
    if shape in DSEC_B:
        per_sm = ch.blocks_per_sm(plan.bn, plan.smem)
        assert plan.resident and plan.n_tiles_n == 1
        assert plan.chunks * wchunk == 73_728      # half the bf16 weights
        # the head keeps two blocks an SM, encoder 0 quantizes under its
        # products
        assert (per_sm, plan.q_stages) == ((2, 1) if cout == 128 else (1, 2))
        assert plan.grid_x == min(plan.n_tiles, ch.H100_SMS * per_sm)


def loader_quantize(v, inv_sx):
    """The loader's arithmetic (``conv_halo.cuh::quant_bf16x4``): the f32
    product rounded by adding 1.5 * 2^23 (the integer lands in the low
    mantissa bits), the low byte as s8; no clip, which cannot bind where
    ``inv_sx`` is the reciprocal of ``input_scale(v)``."""
    q = v.float() * inv_sx + 12582912.0
    low = q.view(torch.int32) & 0xFF
    return (low - ((low & 0x80) << 1)).to(torch.int8)


def test_loader_quantize_is_quantize():
    """With x's own scale the loader's rounding by addition equals
    ``quantize``'s round-then-clip: ties to even (an absmax of 127 gives
    the scale 1), the absmax itself at +-127, signed zeros, and seeded
    values of either sign setting the absmax."""
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                         127.0, -127.0, 0.0, -0.0, 3.2e-3, 63.75, -63.25],
                        dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    rand = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 60)
    cases = [ties, rand.to(torch.bfloat16), (-rand.abs()).to(torch.bfloat16),
             (rand * 1e-3).to(torch.bfloat16)]
    for v in cases:
        inv = torch.reciprocal(input_scale(v))
        assert (v.float() * inv).abs().max() < 127.5
        assert torch.equal(loader_quantize(v, inv), quantize(v, inv))
    assert float(input_scale(ties)) == 1.0


@pytest.mark.parametrize("shape", [(2, 24, 16, 13, 40), (1, 20, 128, 9, 11),
                                   (2, 128, 64, 6, 10), (1, 512, 136, 4, 5)])
def test_int8_prep_plain_is_the_library_scales(shape):
    """``int8_prep_ref`` (the absmax over bf16 bits, as the kernels take
    it) gives ``input_scale``, its reciprocal and
    ``quantize_conv_weights``' weights and column scales bit for bit."""
    b, cin, cout, h, w = shape
    x, k, _ = conv_data(sum(shape), b, h, w, cin, cout)
    x = x - 0.75                      # negative values set the absmax too
    prep = c3.prepare_conv_weights(k, int8=True)
    scal, wq, ws = c3.int8_prep_ref(x, prep)
    s_x = input_scale(x)
    assert torch.equal(scal, torch.stack([s_x, torch.reciprocal(s_x)]))
    wq_l, ws_l = c3.quantize_conv_weights(prep, s_x)
    assert torch.equal(wq, wq_l) and torch.equal(ws, ws_l)
    assert wq.dtype == torch.int8 and wq.shape == prep.shape


def emulate_int8_conv(x, prepared, bias, relu, plan):
    """B4-int8's indexing in plain PyTorch: the prep (scales, s8 weights),
    then per pixel tile and 64-channel chunk the raw bf16 halo (zero fill
    outside the image and past C_in; ``raw_pitch`` bytes a pixel) quantized
    by the loader into the s8 halo tile, every tap a shifted view of it
    times the weights' tap columns, exact sums; the epilogue
    ``f32(acc) * ws + bias`` and the ReLU in f32. Returns the f32 values
    before the bf16 rounding (NCHW), the s8 weights and ``scal``; each
    output pixel is written once."""
    b, cin, h, w = x.shape
    cout = prepared.shape[0]
    kc = ch.KC_INT8
    scal, wq, ws = c3.int8_prep_ref(x, prepared)
    xn = x.permute(0, 2, 3, 1)
    wmat = wq.double().view(cout, 9, -1)
    rp = ch.raw_pitch(cin) // 2                 # channels in the raw stage
    out = torch.full((b, h, w, cout), float("nan"))
    for nt in range(plan.n_tiles_n):
        n = slice(nt * plan.bn, min((nt + 1) * plan.bn, cout))
        for bx in range(plan.grid_x):
            for t in ch.block_tiles(plan, bx):
                bi, y0, x0 = ch.tile_origin(plan, t)
                acc = torch.zeros(plan.bm, n.stop - n.start,
                                  dtype=torch.float64)
                for k in range(plan.chunks):
                    raw = torch.zeros(plan.th + 2, plan.tw + 2, rp,
                                      dtype=torch.bfloat16)
                    ya, yb = max(y0 - 1, 0), min(y0 + plan.th + 1, h)
                    xa, xb = max(x0 - 1, 0), min(x0 + plan.tw + 1, w)
                    c0, c1 = k * kc, min(k * kc + rp, cin)
                    raw[ya - y0 + 1:yb - y0 + 1, xa - x0 + 1:xb - x0 + 1,
                        :c1 - c0] = xn[bi, ya:yb, xa:xb, c0:c1]
                    halo = torch.zeros(plan.th + 2, plan.tw + 2, kc,
                                       dtype=torch.int8)
                    halo[..., :rp] = loader_quantize(raw, scal[1])
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        a = halo[dy:dy + plan.th, dx:dx + plan.tw].reshape(
                            plan.bm, kc).double()
                        acc += a @ wmat[n, tap, k * kc:(k + 1) * kc].T
                v = acc.float() * ws[n]
                if bias is not None:
                    v = v + bias.float()[n]
                v = (torch.relu(v) if relu else v).view(plan.th, plan.tw, -1)
                ty, tx = min(plan.th, h - y0), min(plan.tw, w - x0)
                dst = out[bi, y0:y0 + ty, x0:x0 + tx, n]
                assert torch.isnan(dst).all()
                out[bi, y0:y0 + ty, x0:x0 + tx, n] = v[:ty, :tx]
    assert not torch.isnan(out).any()
    return out.permute(0, 3, 1, 2), wq, scal


# the CUDA tests' shapes that stay small on the CPU
EMU_CONV = [s for s in CONV_SHAPES if s[0] * s[1] * s[2] <= 4000]


@pytest.mark.parametrize("shape", EMU_CONV)
def test_emulated_int8_conv_is_the_plain_int8_conv(shape):
    """Bit for bit, over both epilogues and with and without a bias."""
    b, h, w, cin, cout = shape
    relu, use_bias = cin % 8 == 0, cout != 8
    x, k, bias = conv_data(sum(shape) + 1, b, h, w, cin, cout,
                           bias=use_bias)
    plan = ch.conv_plan(b, h, w, cin, cout, int8=True)
    got, _, _ = emulate_int8_conv(x, c3.prepare_conv_weights(k, int8=True),
                                  bias, relu, plan)
    want = c3.conv3x3_int8_ref(x, k, bias, relu=relu)
    assert torch.equal(got.to(torch.bfloat16), want)


@pytest.mark.parametrize("relu,bias", [(True, True), (False, True),
                                       (True, False)])
@pytest.mark.parametrize("shape", [(24, 16, 16, 40), (20, 32, 8, 24)])
def test_emulated_int8_conv_matches_jax_interpret(shape, relu, bias):
    """The emulation against the JAX Pallas int8 conv in interpret mode on
    the same bf16-valued inputs (given to JAX in f32, whose output keeps
    f32): outputs within 1e-5 of the output's absmax, quantized weights
    identical."""
    cin, cout, h, w = shape
    rng = np.random.default_rng(21)
    x = (np.maximum(rng.normal(size=(2, h, w, cin)), 0) * 2).astype(
        np.float32)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    kh = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32) if bias else None
    want = np.asarray(jax_fused(
        jnp.asarray(x), jnp.asarray(kh), None if b is None else jnp.asarray(b),
        relu=relu, impl="pallas_int8_interpret"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    k = torch.from_numpy(kh).permute(3, 2, 0, 1).contiguous()
    plan = ch.conv_plan(2, h, w, cin, cout, int8=True)
    got, wq, scal = emulate_int8_conv(
        xt, c3.prepare_conv_weights(k, int8=True),
        None if b is None else torch.from_numpy(b), relu, plan)
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    s_x_j = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-8) / 127.0
    assert float(scal[0]) == float(s_x_j)
    wq_j, _ = jax_quant(jnp.asarray(kh).reshape(9 * cin, cout), s_x_j)
    wq = wq.view(cout, 9, -1)[:, :, :cin].reshape(cout, 9 * cin)
    assert np.array_equal(wq.numpy(), np.asarray(wq_j).T)
