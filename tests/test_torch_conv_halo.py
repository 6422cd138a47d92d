"""The halo-tile conv core's tile plan and indexing, on the CPU.

B4 (the exact fused 3x3 conv) and T1 (the C-major head conv with its
normalize fused) run on one CUDA core (``csrc/conv_halo.cuh``) whose tile
plan is computed in ``ess_tpu_torch/ops/conv_halo.py``. The card is not
here, so this file holds:

- the plan to its contract at the DSEC block-conv shapes (8 x 20 x 220 x
  320 -> 128 and 8 x 128 x 220 x 320 -> 64), at the tool's T1 shape and at
  every shape of the CUDA tests (``CONV_SHAPES``, ``HEAD_SHAPES``): every
  output pixel in exactly one patch, no patch past its image, the
  persistent blocks walking every pixel tile once, the shared memory of a
  block within 232,448 bytes and equal to the layout the launchers rebuild;
- a plain PyTorch emulation of the core's indexing (the zero-filled halo
  patch staged per 32-channel chunk, each tap an offset into it, the
  weights as the kernels' prepared matrix; for T1 the raw C-major rows
  staged from an 8-pixel boundary and normalized once each) against
  ``conv3x3_ref`` and ``head_cmajor_ref``, and through them against the
  JAX Pallas conv and the JAX tool's ``kern`` in interpret mode, on seeded
  numpy inputs.

Bounds: the emulation sums the same bf16 products in f32 in another order
and rounds once, so at most one bf16 ulp off on at least 99.9 % of the
values and max |d| within 2^-7 of the reference's absmax, the fused conv's
bounds everywhere in the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops.conv3x3_pallas import conv3x3_fused as jax_fused

from ess_tpu_torch.ops import conv3x3 as c3
from ess_tpu_torch.ops import conv_halo as ch
from ess_tpu_torch.ops import head_cmajor as hc
from ess_tpu_torch.tools import bench_head

from test_torch_head_cmajor import jax_kern
from test_torch_head_cmajor import inputs as head_inputs
from test_torch_head_cmajor import port_weights
from test_torch_kernels_cuda import CONV_SHAPES, HEAD_SHAPES


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


ULP_SHARE = 0.999
MAX_REL = 2.0 ** -7

# (B, H, W, C_in, C_out)
DSEC_CONV = [(8, 220, 320, 20, 128), (8, 220, 320, 128, 64)]
PLAN_CONV = DSEC_CONV + list(CONV_SHAPES)
# (B, C_in, H, W, C_out), as HEAD_SHAPES
PLAN_HEAD = [tuple(bench_head.SHAPE)] + list(HEAD_SHAPES)


def assert_bf16_close(got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 8)
    d = (got - want).abs()
    assert (d <= ulp).float().mean().item() >= ULP_SHARE
    assert d.max().item() <= MAX_REL * want.abs().max().item()


def check_plan(plan, b, h, w):
    """Coverage and budget of one plan over a (b, h, w) output."""
    assert plan.th * plan.tw == plan.bm and plan.tw % 16 == 0
    assert plan.tiles_y == -(-h // plan.th) and plan.tiles_x == -(-w // plan.tw)
    assert plan.n_tiles == b * plan.tiles_y * plan.tiles_x
    assert 0 < plan.smem <= ch.MAX_SMEM
    # persistent blocks: at most what the card holds at once, each tile once
    per_sm = ch.blocks_per_sm(plan.bn, plan.smem)
    assert per_sm * (plan.smem + ch.BLOCK_RESERVED) <= ch.SM_SMEM
    assert 1 <= plan.grid_x <= plan.n_tiles
    assert plan.grid_x * plan.n_tiles_n <= max(
        ch.H100_SMS * per_sm, plan.n_tiles_n)
    walked = np.concatenate([np.asarray(ch.block_tiles(plan, bx))
                             for bx in range(plan.grid_x)])
    assert np.array_equal(np.sort(walked), np.arange(plan.n_tiles))
    # every output pixel in exactly one patch; no patch past its image
    count = np.zeros((b, h, w), np.int32)
    for t in range(plan.n_tiles):
        bi, y0, x0 = ch.tile_origin(plan, t)
        assert 0 <= bi < b and 0 <= y0 < h and 0 <= x0 < w
        count[bi, y0:y0 + plan.th, x0:x0 + plan.tw] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", PLAN_CONV)
def test_conv_plan_contract(shape):
    b, h, w, cin, cout = shape
    plan = ch.conv_plan(b, h, w, cin, cout)
    check_plan(plan, b, h, w)
    assert plan.bn == ch.block_shape(cout)[1]
    assert plan.n_tiles_n * plan.bn >= cout > (plan.n_tiles_n - 1) * plan.bn
    assert plan.chunks * ch.KC == c3.tap_channels(cin)
    # the layout conv3x3.cu rebuilds from the plan
    halo = (plan.th + 2) * (plan.tw + 2) * ch.PIX_BYTES
    wchunk = plan.bn * ch.W_ROW_BYTES
    want = (plan.chunks * wchunk + 2 * halo if plan.resident
            else 2 * (halo + wchunk)) + ch.WARPS * ch.SLOT_NHWC
    assert plan.smem == want
    # streamed weights only where the resident ones do not fit
    assert plan.resident == (plan.chunks * wchunk + 2 * halo
                             + ch.WARPS * ch.SLOT_NHWC <= ch.MAX_SMEM)
    if shape in DSEC_CONV:
        # the DSEC convs keep all their weights resident, two blocks per SM
        # for the head's 128 x 128 tiles
        assert plan.resident and plan.n_tiles_n == 1
        assert plan.grid_x == ch.H100_SMS * ch.blocks_per_sm(plan.bn,
                                                             plan.smem)
    if cin == 512:
        assert not plan.resident


@pytest.mark.parametrize("nchw_out", [False, True])
@pytest.mark.parametrize("shape", PLAN_HEAD)
def test_head_plan_contract(shape, nchw_out):
    b, cin, h, w, cout = shape
    aligned = w % 8 == 0
    plan = ch.head_plan(b, h, w, cin, cout, nchw_out=nchw_out,
                        aligned=aligned)
    check_plan(plan, b, h, w)
    want = (plan.bn * ch.W_ROW_BYTES
            + (plan.th + 2) * (plan.tw + 2) * ch.PIX_BYTES
            + (cin * (plan.th + 2) * (plan.tw + 16) * 2 if aligned else 0)
            + ch.WARPS * (ch.SLOT_NCHW if nchw_out else ch.SLOT_NHWC))
    assert plan.smem == want and plan.resident and plan.chunks == 1
    assert plan.grid_x == min(plan.n_tiles, ch.H100_SMS * ch.blocks_per_sm(
        plan.bn, plan.smem))
    if not aligned:
        with pytest.raises(ValueError):
            ch.head_plan(b, h, w, cin, cout, nchw_out=nchw_out, aligned=True)


def tile_products(plan, halo_of, wmat, ns, out_tile):
    """The core's product for every pixel tile: ``halo_of(t, k)`` gives the
    staged (th+2, tw+2, KC) halo of tile t and chunk k; every tap is the
    halo shifted by (dy, dx) times the prepared weights' tap columns."""
    for nt in range(plan.n_tiles_n):
        n = ns(nt)
        for bx in range(plan.grid_x):
            for t in ch.block_tiles(plan, bx):
                acc = torch.zeros(plan.bm, n.stop - n.start)
                for k in range(plan.chunks):
                    halo = halo_of(t, k)
                    kc = slice(k * ch.KC, (k + 1) * ch.KC)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        a = halo[dy:dy + plan.th, dx:dx + plan.tw].reshape(
                            plan.bm, ch.KC)
                        acc += a @ wmat[n, tap, kc].T
                out_tile(t, n, acc)


def emulate_conv(x, prepared, bias, relu, plan):
    """B4's indexing in plain PyTorch: NCHW bf16 x -> NHWC halo chunks with
    zero fill outside the image and past C_in -> taps -> + bias, ReLU, one
    rounding. Returns NCHW bf16; each output pixel is written once."""
    b, cin, h, w = x.shape
    cout = prepared.shape[0]
    xn = x.permute(0, 2, 3, 1).float()
    wmat = prepared.float().view(cout, 9, -1)
    bias = torch.zeros(cout) if bias is None else bias.float()
    out = torch.full((b, h, w, cout), float("nan"))

    def halo_of(t, k):
        bi, y0, x0 = ch.tile_origin(plan, t)
        halo = torch.zeros(plan.th + 2, plan.tw + 2, ch.KC)
        ya, yb = max(y0 - 1, 0), min(y0 + plan.th + 1, h)
        xa, xb = max(x0 - 1, 0), min(x0 + plan.tw + 1, w)
        c0, c1 = k * ch.KC, min((k + 1) * ch.KC, cin)
        halo[ya - y0 + 1:yb - y0 + 1, xa - x0 + 1:xb - x0 + 1, :c1 - c0] = \
            xn[bi, ya:yb, xa:xb, c0:c1]
        return halo

    def out_tile(t, n, acc):
        bi, y0, x0 = ch.tile_origin(plan, t)
        v = acc + bias[n]
        v = torch.relu(v) if relu else v
        v = v.to(torch.bfloat16).float().view(plan.th, plan.tw, -1)
        ty, tx = min(plan.th, h - y0), min(plan.tw, w - x0)
        dst = out[bi, y0:y0 + ty, x0:x0 + tx, n]
        assert torch.isnan(dst).all()
        out[bi, y0:y0 + ty, x0:x0 + tx, n] = v[:ty, :tx]

    tile_products(plan, halo_of, wmat,
                  lambda nt: slice(nt * plan.bn, min((nt + 1) * plan.bn,
                                                     cout)), out_tile)
    assert not torch.isnan(out).any()
    return out.permute(0, 3, 1, 2).to(torch.bfloat16)


def emulate_head(x, prepared, bias, shift, scale, nchw_out, plan, aligned):
    """T1's indexing in plain PyTorch: per tile, the raw C-major halo rows
    staged from the 8-pixel boundary left of the halo (16-byte chunks,
    whole chunks zero outside the image) or read value by value, then one
    normalize per staged value into the pixel-major halo, then the taps."""
    b, cin, h, w = x.shape
    cout = prepared.shape[0]
    wmat = prepared.float().view(cout, 9, -1)
    out = torch.full((b, h, w, cout), float("nan"))
    span = plan.tw + 16
    hh, hw = plan.th + 2, plan.tw + 2
    xf = x.float()

    def norm(v):
        return torch.where(v != 0, (v - shift) * scale,
                           torch.zeros_like(v)).to(torch.bfloat16).float()

    def halo_of(t, k):
        bi, y0, x0 = ch.tile_origin(plan, t)
        halo = torch.zeros(hh, hw, ch.KC)
        if aligned:
            raw = torch.zeros(cin, hh, span)
            for hr in range(hh):
                y = y0 - 1 + hr
                for j in range(span // 8):
                    xs = x0 - 8 + 8 * j
                    if 0 <= y < h and 0 <= xs < w:
                        raw[:, hr, 8 * j:8 * j + 8] = xf[bi, :, y, xs:xs + 8]
            vals = raw[:, :, 7:7 + hw]                # halo column hc -> hc + 7
        else:
            vals = torch.zeros(cin, hh, hw)
            ya, yb = max(y0 - 1, 0), min(y0 + plan.th + 1, h)
            xa, xb = max(x0 - 1, 0), min(x0 + plan.tw + 1, w)
            vals[:, ya - y0 + 1:yb - y0 + 1, xa - x0 + 1:xb - x0 + 1] = \
                xf[bi, :, ya:yb, xa:xb]
        halo[:, :, :cin] = norm(vals).permute(1, 2, 0)
        return halo

    def out_tile(t, n, acc):
        bi, y0, x0 = ch.tile_origin(plan, t)
        v = torch.relu(acc + bias.float()[n]).to(torch.bfloat16).float()
        v = v.view(plan.th, plan.tw, -1)
        ty, tx = min(plan.th, h - y0), min(plan.tw, w - x0)
        assert torch.isnan(out[bi, y0:y0 + ty, x0:x0 + tx, n]).all()
        out[bi, y0:y0 + ty, x0:x0 + tx, n] = v[:ty, :tx]

    tile_products(plan, halo_of, wmat,
                  lambda nt: slice(nt * plan.bn, min((nt + 1) * plan.bn,
                                                     cout)), out_tile)
    assert not torch.isnan(out).any()
    out = out.to(torch.bfloat16)
    return out.permute(0, 3, 1, 2).contiguous() if nchw_out else out


def conv_data(seed, b, h, w, cin, cout, bias=True):
    """Post-ReLU bf16 activations, a fan-in-scaled weight and a bias, from
    numpy."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((b, cin, h, w)), 0) * 2
    k = rng.standard_normal((cout, cin, 3, 3)) * (9 * cin) ** -0.5
    bi = rng.standard_normal(cout) * 0.1 if bias else None
    return (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(k.astype(np.float32)),
            None if bi is None else torch.from_numpy(bi.astype(np.float32)))


# the CUDA tests' shapes that stay small on the CPU, the 2-D tiling ones
EMU_CONV = [s for s in CONV_SHAPES if s[1] * s[2] * s[0] <= 4000]


@pytest.mark.parametrize("shape", EMU_CONV)
def test_emulated_conv_matches_plain(shape):
    b, h, w, cin, cout = shape
    relu = cin % 8 == 0                  # both epilogues over the shapes
    x, k, bias = conv_data(sum(shape), b, h, w, cin, cout, bias=cout != 8)
    plan = ch.conv_plan(b, h, w, cin, cout)
    got = emulate_conv(x, c3.prepare_conv_weights(k), bias, relu, plan)
    assert_bf16_close(got, c3.conv3x3_ref(x, k, bias, relu=relu))


def test_emulated_conv_streamed_weights_two_n_tiles():
    """Weights that do not stay resident (C_in 512) over two N tiles: the
    chunk walk and the N split give the plain conv."""
    x, k, bias = conv_data(5, 1, 8, 16, 512, 136)
    plan = ch.conv_plan(1, 8, 16, 512, 136)
    assert not plan.resident and plan.n_tiles_n == 2 and plan.chunks == 16
    got = emulate_conv(x, c3.prepare_conv_weights(k), bias, True, plan)
    assert_bf16_close(got, c3.conv3x3_ref(x, k, bias, relu=True))


@pytest.mark.parametrize("relu", [True, False])
def test_emulated_conv_matches_jax_interpret(relu):
    """The emulation against the JAX Pallas conv in interpret mode on bf16
    inputs (the JAX test's 24 -> 16 shape, 16 x 40, B=2)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 16, 40, 24)).astype(np.float32)
    kh = (rng.normal(size=(3, 3, 24, 16)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(jax_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kh), jnp.asarray(bias),
        relu=relu, impl="pallas_interpret").astype(jnp.float32))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    k = torch.from_numpy(kh).permute(3, 2, 0, 1).contiguous()
    plan = ch.conv_plan(2, 16, 40, 24, 16)
    got = emulate_conv(xt, c3.prepare_conv_weights(k),
                       torch.from_numpy(bias), relu, plan)
    assert_bf16_close(got.permute(0, 2, 3, 1),
                      torch.from_numpy(np.array(want)))


EMU_HEAD = [s for s in HEAD_SHAPES if s[0] * s[2] * s[3] <= 4000]


@pytest.mark.parametrize("nchw_out", [False, True])
@pytest.mark.parametrize("shape", EMU_HEAD)
def test_emulated_head_matches_plain(shape, nchw_out):
    """Both staging routes (aligned raw rows where W is a multiple of 8,
    value by value elsewhere; both also forced at W = 48) against
    ``head_cmajor_ref``."""
    b, cin, h, w, cout = shape
    x, w2, b4 = bench_head.make_inputs(7, shape, torch.device("cpu"))
    want = hc.head_cmajor_ref(x, w2, b4, shift=0.1, scale=1.5,
                              nchw_out=nchw_out)
    routes = (True, False) if w % 8 == 0 else (False,)
    for aligned in routes:
        plan = ch.head_plan(b, h, w, cin, cout, nchw_out=nchw_out,
                            aligned=aligned)
        got = emulate_head(x, c3.prepare_conv_weights(w2), b4, 0.1, 1.5,
                           nchw_out, plan, aligned)
        assert_bf16_close(got, want)


@pytest.mark.parametrize("nchw_out", [False, True])
def test_emulated_head_matches_jax_kernel(nchw_out):
    """The emulation against the JAX tool's ``kern`` (interpret mode) on
    the head test's window: zero border, half the values zero."""
    x, k5, bias = head_inputs(0)
    want = jax_kern(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k5),
                    jnp.asarray(bias), 0.1, 1.5, nchw_out)
    w2, b4 = port_weights(k5, bias)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    b, cin, h, w = xt.shape
    plan = ch.head_plan(b, h, w, cin, w2.shape[0], nchw_out=nchw_out,
                        aligned=True)
    got = emulate_head(xt, c3.prepare_conv_weights(w2), b4, 0.1, 1.5,
                       nchw_out, plan, True)
    assert_bf16_close(got, torch.from_numpy(
        np.array(want.astype(jnp.float32))))


def test_plan_device_count_scales_the_grid():
    """The persistent grid follows the card's SM count; a small card gets
    fewer blocks, never more tiles than exist."""
    big = ch.conv_plan(8, 220, 320, 20, 128)
    small = ch.conv_plan(8, 220, 320, 20, 128, sm_count=10)
    per_sm = ch.blocks_per_sm(big.bn, big.smem)
    assert small.grid_x == 10 * per_sm and big.grid_x == ch.H100_SMS * per_sm
    tiny = ch.conv_plan(1, 4, 4, 4, 8)
    assert tiny.n_tiles == 1 and tiny.grid_x == 1
