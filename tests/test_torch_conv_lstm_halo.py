"""The ConvLSTM cell kernels' plan and indexing on the halo-tile core, on
the CPU.

B2 (the exact bf16 cell, ``csrc/conv_lstm.cu``) and B2-int8
(``csrc/conv_lstm_int8.cu``) are one kernel of the halo-tile core
(``csrc/conv_halo.cuh::cell_kernel``) with its plan from
``ess_tpu_torch/ops/conv_halo.py::cell_plan``. The card is not here, so this
file holds:

- the plan to its contract at the three DSEC encoder levels (220x320,
  110x160, 55x80 with CX = CH = 64 / 128 / 256) at B = 1, 2 and 8, for
  both cells, and at every cell shape of the CUDA tests: shared memory
  within 232,448 bytes and equal to the layout the launcher rebuilds, the
  two-stage ring (a third stage does not fit), every output pixel in
  exactly one patch, the persistent blocks walking every (N tile, pixel
  tile) once, the ragged last patches masked;
- a plain emulation of the kernel's indexing: the halo of each chunk of
  concat(x, h) staged from x or h as the tensor map's box (zero outside
  the image) in its 64-byte swizzle, every tap's A rows read back through
  the kernel's XOR addressing, the weight stage read as wgmma's K-major
  core matrices from the kernel's weight image, and the gates taken from
  wgmma's m16n8 accumulator layout (each thread must hold the four gates
  of its channels). Held against ``conv_lstm_ref`` and the JAX package's
  Pallas cell in interpret mode; the int8 emulation against
  ``conv_lstm_int8_ref`` (bit-identical) and the JAX int8 cell;
- the plain version of the int8 prep kernels, bit-identical to
  ``input_scale`` + ``quantize_gate_weights`` + ``quantize``.

Bounds: the exact emulation sums the same bf16 products in f32 in another
order and rounds the state once: h atol 2e-2, c atol 3e-2 (the cell's
bounds everywhere in the port, tests/test_conv_lstm_pallas.py). The int8
emulation accumulates the same integers exactly and runs the same f32
operations as the plain int8 cell: identical. Against the JAX int8 cell in
interpret mode: atol 1e-5 (tests/test_torch_conv_lstm_int8.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops.conv_lstm_pallas import conv_lstm_cell as jax_cell

from ess_tpu_torch.ops import conv_halo as chl
from ess_tpu_torch.ops import conv_lstm as cl


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


# (B, H, W, CX, CH)
DSEC_CELLS = [(b, h, w, c, c) for b in (1, 2, 8)
              for h, w, c in ((220, 320, 64), (110, 160, 128), (55, 80, 256))]
# the cell shapes of tests/test_torch_kernels_cuda.py
CUDA_CELLS = [(2, 10, 13, 32, 32), (1, 22, 40, 64, 64), (2, 9, 11, 256, 256),
              (1, 5, 7, 64, 32), (1, 9, 11, 256, 256), (2, 220, 320, 64, 64),
              (2, 110, 160, 128, 128), (2, 55, 80, 256, 256),
              (1, 55, 80, 256, 256), (3, 55, 80, 256, 256),
              (3, 37, 50, 32, 64), (1, 37, 50, 96, 32), (1, 12, 14, 32, 64),
              (2, 22, 40, 64, 64)]


def make(b, h, w, cx, ch, seed=0, relu=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cx)) * (2.0 if relu else 1.0)
    if relu:
        x = np.maximum(x, 0.0)
    hp = np.tanh(rng.normal(size=(b, h, w, ch)))
    cp = rng.normal(size=(b, h, w, ch))
    kern = rng.normal(size=(3, 3, cx + ch, 4 * ch)) * (9 * (cx + ch)) ** -0.5
    bias = rng.normal(size=(4 * ch,)) * 0.1
    return tuple(a.astype(np.float32) for a in (x, hp, cp, kern, bias))


def to_torch(x, hp, cp, kern, bias):
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return (nchw(x), nchw(hp), nchw(cp),
            torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous(),
            torch.from_numpy(bias))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", DSEC_CELLS + CUDA_CELLS)
def test_cell_plan_contract(shape, int8):
    b, h, w, cx, ch = shape
    check_cell_plan(chl.cell_plan(b, h, w, cx, ch, int8=int8),
                    b, h, w, cx, ch, int8)


def check_cell_plan(plan, b, h, w, cx, ch, int8):
    assert plan.th * plan.tw == plan.bm == chl.CELL_BM
    assert plan.tw % 16 == 0 and plan.bn == chl.CELL_BN
    assert (plan.th, plan.tw) in chl.CELL_PATCHES
    assert plan.tiles_y == -(-h // plan.th) and plan.tiles_x == -(-w // plan.tw)
    assert plan.n_tiles == b * plan.tiles_y * plan.tiles_x
    assert plan.n_tiles_n * chl.CELL_BN == 4 * ch
    # chunks of 64 bytes a pixel: x's, then h's, channels padded to kc
    assert plan.kc == (64 if int8 else 32)
    assert plan.chunks_x == -(-cx // plan.kc)
    assert plan.chunks == plan.chunks_x + -(-ch // plan.kc)
    # the layout the launcher rebuilds, within the budget: a ring of two
    # stages, where a third would not fit
    halo = -(-(plan.th + 2) * (plan.tw + 2) * 64 // 1024) * 1024
    want = 1024 + 2 * (36 * 128 * 16 + halo) + 8 * 2 * 16 * 40 * 2 + 64
    assert chl.CELL_STAGES == 2
    assert plan.smem == want == chl.cell_smem(plan.th, plan.tw)
    assert plan.smem <= chl.MAX_SMEM
    assert chl.cell_smem(plan.th, plan.tw, 3) > chl.MAX_SMEM
    # one block per SM at most, none without work
    assert 1 <= plan.grid <= min(chl.H100_SMS, plan.n_tiles * plan.n_tiles_n)
    # every (N tile, pixel tile) once, the walks of the blocks within one
    # item of each other
    walks = [chl.cell_items(plan, blk) for blk in range(plan.grid)]
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    seen = [it for wk in walks for it in wk]
    assert sorted(seen) == [(nt, t) for nt in range(plan.n_tiles_n)
                            for t in range(plan.n_tiles)]
    # every output pixel in exactly one patch; patches start in the image
    count = np.zeros((b, h, w), np.int32)
    for t in range(plan.n_tiles):
        bi, y0, x0 = chl.tile_origin(plan, t)
        assert 0 <= bi < b and 0 <= y0 < h and 0 <= x0 < w
        count[bi, y0:y0 + plan.th, x0:x0 + plan.tw] += 1
    assert (count == 1).all()
    if (h, w) == (55, 80):
        # level 2: 16 x 16 patches, 9 rows of the last patch row masked
        assert (plan.th, plan.tw) == (16, 16) and plan.tiles_y == 4
    if (b, h, w, cx, ch) in DSEC_CELLS:
        assert plan.grid == chl.H100_SMS


def test_cell_plan_refuses():
    for cx, ch in ((16, 32), (32, 48), (0, 32)):
        with pytest.raises(ValueError):
            chl.cell_plan(1, 8, 8, cx, ch, int8=False)


def swizzled(halo_bytes: torch.Tensor) -> torch.Tensor:
    """The TMA's 64-byte swizzle of a staged halo ((npix, 64) bytes, from a
    1,024-byte-aligned base): 16-byte piece j of pixel p lands at piece
    j ^ ((p >> 1) & 3); returns the flat shared-memory bytes."""
    npix = halo_bytes.shape[0]
    p = torch.arange(npix)[:, None]
    j = torch.arange(4)[None, :]
    dst = p * 64 + ((j ^ ((p >> 1) & 3)) * 16)
    smem = torch.zeros(npix * 64, dtype=torch.uint8)
    src = halo_bytes.view(npix, 4, 16)
    idx = (dst[..., None] + torch.arange(16)).reshape(-1)
    smem[idx] = src.reshape(-1)
    return smem


def read_a(smem, plan, s):
    """k-step s's A rows as the consumers' ldmatrix reads them: pixel row m
    of the tile at tap s // 2, pieces 2 (s % 2) and 2 (s % 2) + 1 through
    the kernel's XOR addressing (``load_a_sw``). (256, 32) bytes."""
    hw = plan.tw + 2
    tap = s // 2
    dy, dx = divmod(tap, 3)
    m = torch.arange(plan.bm)
    p = (m // plan.tw) * hw + m % plan.tw + dy * hw + dx
    rows = []
    for jj in range(2):
        j = (s % 2) * 2 + jj
        addr = p * 64 + (((j ^ (p >> 1)) & 3) << 4)
        rows.append(smem[(addr[:, None] + torch.arange(16)).reshape(-1)]
                    .view(plan.bm, 16))
    return torch.cat(rows, 1)


def read_b(stage, s):
    """k-step s's B operand from a weight stage through the descriptor
    (start + 2 s k groups, 2,048 bytes between k groups, 16 bytes between
    columns): (128 columns, 32) bytes."""
    core = stage.view(36, 128, 16)
    return torch.cat([core[2 * s], core[2 * s + 1]], 1)


def owner(m, col):
    """(warp, lane, register) of accumulator (row m, column col) of a
    block tile in wgmma's m16n8 layout: warpgroup m // 128 (row tile
    (m // 64) % 2), warp (m % 64) // 16, lane 4 (row % 8) + (col % 8) // 2."""
    wg, mt, r16 = m // 128, (m // 64) % 2, m % 64
    warp = wg * 4 + r16 // 16
    row = r16 % 16
    lane = 4 * (row % 8) + (col % 8) // 2
    return warp, mt, lane, 2 * (row // 8) + col % 2


def emulate_cell(x_src, h_src, c_prev, image, bias, plan, ws=None):
    """The cell kernel's indexing in plain PyTorch. x_src, h_src: NHWC
    sources of the halo (bf16, or the int8 copies with channels padded to
    64); image: the weight image; ws: the int8 column scales (i, f, o, g
    order) or None for the exact cell. Returns (h', c') NHWC f32, each
    output element written once."""
    int8 = ws is not None
    b, h, w = x_src.shape[:3]
    ch = c_prev.shape[-1]
    dt = torch.int8 if int8 else torch.bfloat16
    cvt = (lambda t: t.view(torch.int8).to(torch.int64)) if int8 else (
        lambda t: t.view(torch.bfloat16).float())
    img = image.reshape(plan.n_tiles_n, plan.chunks, -1).view(torch.uint8)
    h_out = torch.full((b, h, w, ch), float("nan"))
    c_out = torch.full((b, h, w, ch), float("nan"))
    n = torch.arange(plan.bn)
    for blk in range(plan.grid):
        for nt, t in chl.cell_items(plan, blk):
            bi, y0, x0 = chl.tile_origin(plan, t)
            acc = torch.zeros(plan.bm, plan.bn,
                              dtype=torch.int64 if int8 else torch.float32)
            for k in range(plan.chunks):
                src = x_src if k < plan.chunks_x else h_src
                kk = k if k < plan.chunks_x else k - plan.chunks_x
                box = torch.zeros(plan.th + 2, plan.tw + 2, 64 // dt.itemsize,
                                  dtype=dt)
                ya, yb = max(y0 - 1, 0), min(y0 + plan.th + 1, h)
                xa, xb = max(x0 - 1, 0), min(x0 + plan.tw + 1, w)
                c0 = kk * plan.kc
                c1 = min(c0 + plan.kc, src.shape[-1])
                box[ya - y0 + 1:yb - y0 + 1, xa - x0 + 1:xb - x0 + 1,
                    :c1 - c0] = src[bi, ya:yb, xa:xb, c0:c1]
                smem = swizzled(box.reshape(-1).view(torch.uint8)
                                .view(-1, 64))
                stage = img[nt, k]
                for s in range(18):
                    a = cvt(read_a(smem, plan, s).contiguous())
                    bm = cvt(read_b(stage, s).contiguous())
                    acc += a @ bm.T
            # the epilogue: thread (warp, lane) holds columns g4 * 32 + g * 8
            # + e of its rows, all four gates of channel g4 * 8 + e
            cloc = torch.arange(plan.bn // 4)
            cols = torch.stack([(cloc // 8) * 32 + g * 8 + cloc % 8
                                for g in range(4)])          # (4, 32)
            for m in (0, 77, 200, 255):
                own = {tuple(owner(m, int(cc))[:3]) for cc in cols[:, 5]}
                assert len(own) == 1
            chan = nt * (plan.bn // 4) + cloc
            gi = torch.stack([g * ch + chan for g in range(4)])
            if int8:
                gates = acc[:, cols].float() * ws[gi] + bias[gi]
            else:
                gates = acc[:, cols] + bias[gi]
            m = torch.arange(plan.bm)
            yy, xx = y0 + m // plan.tw, x0 + m % plan.tw
            ok = (yy < h) & (xx < w)
            yy, xx = yy[ok], xx[ok]
            cp = c_prev[bi, yy][:, :, chan][torch.arange(len(xx)), xx]
            hn, cn = cl._pointwise(gates[ok].reshape(-1, 4 * len(cloc)),
                                   cp)
            assert torch.isnan(h_out[bi, yy, xx][:, chan]).all()
            for t_, v in ((h_out, hn), (c_out, cn)):
                blk_v = t_[bi, yy, xx]
                blk_v[:, chan] = v
                t_[bi, yy, xx] = blk_v
    assert not torch.isnan(h_out).any() and not torch.isnan(c_out).any()
    return h_out, c_out


# a ragged patch in both directions (18 x 20 against 8 x 32 patches),
# CX != CH, two N tiles
SMALL = (1, 18, 20, 32, 64)


def test_emulated_cell_matches_plain_and_jax():
    args = make(*SMALL, seed=11)
    x, hp, cp, kern, bias = to_torch(*args)
    b, h, w, cx, ch = SMALL
    plan = chl.cell_plan(b, h, w, cx, ch, int8=False)
    assert (plan.th, plan.tw, plan.n_tiles, plan.n_tiles_n) == (8, 32, 3, 2)
    image = cl.gate_weight_image(cl.prepare_gate_weights(kern))
    hn, cn = emulate_cell(x.permute(0, 2, 3, 1), hp.permute(0, 2, 3, 1),
                          cp.permute(0, 2, 3, 1).float(), image,
                          bias.float(), plan)
    hn, cn = hn.to(torch.bfloat16), cn.to(torch.bfloat16)
    h_ref, c_ref = cl.conv_lstm_ref(x, hp, cp, kern, bias)
    torch.testing.assert_close(hn.float(), h_ref.permute(0, 2, 3, 1).float(),
                               atol=2e-2, rtol=0)
    torch.testing.assert_close(cn.float(), c_ref.permute(0, 2, 3, 1).float(),
                               atol=3e-2, rtol=0)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    hj, cj = jax_cell(bf(args[0]), bf(args[1]), bf(args[2]),
                      jnp.asarray(args[3]), jnp.asarray(args[4]),
                      impl="pallas_interpret")
    np.testing.assert_allclose(hn.float().numpy(), np.asarray(hj, np.float32),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(cn.float().numpy(), np.asarray(cj, np.float32),
                               atol=3e-2, rtol=0)


def test_emulated_int8_cell_is_the_plain_int8_cell():
    args = make(*SMALL, seed=12, relu=True)
    x, hp, cp, kern, bias = to_torch(*args)
    b, h, w, cx, ch = SMALL
    plan = chl.cell_plan(b, h, w, cx, ch, int8=True)
    assert plan.chunks_x == 1 and plan.chunks == 2     # x's chunk padded
    prep = cl.prepare_gate_weights(kern, torch.float32)
    _, w_img, ws, xq, hq = cl.int8_prep_ref(x, hp, prep, cx)
    hn, cn = emulate_cell(xq, hq, cp.permute(0, 2, 3, 1).float(), w_img,
                          bias.float(), plan, ws=ws)
    hn, cn = hn.to(torch.bfloat16), cn.to(torch.bfloat16)
    h_ref, c_ref = cl.conv_lstm_int8_ref(x, hp, cp, kern, bias)
    assert torch.equal(hn, h_ref.permute(0, 2, 3, 1))
    assert torch.equal(cn, c_ref.permute(0, 2, 3, 1))
    # the JAX int8 cell on the same (bf16-valued) operands in f32: the
    # plain int8 cell in f32 within 1e-5, and the emulation is that cell's
    # result rounded to bf16
    ops = [t.float() for t in (x, hp, cp)]
    hj, cj = jax_cell(*(jnp.asarray(nhwc(t)) for t in ops),
                      jnp.asarray(args[3]), jnp.asarray(args[4]),
                      impl="pallas_int8_interpret")
    hf, cf = cl.conv_lstm_int8_ref(*ops, kern, bias)
    np.testing.assert_allclose(nhwc(hf), np.asarray(hj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(nhwc(cf), np.asarray(cj), atol=1e-5, rtol=0)
    assert torch.equal(hn, hf.to(torch.bfloat16).permute(0, 2, 3, 1))
    assert torch.equal(cn, cf.to(torch.bfloat16).permute(0, 2, 3, 1))


@pytest.mark.parametrize("shape", [(2, 5, 7, 32, 64), (1, 6, 9, 64, 32),
                                   (1, 4, 4, 96, 96)])
def test_int8_prep_is_the_torch_prep(shape):
    """The plain version of the prep kernels (absmax over bf16 bits, the
    weight re-quantization into the image, the padded x/h copies) gives
    what ``input_scale``, ``quantize_gate_weights`` and ``quantize`` give."""
    b, h, w, cx, ch = shape
    args = make(*shape, seed=cx + ch)
    x, hp, _, kern, _ = to_torch(*args)
    x = x * 3
    prep = cl.prepare_gate_weights(kern, torch.float32)
    scal, w_img, ws, xq, hq = cl.int8_prep_ref(x, hp, prep, cx)
    s_x = cl.input_scale(x)
    inv = torch.reciprocal(s_x)
    assert torch.equal(scal, torch.stack([s_x, inv]))
    wq, ws_t = cl.quantize_gate_weights(kern, s_x, cx, prepared=prep)
    assert torch.equal(ws, ws_t)
    kc = cl.INT8_KC
    cxp, chp = -(-cx // kc) * kc, -(-ch // kc) * kc
    assert w_img.shape == (4 * ch // 128, (cxp + chp) // kc, 36, 128, 16)
    # the image's stage bytes: (k group, column) -> 16 channels of one tap
    img = w_img.reshape(4 * ch // 128, (cxp + chp) // kc, 9, 4, 128, 16)
    full = img.permute(0, 4, 2, 1, 3, 5).reshape(4 * ch, 9, cxp + chp)
    assert torch.equal(full[:, :, :cx], wq.view(4 * ch, 9, cx + ch)[:, :, :cx])
    assert torch.equal(full[:, :, cxp:cxp + ch],
                       wq.view(4 * ch, 9, cx + ch)[:, :, cx:])
    assert not full[:, :, cx:cxp].any() and not full[:, :, cxp + ch:].any()
    assert torch.equal(xq[..., :cx], cl.quantize(x, inv).permute(0, 2, 3, 1))
    assert torch.equal(hq[..., :ch], cl.quantize(hp, 127.0).permute(0, 2, 3, 1))
    assert not xq[..., cx:].any() and not hq[..., ch:].any()


def test_exact_weight_image_layout():
    """Stage (N tile, chunk) of the exact image is wgmma's K-major core
    matrices: k group tap * 4 + q holds channels 8 q .. 8 q + 7 of the
    chunk's 32 at tap, for the N tile's 128 prepared columns."""
    cx, ch = 32, 64
    kern = torch.randn(4 * ch, cx + ch, 3, 3)
    prep = cl.prepare_gate_weights(kern)
    img = cl.gate_weight_image(prep)
    assert img.shape == (2, 3, 36, 128, 8) and img.dtype == torch.bfloat16
    for nt, k, tap, q, col in ((0, 0, 0, 0, 0), (1, 2, 8, 3, 127),
                               (0, 1, 4, 2, 77)):
        cin = k * 32 + q * 8
        want = prep[nt * 128 + col, tap * (cx + ch) + cin:
                    tap * (cx + ch) + cin + 8]
        assert torch.equal(img[nt, k, tap * 4 + q, col], want)
