"""The fused encoder level B5 on the halo-tile core (CPU).

``csrc/level_int8.cu`` runs only on the card; what surrounds it is checked
here:

- the plan (``ops/conv_halo.py::level_plan``) at the three DSEC levels
  (B = 1, 2, 8), at a 55-row level with th = 11 and at every shape the CUDA
  tests launch: the conv's pixel tiles lie inside one group's th + 2 x rows
  and cover each of them once per group, the gate kernel's tiles lie inside
  one group's th output rows and cover each once; the scale each tile reads
  is its group's (its x rows are the image rows r0-1 .. r0+th of that
  group, its gate rows r0 .. r0+th-1); shared memory fits a block and the
  grids fit their items;
- a plain emulation of the three kernels' indexing, tile by tile in the
  plan's order: the group absmax of u; the conv's halo gather (image rows
  of the group, a full-resolution u read at (2Y+r, 2X+s) by the kernel's
  phase formula, zeros past the image and past CU), quantized by the
  group's scale, products with the padded conv matrix ``we_k``, the
  epilogue's f32 operations, rows past the group's th + 2 not stored; then
  the gate kernel's halo of x (group layout) and h (image layout), both
  quantized as staged, products with the weight image ``wg_img`` of each N
  tile, two accumulators, the gate epilogue and the pointwise, rows past
  the group's th not stored, then the pointwise. Every x value and gate
  value is stored exactly once, and x, both scales, h' and c' are bit for
  bit those of ``level_int8_ref`` (the same f32 operations on exact
  integers).
"""

import numpy as np
import pytest
import torch

from ess_tpu_torch.ops import conv_halo as chp
from ess_tpu_torch.ops import level as lv
from ess_tpu_torch.ops.conv_lstm import gate_column_order, pick_row_tile


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


# (B, HO, WO, CU, CH): the three DSEC levels at the tools' B=8 and at B=1,
# 2, a 55-row level (th = 11), and the CUDA tests' other level shapes
DSEC_LEVELS = [(b, 220, 320, 128, 64) for b in (1, 2, 8)] + [
    (b, 110, 160, 256, 128) for b in (1, 2, 8)] + [
    (b, 55, 80, 512, 256) for b in (1, 2, 8)]
OTHER_LEVELS = [(1, 55, 40, 64, 32), (1, 39, 20, 128, 64),
                (2, 13, 12, 16, 32), (1, 7, 5, 32, 32)]


def coverage(part, groups, rows, wo):
    """How often each (group, row, column) is covered by the plan part's
    pixel tiles, rows and columns past ``rows`` x ``wo`` not counted."""
    seen = np.zeros((groups, rows, wo), np.int64)
    for t in range(part.n_tiles):
        g, y0, x0 = chp.tile_origin(part, t)
        assert 0 <= g < groups and 0 <= y0 < rows and 0 <= x0 < wo
        seen[g, y0:y0 + part.th, x0:x0 + part.tw] += 1
    return seen


@pytest.mark.parametrize("shape", DSEC_LEVELS + OTHER_LEVELS,
                         ids=lambda s: "x".join(map(str, s)))
def test_level_plan(shape):
    b, ho, wo, cu, ch = shape
    th = pick_row_tile(ho)
    plan = chp.level_plan(b, ho, wo, cu, ch, th)
    nt = ho // th
    assert (plan.th, plan.nt, plan.groups) == (th, nt, b * nt)
    if (ho, wo) == (55, 80):
        assert th == 11
    assert 1 <= plan.amax_blocks <= chp.AMAX_BLOCKS
    c, g = plan.conv, plan.gates
    # the conv: tiles of one group's th + 2 x rows, each row once
    assert (c.th * c.tw, c.bn) == chp.block_shape(ch) and c.tw % 16 == 0
    assert c.tiles_y == -(-(th + 2) // c.th) and c.q_stages == 1
    assert (coverage(c, plan.groups, th + 2, wo) == 1).all()
    assert c.chunks == -(-cu // 64) and c.n_tiles_n == -(-ch // c.bn)
    assert c.smem == chp.conv_smem(c.th, c.tw, c.bn, c.chunks, c.resident,
                                   chp.raw_pitch(cu), 1) <= chp.MAX_SMEM
    assert 1 <= c.grid_x <= c.n_tiles
    # the gates: 128-pixel tiles of one group's th rows, each row once
    assert (g.th, g.tw) in chp.LEVEL_GATE_PATCHES and g.bm == 128
    assert g.tiles_y == -(-th // g.th)
    assert (coverage(g, plan.groups, th, wo) == 1).all()
    assert (g.n_tiles_n, g.chunks_x, g.chunks) == (
        4 * ch // 128, -(-ch // 64), 2 * -(-ch // 64))
    assert g.smem == chp.level_gate_smem(g.th, g.tw, g.chunks,
                                         plan.gate_halves) <= chp.MAX_SMEM
    assert plan.gate_halves == (2 if chp.level_gate_smem(
        g.th, g.tw, g.chunks, 2) <= chp.MAX_SMEM else 1)
    assert 1 <= g.grid <= g.n_tiles
    # the scale each tile reads: its group's, whose rows it covers
    for part, first, rows in ((c, -1, th + 2), (g, 0, th)):
        for t in range(0, part.n_tiles, max(1, part.n_tiles // 301)):
            grp, y0, _ = chp.tile_origin(part, t)
            bi, it = divmod(grp, nt)
            lo = it * th + first + y0
            hi = it * th + first + min(y0 + part.th, rows)
            # image rows of the tile's stored outputs: inside the group's
            assert it * th + first <= lo < hi <= it * th + first + rows
            assert t // (part.tiles_y * part.tiles_x) == grp


def test_level_plan_choices():
    """The DSEC levels' patches: the conv's 8 x 32 (L0) and 8 x 16 (L1,
    L2), the gates' 8 x 16 (L0, L1) and 4 x 32 (L2: 11 rows pad to 12, not
    16); L0's conv weights resident, L1's and L2's streamed; the gates'
    weight stages a whole chunk at L0 and L1, half a chunk at L2 (its 8
    chunks' halos take 106 KB)."""
    got = []
    for b, ho, wo, cu, ch in DSEC_LEVELS[2::3]:
        p = chp.level_plan(b, ho, wo, cu, ch, pick_row_tile(ho))
        got.append(((p.conv.th, p.conv.tw), p.conv.resident,
                    (p.gates.th, p.gates.tw), p.gate_halves))
    assert got == [((8, 32), True, (8, 16), 2), ((8, 16), False, (8, 16), 2),
                   ((8, 16), False, (4, 32), 1)]
    with pytest.raises(ValueError):
        chp.level_plan(1, 55, 80, 512, 48, 11)        # CH not a multiple
    with pytest.raises(ValueError):
        chp.level_plan(1, 55, 80, 512, 64, 10)        # th does not divide
    with pytest.raises(ValueError):
        chp.level_plan(1, 55, 80, 512, 384, 11)       # halos do not fit


# --- plain emulation of the kernels' indexing ------------------------------

def q8(v, s):
    """The kernels' quantize: clip(round_half_even(v * s), -127, 127)."""
    return torch.clamp(torch.round(v * s), -127, 127)


def emulate(u, h_prev, c_prev, prep, *, u_s2d, th):
    """The three kernels' work on CPU tensors (NCHW in, like the plain
    version): returns (x (G, th+2, WO, CH), amax_u, amax_x, h', c')."""
    b, ch, ho, wo = h_prev.shape
    cu = u.shape[1] if u_s2d else 4 * u.shape[1]
    c1 = cu // 4
    plan = chp.level_plan(b, ho, wo, cu, ch, th)
    nt, groups = plan.nt, plan.groups
    uf = u.float()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    c127 = f32(127.0)

    # kernel 1: the group absmax of u over rows r0-2 .. r0+th+1
    amax_u = torch.zeros(groups)
    for grp in range(groups):
        bi, it = divmod(grp, nt)
        lo, hi = max(0, it * th - 2), min(ho, it * th + th + 2)
        rows = uf[bi, :, lo:hi] if u_s2d else uf[bi, :, 2 * lo:2 * hi]
        amax_u[grp] = rows.abs().amax()

    # kernel 2: the conv, tile by tile
    cp = plan.conv
    cup = cp.chunks * 64
    wk = prep.we_k.view(ch, 3, 3, cup).permute(0, 3, 1, 2).double()
    xs = torch.full((groups, th + 2, wo, ch), float("nan"))
    stored = torch.zeros(groups, th + 2, wo, dtype=torch.int64)
    amax_x = torch.zeros(groups)
    for t in range(cp.n_tiles):
        grp, y0, x0 = chp.tile_origin(cp, t)
        bi, it = divmod(grp, nt)
        am = torch.clamp(amax_u[grp], min=lv.AMAX_FLOOR)
        s_q, su = torch.div(c127, am), torch.div(am, c127)
        R = (it * th - 2 + y0 + torch.arange(cp.th + 2))[:, None, None]
        X = (x0 - 1 + torch.arange(cp.tw + 2))[None, :, None]
        cs = torch.arange(cup)[None, None, :]
        ok = (R >= 0) & (R < ho) & (X >= 0) & (X < wo) & (cs < cu)
        Rc, Xc, cc = (torch.clamp(R, 0, ho - 1), torch.clamp(X, 0, wo - 1),
                      torch.clamp(cs, 0, cu - 1))
        if u_s2d:
            v = uf[bi][cc, Rc, Xc]
        else:
            ph, ci = cc // c1, cc % c1
            v = uf[bi][ci, 2 * Rc + ph // 2, 2 * Xc + ph % 2]
        halo = torch.where(ok, q8(v, s_q), torch.zeros(()))   # (hr, hc, ci)
        acc = torch.nn.functional.conv2d(
            halo.permute(2, 0, 1)[None].double(), wk)[0]      # (CH, th, tw)
        for r in range(cp.th):
            gl = y0 + r
            if gl >= th + 2:
                continue
            row = it * th - 1 + gl
            for c in range(cp.tw):
                x = x0 + c
                if x >= wo:
                    continue
                val = torch.relu(acc[:, r, c].float()
                                 * (prep.sbe[0] * su) + prep.sbe[1])
                if not 0 <= row < ho:
                    val = torch.zeros(ch)
                xs[grp, gl, x] = val
                stored[grp, gl, x] += 1
                amax_x[grp] = torch.maximum(amax_x[grp], val.max())
    assert (stored == 1).all()

    # kernel 3: the gates, item by item; the pointwise on them (the same
    # elementwise torch operations as the plain version on the same shape,
    # so that their vectorized transcendentals round alike)
    gp = plan.gates
    hf = h_prev.float()
    order = gate_column_order(ch)                  # prepared -> original
    gates_all = torch.full((b, 4 * ch, ho, wo), float("nan"))
    written = torch.zeros(b, 4 * ch, ho, wo, dtype=torch.int64)
    chp_ = gp.chunks_x * 64
    for t in range(gp.n_tiles):
        grp, ly0, x0 = chp.tile_origin(gp, t)
        bi, it = divmod(grp, nt)
        ax = torch.clamp(amax_x[grp], min=lv.AMAX_FLOOR)
        sx, sxg = torch.div(c127, ax), torch.div(ax, c127)
        hr = torch.arange(gp.th + 2)[:, None, None]
        X = (x0 - 1 + torch.arange(gp.tw + 2))[None, :, None]
        cc = torch.arange(chp_)[None, None, :]
        Xc, ccc = torch.clamp(X, 0, wo - 1), torch.clamp(cc, 0, ch - 1)
        gr = ly0 + hr
        okx = (gr < th + 2) & (X >= 0) & (X < wo) & (cc < ch)
        vx = xs[grp][torch.clamp(gr, 0, th + 1), Xc, ccc]
        hx = torch.where(okx, q8(vx, sx), torch.zeros(()))
        R = it * th + ly0 - 1 + hr
        okh = (R >= 0) & (R < ho) & (X >= 0) & (X < wo) & (cc < ch)
        vh = hf[bi][ccc, torch.clamp(R, 0, ho - 1), Xc]
        hh = torch.where(okh, q8(vh, 127.0), torch.zeros(()))
        for ntile in range(gp.n_tiles_n):
            # (chunks, half, tap, 2, 128, 16): W[n, k, tap, ci] is byte
            # ci % 16 of k group (ci // 32, ci // 16 % 2) of tap
            img = prep.wg_img[ntile].double()
            w = img.permute(4, 0, 2, 1, 3, 5).reshape(128, gp.chunks, 9, 64)
            wx = w[:, :gp.chunks_x].permute(0, 1, 3, 2).reshape(
                128, gp.chunks_x * 64, 3, 3)
            wh = w[:, gp.chunks_x:].permute(0, 1, 3, 2).reshape(
                128, gp.chunks_x * 64, 3, 3)
            acc_x = torch.nn.functional.conv2d(
                hx.permute(2, 0, 1)[None].double(), wx)[0]
            acc_h = torch.nn.functional.conv2d(
                hh.permute(2, 0, 1)[None].double(), wh)[0]
            cols = order[ntile * 128:(ntile + 1) * 128]     # original cols
            gates = (acc_x.float() * (prep.sbg[0][cols] * sxg)[:, None, None]
                     + acc_h.float() * prep.sbg[1][cols][:, None, None]
                     + prep.sbg[2][cols][:, None, None])    # (128, th, tw)
            rows = min(gp.th, th - ly0)
            cols_w = min(gp.tw, wo - x0)
            y = it * th + ly0
            gates_all[bi, cols, y:y + rows, x0:x0 + cols_w] = \
                gates[:, :rows, :cols_w]
            written[bi, cols, y:y + rows, x0:x0 + cols_w] += 1
    assert (written == 1).all()
    h_new, c_new = lv._pointwise(gates_all, c_prev)
    return (xs, amax_u, amax_x, h_new.to(u.dtype), c_new.to(c_prev.dtype))


def level_inputs(seed, ushape, ch, u_s2d):
    from ess_tpu_torch.tools import bench_level

    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(seed, ushape, ch,
                                                        u_s2d, "cpu")
    gb = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.05, 4 * ch).astype(np.float32))
    return u, h0, c0, lv.prepare_level_weights(ek, eb, gk, gb)


# (u shape NCHW, CH, u_s2d): a full-resolution level with three row tiles
# and a conv tile past the group's rows, a space-to-depth level of CU = 16
# with a ragged tile, the CUDA tests' smallest level, and a 55-row level
# whose groups of 11 rows take the 4 x 32 gate patch
EMU_CASES = [((1, 32, 78, 40), 64, False), ((2, 16, 26, 24), 32, True),
             ((1, 8, 14, 10), 32, False), ((1, 64, 55, 32), 32, True)]


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "x".join(
    map(str, c[0])) + f"-ch{c[1]}-{'s2d' if c[2] else 'full'}")
def test_emulation_matches_the_plain_version(case):
    ushape, ch, u_s2d = case
    u, h0, c0, prep = level_inputs(3, ushape, ch, u_s2d)
    th = pick_row_tile(h0.shape[2])
    want = lv.level_int8_ref(u, h0, c0, prep, u_s2d=u_s2d, th=th)
    x_ref, au_ref = lv.level_x_ref(u, prep, u_s2d=u_s2d, th=th)
    xs, amax_u, amax_x, h_new, c_new = emulate(u, h0, c0, prep, u_s2d=u_s2d,
                                               th=th)
    assert torch.equal(xs, x_ref.permute(0, 2, 3, 1))
    assert torch.equal(torch.clamp(amax_u, min=lv.AMAX_FLOOR), au_ref)
    assert torch.equal(torch.clamp(amax_u, min=lv.AMAX_FLOOR), want[2])
    assert torch.equal(torch.clamp(amax_x, min=lv.AMAX_FLOOR), want[3])
    assert torch.equal(h_new, want[0]) and torch.equal(c_new, want[1])
    if ushape[2] == 55:
        assert chp.level_plan(1, 55, 32, 64, ch, th).gates.th == 4
