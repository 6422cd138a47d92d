"""The persistent scatter core of the voxelizers B1, B3-legacy and B3 (CPU).

``csrc/voxel_scatter.cuh`` runs only on the card; what surrounds it is
checked here:

- the plan (``ops/voxel_scatter.py::scatter_plan``) at the DSEC shape
  (480x640, 5 bins) x 1, 8, 40 and 160 windows, at 10 bins (tile height
  10) and at every shape the CUDA tests launch: its work items cover every
  (window, tile) exactly once, its tile stores every grid element exactly
  once, its shared memory fits a block (227 KB) and its blocks an SM
  (shared memory, threads and the registers the kernels' launch bounds
  allow);
- a plain emulation of the kernels' indexing: the plan's items in each
  block's order, a ``bins x tile_h x 128`` accumulator per item, B1's own
  range, B3's gather rule (the item's own range and those of its upper,
  left and upper-left neighbours, the early reject on the neighbour's last
  row or column, each event's fractions in its own tile's frame, only the
  corners inside the item's tile kept), the tile stores and B1's per-item
  stats. It is held against ``voxelize_tiled_ref`` / ``voxelize_folded_ref``
  at atol 1e-6 / rtol 1e-5 (the same f32 corner weights; only the order of
  the sums differs), bit for bit against itself without the early reject,
  and against the JAX ``voxelize_tiled(interpret=True, oh_dtype=f32)`` at
  the ``F32`` bound of ``tests/test_torch_voxel_tiled.py`` (atol 2e-3 /
  rtol 1e-4: same weights, other summation order);
- cases: events in (-1, 0), on tile-row and tile-column edges, on the last
  row and column, ``ts == bins - 1``, a tile whose neighbours are empty,
  an empty tile beside full ones and an empty window;
- B3-legacy (the plan's ``mode='band'``): the plan (items, the boxes, the
  offsets' columns, the band each item walks), a transcription of the
  launcher's layout check (``voxel_scatter.cuh::launch``) that accepts the
  plan and refuses one that disagrees, and the emulation of its band rule
  (each (window, band, tile) item walks its band's records, rejects those
  whose ``floor(x)`` is not in ``[128 tx - 1, 128 tx + 127]`` and deposits
  the rest in its tile's frame) on records of
  ``host_band_bin_folded(x_slots=False)``: bit for bit against
  ``voxelize_folded_ref`` (a cell receives the same weights in the same
  order: corner by corner, records in order) and against itself without the
  reject, the partials summed per window within the stats bound of B1's
  test; edge records at x = 127.0, just below a 128-column boundary and on
  the last column, empty bands, a band holding most of the events, and the
  DSEC shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops import voxel_pallas as jvp

from ess_tpu_torch.ops import voxel_folded as vf
from ess_tpu_torch.ops import voxel_scatter as vs
from ess_tpu_torch.ops import voxel_tiled as vt
from tests.test_torch_voxel_tiled import F32, kernel_inputs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


ORDER = dict(atol=1e-6, rtol=1e-5)
KAHEAD = 1024      # voxel_scatter.cuh::kAhead

# (bins, height, width, windows) of the padded grids the CUDA tests and
# chip_smoke.py launch
CUDA_SHAPES = [(5, 480, 640, n) for n in (1, 2, 3, 8, 40, 160)] + [
    (5, 48, 256, 3), (5, 48, 256, 2), (5, 48, 256, 8), (5, 48, 384, 2),
    (5, 120, 128, 4), (5, 120, 128, 8), (5, 72, 128, 3), (5, 72, 256, 3),
    (5, 72, 384, 3), (5, 24, 128, 8), (10, 480, 640, 8)]


def check_plan(plan, n_sm=vs.H100_SMS):
    """Items, tile stores and shared memory of one plan."""
    seen = np.zeros(plan.n_items, np.int64)
    for b in range(plan.grid):
        items = np.asarray(vs.block_items(plan, b))
        assert (np.diff(items) == plan.grid).all()
        seen[items] += 1
    assert (seen == 1).all()
    tiles = {vs.item_tile(plan, i) for i in range(plan.n_items)}
    assert tiles == {(w, ty, tx) for w in range(plan.n_windows)
                     for ty in range(plan.n_ty) for tx in range(plan.n_tx)}
    assert vs.item_tile(plan, plan.n_tiles) == (1, 0, 0)    # window-major
    height, width = plan.n_ty * plan.tile_h, plan.n_tx * vs.TILE_W
    rows = np.zeros(plan.n_windows * plan.bins * height * width // vs.TILE_W,
                    np.int64)
    acc_rows = plan.bins * plan.tile_h
    for item in range(plan.n_items):
        stores = vs.box_rows(plan, item)
        assert len(stores) == acc_rows
        g = np.asarray([s[0] for s in stores])
        assert (g % vs.TILE_W == 0).all()          # 512-byte, 16-aligned rows
        rows[g // vs.TILE_W] += 1
        assert [s[1] for s in stores] == list(
            range(0, acc_rows * vs.TILE_W, vs.TILE_W))
    assert (rows == 1).all()
    assert plan.acc_bytes == plan.bins * plan.tile_h * vs.ROW_BYTES
    assert plan.smem == plan.bufs * plan.acc_bytes <= vs.MAX_SMEM
    per_block = (plan.smem + vs.static_smem(plan.threads, plan.mode)
                 + vs.BLOCK_RESERVED)
    assert 1 <= plan.blocks_per_sm and \
        plan.blocks_per_sm * per_block <= vs.SM_SMEM
    assert plan.blocks_per_sm * plan.threads <= vs.SM_THREADS
    assert plan.blocks_per_sm <= vs.REG_BLOCKS[plan.threads]
    assert plan.grid == min(plan.n_items, n_sm * plan.blocks_per_sm)


@pytest.mark.parametrize("n_windows", [1, 8, 40, 160])
def test_plan_at_the_dsec_shape(n_windows):
    plan = vs.scatter_plan(5, 480, 640, n_windows)
    assert (plan.tile_h, plan.n_ty, plan.n_tx) == (24, 20, 5)
    assert plan.n_items == 100 * n_windows
    assert plan.acc_bytes == 122_880            # 64-bit fixed-point cells
    # one accumulator a block, one block an SM (shared memory), so 512
    # threads: more threads on the SM than one 256-thread block
    assert (plan.bufs, plan.threads, plan.blocks_per_sm) == (1, 512, 1)
    check_plan(plan)


@pytest.mark.parametrize("threads", [256, 512])
def test_plan_threads(threads):
    """Both block sizes the kernels are built for, at 5 and 10 bins, each
    block with one accumulator: at 5 bins one block an SM (its 120 KB of
    shared memory), at 10 bins two 256-thread blocks or one 512-thread
    block (registers)."""
    for bins, n_sm in ((5, 132), (10, 7)):
        plan = vs.scatter_plan(bins, 480, 640, 8, n_sm, threads=threads)
        assert (plan.bufs, plan.threads) == (1, threads)
        assert plan.blocks_per_sm == (1 if bins == 5 else
                                      {256: 2, 512: 1}[threads])
        check_plan(plan, n_sm)


def test_plan_ten_bins_and_limits():
    plan = vs.scatter_plan(10, 480, 640, 8)
    assert (plan.tile_h, plan.n_ty) == (10, 48)
    assert plan.acc_bytes == 102_400
    check_plan(plan)
    # the accumulator is under 128 KB whenever bins * (tile_h + 1) <= 128
    for bins in range(1, 26):
        th = vs.tile_h_for_bins(bins)
        assert th == jvp.tile_h_for_bins(bins) == vf.tile_h_for_bins(bins)
        if bins * (th + 1) <= 128:
            assert bins * th * vs.ROW_BYTES < 128 * 1024
    with pytest.raises(ValueError):
        vs.scatter_plan(5, 470, 640, 1)            # not whole tiles
    with pytest.raises(ValueError):
        vs.scatter_plan(5, 480, 600, 1)
    with pytest.raises(ValueError):
        vs.scatter_plan(120, 8, 128, 1)            # 480 KB accumulator
    with pytest.raises(ValueError):
        vs.scatter_plan(5, 480, 640, 1, threads=128)


@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_at_the_cuda_test_shapes(shape):
    bins, h, w, n = shape
    check_plan(vs.scatter_plan(bins, h, w, n))


# --- plain emulation of the kernels' indexing ------------------------------

def deposit(acc, yl, xl, ts, p, th, dr, dq):
    """voxel_scatter.cuh::deposit on a (bins, th, 128) accumulator: the
    corners of the events at frame coordinates (yl, xl) whose row and
    column less (dr, dq) fall inside it, f32 weights formed in its order."""
    bins = acc.shape[0]
    yf, xf, cf = torch.floor(yl), torch.floor(xl), torch.floor(ts)
    fy, fx, wt = yl - yf, xl - xf, ts - cf
    r0, q0, c0 = yf.long() - dr, xf.long() - dq, cf.long()
    flat = acc.view(-1)
    for dc, s in ((0, p * (1.0 - wt)), (1, p * wt)):
        c = c0 + dc
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            r = r0 + dy
            swy = s * wy
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                q = q0 + dx
                v = swy * wx
                ok = ((c >= 0) & (c < bins) & (r >= 0) & (r < th) & (q >= 0)
                      & (q < vs.TILE_W) & (v != 0))
                idx = (c * th + r) * vs.TILE_W + q
                flat.index_add_(0, idx[ok], v[ok])


def emulate(plan, x, y, ts, pol, offsets, *, tiled, early_reject=True):
    """The kernel's work, block by block and item by item: the grid (every
    element counted as it is stored) and, B1 and B3-legacy, the per-item
    partials. A plan in mode ``'band'`` walks each item's band (B3-legacy's
    band rule, all the band's records in one pass)."""
    th, n = plan.tile_h, x.shape[1]
    grid = torch.full((plan.n_windows * plan.bins * plan.n_ty * th
                       * plan.n_tx * vs.TILE_W,), float("nan"))
    stored = torch.zeros(grid.shape, dtype=torch.int64)
    partials = torch.zeros(plan.n_items, 3)

    def rng_of(w, tile):
        start = min(max(int(offsets[w, tile]), 0), n)
        return start, min(max(int(offsets[w, tile + 1]), start), n)

    for block in range(plan.grid):
        for item in vs.block_items(plan, block):
            w, ty, tx = vs.item_tile(plan, item)
            tile = ty * plan.n_tx + tx
            acc = torch.zeros(plan.bins, th, vs.TILE_W)
            row0, col0 = float(ty * th), float(tx * vs.TILE_W)
            s, e = rng_of(w, vs.item_group(plan, item))
            if plan.mode == "band":
                keep = pol[w, s:e] != 0
                if early_reject:
                    keep &= vs.band_keeps(x[w, s:e], tx)
                deposit(acc, (y[w, s:e] - row0)[keep],
                        (x[w, s:e] - col0)[keep], ts[w, s:e][keep],
                        pol[w, s:e][keep], th, 0, 0)
            # the records loaded ahead, then the rest: one range either way
            for lo, hi in (() if plan.mode == "band" else
                           ((s, min(e, s + KAHEAD)),
                            (min(e, s + KAHEAD), e))):
                sl = slice(lo, hi)
                live = pol[w, sl] != 0
                deposit(acc, (y[w, sl] - row0)[live],
                        (x[w, sl] - col0)[live], ts[w, sl][live],
                        pol[w, sl][live], th, 0, 0)
            if tiled:
                for up, left in ((True, False), (False, True), (True, True)):
                    if (up and ty == 0) or (left and tx == 0):
                        continue
                    s, e = rng_of(w, tile - up * plan.n_tx - left)
                    yl = y[w, s:e] - (row0 - th * up)
                    xl = x[w, s:e] - (col0 - vs.TILE_W * left)
                    keep = pol[w, s:e] != 0
                    if early_reject and up:
                        keep &= torch.floor(yl) == th - 1
                    if early_reject and left:
                        keep &= torch.floor(xl) == vs.TILE_W - 1
                    deposit(acc, yl[keep], xl[keep], ts[w, s:e][keep],
                            pol[w, s:e][keep], th, th * up,
                            vs.TILE_W * left)
            flat = acc.view(-1)
            for g_off, s_off in vs.box_rows(plan, item):
                grid[g_off:g_off + vs.TILE_W] = flat[s_off:s_off + vs.TILE_W]
                stored[g_off:g_off + vs.TILE_W] += 1
            partials[item] = torch.stack([flat.sum(), (flat * flat).sum(),
                                          (flat != 0).sum().float()])
    assert (stored == 1).all()
    shape = (plan.n_windows, plan.bins, plan.n_ty * th, plan.n_tx * vs.TILE_W)
    return grid.view(shape), partials.view(plan.n_windows, plan.n_tiles, 3)


CASES = {
    "48x256-b5": dict(h=48, w=256, bins=5),
    "26x170-b5": dict(h=26, w=170, bins=5),
    "48x384-b10": dict(h=48, w=384, bins=10),
    "16x16-b5": dict(h=16, w=16, bins=5),
}


def tiled_case(case, seed, *, b=3, n=900, empty_neighbours=False,
               empty_window=False, **kw):
    """Tile-sorted kernel inputs (x, y, ts, pol, offsets) on the padded grid
    and the keyword arguments of the voxelizers."""
    c = CASES[case]
    x, y, ts, pol, ok, hp, wp = kernel_inputs(
        np.random.default_rng(seed), c["h"], c["w"], c["bins"], b=b, n=n,
        **kw)
    if empty_neighbours:
        # window 0: events of tile row 1, tile column 1 only (its upper,
        # left and upper-left neighbours empty), some on its last row and
        # column, so they also reach the tiles below and to the right where
        # the grid has them
        th = vt.tile_h_for_bins(c["bins"])
        rng = np.random.default_rng(seed + 1)
        x[0] = rng.uniform(128.0, 256.0 - 1e-3, n).astype(np.float32)
        y[0] = rng.uniform(th, 2 * th - 1e-3, n).astype(np.float32)
        x[0, :n // 4] = 255.0 + rng.uniform(0, 1, n // 4)
        y[0, n // 4:n // 2] = 2 * th - 1 + rng.uniform(0, 1, n // 4)
        pol[0] = np.where(ok[0], pol[0], 0)
    if empty_window:
        ok[-1] = False
        pol[-1] = 0
    kwv = dict(bins=c["bins"], height=hp, width=wp)
    sorted_ = vt.bin_events_device(
        *map(torch.from_numpy, (x, y, ts, pol, ok)), **kwv)
    return [a.contiguous() for a in sorted_], kwv


def test_emulation_cases_cover_the_edges():
    """The inputs below hold what the gather rule must get right."""
    (x, y, ts, pol, offs), kw = tiled_case("48x256-b5", 1,
                                           empty_neighbours=True,
                                           empty_window=True)
    live = pol != 0
    assert ((x > -1) & (x < 0) & live).any()                 # left border
    assert ((y > -1) & (y < 0) & live).any()                 # top border
    assert ((torch.floor(x) % 128 == 127) & live).any()      # column edges
    assert ((torch.floor(y) % 24 == 23) & live).any()        # row edges
    assert ((x > 255) & live).any() and ((y > 47) & live).any()
    assert (ts[live] == kw["bins"] - 1).any()                # last bin
    assert int(offs[-1, -1]) == 0                            # empty window
    o = offs[0]
    assert o[1] - o[0] == 0 and o[2] - o[1] == 0 and o[3] - o[2] == 0
    assert o[4] - o[3] > 0                                   # (1, 1) alone


GATHER_CASES = [(c, v) for c in sorted(CASES)
                for v in ("plain", "empty_neighbours", "empty_tile",
                          "int_coords")
                if v != "empty_neighbours" or CASES[c]["w"] >= 256]


@pytest.mark.parametrize("case,variant", GATHER_CASES)
def test_tiled_gather_matches_the_plain_version(case, variant):
    """B3's gather rule, emulated in the plan's order, against
    ``voxelize_tiled_ref`` (atol 1e-6 / rtol 1e-5: same f32 weights, other
    order) and bit for bit against the same emulation without the early
    reject."""
    opts = {"plain": {}, "empty_neighbours": dict(empty_neighbours=True),
            "empty_tile": dict(empty_tile=True, empty_window=True),
            "int_coords": dict(int_coords=True)}[variant]
    args, kw = tiled_case(case, 2, **opts)
    plan = vs.scatter_plan(kw["bins"], kw["height"], kw["width"],
                           args[0].shape[0], 3)
    got, _ = emulate(plan, *args, tiled=True)
    want = vt.voxelize_tiled_ref(*args, **kw)
    torch.testing.assert_close(got, want, **ORDER)
    full, _ = emulate(plan, *args, tiled=True, early_reject=False)
    assert torch.equal(got, full)


@pytest.mark.parametrize("case", ["48x256-b5", "48x384-b10"])
def test_tiled_gather_matches_jax_kernel(case):
    """The emulation against the JAX Pallas kernel in interpret mode with
    f32 tent planes (F32: atol 2e-3 / rtol 1e-4)."""
    args, kw = tiled_case(case, 3, empty_neighbours=True, empty_window=True)
    plan = vs.scatter_plan(kw["bins"], kw["height"], kw["width"],
                           args[0].shape[0])
    got, _ = emulate(plan, *args, tiled=True)
    want = jvp.voxelize_tiled(*[jnp.asarray(a.numpy()) for a in args],
                              interpret=True, oh_dtype=jnp.float32, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_gather_takes_no_corner_from_a_far_tile():
    """Single events, one per case: a neighbour's event deposits into the
    item's tile only from the neighbour's last row or column, and each
    corner lands in exactly one tile (the emulated grid equals the plain
    version for each event alone)."""
    th, kw = 24, dict(bins=5, height=48, width=256)
    for xv, yv in ((127.5, 3.0), (127.0, 23.5), (127.5, 23.5), (126.5, 22.5),
                   (-0.5, 23.5), (127.5, -0.5), (255.5, 47.5), (0.0, 0.0)):
        x, y = torch.tensor([[xv]]), torch.tensor([[yv]])
        ts, pol = torch.tensor([[2.25]]), torch.tensor([[1.0]])
        tile = vt.tile_id(x, y, 256, th)
        offs = torch.zeros(1, 5, dtype=torch.int32)
        offs[0, int(tile) + 1:] = 1
        plan = vs.scatter_plan(5, 48, 256, 1)
        got, _ = emulate(plan, x, y, ts, pol, offs, tiled=True)
        want = vt.voxelize_tiled_ref(x, y, ts, pol, offs, **kw)
        torch.testing.assert_close(got, want, **ORDER)


@pytest.mark.parametrize("h,w", [(48, 256), (26, 170), (120, 128)])
def test_folded_items_match_the_plain_version(h, w):
    """B1 on the core: each (window, group) item walks its own range; the
    emulated grid and the partials summed per window in group order against
    ``voxelize_folded_ref`` (grid atol 1e-6 / rtol 1e-5; stats atol 1e-4 /
    rtol 1e-5: sums of the grid in another order)."""
    rng = np.random.default_rng(h + w)
    raw = np.zeros((3, 3000, 4), np.float32)
    raw[..., 0] = rng.uniform(-0.9, w - 0.1, (3, 3000))
    raw[..., 1] = rng.uniform(-0.9, h - 0.1, (3, 3000))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (3, 3000)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (3, 3000))
    valid = np.ones((3, 3000), bool)
    valid[:, -300:] = False
    valid[-1] = False                                        # empty window
    r, v, o = vf.host_band_bin_folded(raw, valid, height=h, width=w, bins=5)
    x, y, t, p = (torch.from_numpy(np.ascontiguousarray(r[..., i]))
                  for i in range(4))
    vd = torch.from_numpy(v)
    from ess_tpu_torch.ops.voxel import masked_time_norm

    ts = masked_time_norm(t, vd, 5).contiguous()
    pol = torch.where(vd, p, torch.zeros_like(p)).contiguous()
    offs = torch.from_numpy(o)
    hp, wp = -(-h // 24) * 24, -(-w // 128) * 128
    plan = vs.scatter_plan(5, hp, wp, 3)
    got, partials = emulate(plan, x, y, ts, pol, offs, tiled=False)
    want, stats = vf.voxelize_folded_ref(x, y, ts, pol, offs, bins=5,
                                         height=hp, width=wp)
    torch.testing.assert_close(got, want, **ORDER)
    torch.testing.assert_close(partials.sum(dim=1), stats, atol=1e-4,
                               rtol=1e-5)
    assert stats[-1].abs().sum() == 0


# --- B3-legacy: the plan's band mode ---------------------------------------

BAND_SHAPES = [(5, 480, 640, n) for n in (1, 2, 8, 160)] + [
    (5, 48, 256, 3), (5, 72, 384, 2), (5, 24, 128, 8), (10, 480, 640, 2)]


@pytest.mark.parametrize("shape", BAND_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_band_plan(shape):
    """Mode 'band': one item a (window, band, 128-column tile), a band's
    tiles consecutive, each walking its band's records (offsets with
    n_bands + 1 columns); the boxes store every grid element once."""
    bins, h, w, n = shape
    plan = vs.scatter_plan(bins, h, w, n, mode="band")
    tile = vs.scatter_plan(bins, h, w, n)
    assert plan.mode == "band" and tile.mode == "tile"
    assert (plan.n_groups, tile.n_groups) == (plan.n_ty, plan.n_tiles)
    assert plan.n_items == n * (h // plan.tile_h) * (w // vs.TILE_W)
    assert (plan.threads, plan.grid, plan.smem) == (tile.threads, tile.grid,
                                                    tile.smem)
    for item in range(0, plan.n_items, max(1, plan.n_items // 997)):
        wi, ty, tx = vs.item_tile(plan, item)
        assert vs.item_group(plan, item) == ty
        assert vs.item_group(tile, item) == ty * plan.n_tx + tx
        assert item == (wi * plan.n_ty + ty) * plan.n_tx + tx
    check_plan(plan)
    with pytest.raises(ValueError):
        vs.scatter_plan(bins, h, w, n, mode="slab")


def launcher_refuses(kind, *, bins, tile_h, height, width, n_tx, n_tiles,
                     n_items, n_groups, threads, grid, smem):
    """``voxel_scatter.cuh::launch``'s layout check, transcribed: True
    where the launcher returns cudaErrorInvalidValue before launching."""
    return (tile_h != vs.tile_h_for_bins(bins) or width % vs.TILE_W != 0
            or n_tx * vs.TILE_W != width or height % tile_h != 0
            or (height // tile_h) * n_tx != n_tiles or bins > 256
            or n_groups != (height // tile_h if kind == "band" else n_tiles)
            or threads not in (256, 512)
            or smem != bins * tile_h * vs.ROW_BYTES or smem > vs.MAX_SMEM
            or grid < 1 or grid > n_items)


@pytest.mark.parametrize("shape", BAND_SHAPES + CUDA_SHAPES[6:],
                         ids=lambda s: "x".join(map(str, s)))
def test_launcher_layout_check(shape):
    """The launchers accept what the plan computes, in each mode with the
    arguments its entry point passes (``ess_voxel_folded_band`` derives
    n_tx, n_tiles and n_items from the width and the bands), and refuse a
    plan that disagrees: the other mode's offsets, another accumulator, a
    grid with more blocks than items, a block size they are not built
    for."""
    bins, h, w, n = shape
    for mode in vs.MODES:
        plan = vs.scatter_plan(bins, h, w, n, mode=mode)
        args = dict(bins=bins, tile_h=plan.tile_h, height=h, width=w,
                    n_tx=w // vs.TILE_W, n_tiles=plan.n_tiles,
                    n_items=plan.n_items, n_groups=plan.n_groups,
                    threads=plan.threads, grid=plan.grid, smem=plan.smem)
        assert not launcher_refuses(mode, **args)
        other = plan.n_tiles if mode == "band" else plan.n_ty
        bad = [dict(smem=plan.smem + vs.ROW_BYTES),
               dict(grid=plan.n_items + 1), dict(grid=0),
               dict(threads=128), dict(tile_h=plan.tile_h + 2)]
        if other != plan.n_groups:
            bad.append(dict(n_groups=other))
        for change in bad:
            assert launcher_refuses(mode, **{**args, **change}), change


def band_records(raw, valid, h, w):
    """Legacy-wire records (x, y, ts, pol, offsets) of raw windows, as the
    route feeds the kernel: ``host_band_bin_folded(x_slots=False)``, the
    time normalized over the valid records, padded height."""
    r, v, o = vf.host_band_bin_folded(raw, valid, height=h, width=w, bins=5,
                                      x_slots=False)
    x, y, t, p = (torch.from_numpy(np.ascontiguousarray(r[..., i]))
                  for i in range(4))
    vd = torch.from_numpy(v)
    from ess_tpu_torch.ops.voxel import masked_time_norm

    ts = masked_time_norm(t, vd, 5).contiguous()
    pol = torch.where(vd, p, torch.zeros_like(p)).contiguous()
    return x, y, ts, pol, torch.from_numpy(o)


def band_raw(case, rng):
    """(raw windows, valid, h, w) of one band-rule case."""
    h, w, b, n = {"dsec": (480, 640, 2, 6000)}.get(case, (72, 384, 3, 3000))
    raw = np.zeros((b, n, 4), np.float32)
    raw[..., 0] = rng.uniform(-0.9, w - 0.1, (b, n))
    raw[..., 1] = rng.uniform(-0.9, h - 0.1, (b, n))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (b, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, -n // 10:] = False
    k = n // 8
    if case == "edges":
        # x = 127.0 and 255.0 exactly (their x + 1 corner carries no
        # weight), just below a 128-column boundary (that corner crosses
        # into the next tile), on the last column and just past it
        raw[:, :k, 0] = rng.choice([127.0, 255.0], (b, k))
        raw[:, k:2 * k, 0] = rng.choice([128.0, 256.0, 384.0], (b, k)) \
            - rng.choice([2.0 ** -16, 2.0 ** -8, 0.25], (b, k))
        raw[:, 2 * k:3 * k, 0] = w - 1 + rng.uniform(0, 0.9, (b, k))
        raw[:, 3 * k:4 * k, 0] = np.floor(raw[:, 3 * k:4 * k, 0])
    elif case == "empty_bands":
        # window 0: bands 0 and 2 only; the last window empty
        raw[0, :, 1] = np.where(rng.integers(0, 2, n) == 0,
                                rng.uniform(0, 22.9, n),
                                rng.uniform(48, 71.9, n))
        valid[-1] = False
    elif case == "one_band":
        # 90 % of every window in band 1, some on its edge rows
        m = n * 9 // 10
        raw[:, :m, 1] = rng.uniform(24.0, 47.99, (b, m))
        raw[:, :k, 1] = rng.choice([23.5, 47.5], (b, k))
    return raw, valid, h, w


@pytest.mark.parametrize("case", ["plain", "edges", "empty_bands",
                                  "one_band", "dsec"])
def test_band_rule_matches_the_plain_version(case):
    """B3-legacy's band rule, emulated in the plan's order: bit for bit
    against ``voxelize_folded_ref`` on the legacy wire and against itself
    without the reject; its partials summed per window against the stats
    (atol 1e-4 / rtol 1e-5, sums of the grid in another order)."""
    raw, valid, h, w = band_raw(case, np.random.default_rng(11))
    x, y, ts, pol, offs = band_records(raw, valid, h, w)
    hp = -(-h // 24) * 24
    assert offs.shape[1] == hp // 24 + 1
    kw = dict(bins=5, height=hp, width=w)
    plan = vs.scatter_plan(5, hp, w, x.shape[0], 3, mode="band")
    got, partials = emulate(plan, x, y, ts, pol, offs, tiled=False)
    want, stats = vf.voxelize_folded_ref(x, y, ts, pol, offs, **kw)
    assert torch.equal(got, want)
    full, _ = emulate(plan, x, y, ts, pol, offs, tiled=False,
                      early_reject=False)
    assert torch.equal(got, full)
    torch.testing.assert_close(partials.sum(dim=1), stats, atol=1e-4,
                               rtol=1e-5)
    live = pol != 0
    if case == "edges":
        assert ((x == 127.0) & live).any() and ((x == w - 1) & live).any()
        fx = x - torch.floor(x)
        assert ((torch.floor(x) % 128 == 127) & (fx > 0) & live).any()
    if case == "empty_bands":
        n_live = torch.diff(offs.long(), dim=1)
        assert (n_live[0, 1] == 0) and (n_live[0, 0] > 0)
        assert int(offs[-1, -1]) == 0 and stats[-1].abs().sum() == 0
    if case == "one_band":
        n_live = torch.diff(offs.long(), dim=1)
        assert (n_live[:, 1] > 0.8 * n_live.sum(dim=1)).all()


def test_band_rule_single_records():
    """One record at a time on the legacy wire: a record at x = 127.0,
    just below 128, at 128.0, on the last column or at x = 0 deposits each
    corner in exactly one tile (the emulation equals the plain version)."""
    h, w = 48, 256
    plan = vs.scatter_plan(5, h, w, 1, mode="band")
    for xv in (127.0, 128.0 - 2.0 ** -16, 127.5, 128.0, 255.0, 254.75, 0.0):
        for yv in (3.25, 23.0, 24.5):
            x, y = torch.tensor([[xv]]), torch.tensor([[yv]])
            ts, pol = torch.tensor([[2.25]]), torch.tensor([[1.0]])
            offs = torch.zeros(1, 3, dtype=torch.int32)
            offs[0, int(yv // 24) + 1:] = 1
            got, _ = emulate(plan, x, y, ts, pol, offs, tiled=False)
            want, _ = vf.voxelize_folded_ref(x, y, ts, pol, offs, bins=5,
                                             height=h, width=w)
            assert torch.equal(got, want), (xv, yv)
            assert float(got.sum()) == pytest.approx(1.0)
