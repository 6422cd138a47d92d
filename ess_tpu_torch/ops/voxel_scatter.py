"""Work plan of the persistent scatter core (``csrc/voxel_scatter.cuh``).

The fold-free voxelizer (B1, :mod:`ess_tpu_torch.ops.voxel_folded`), its
full-width band wire (B3-legacy, the same module) and the halo-tiled
voxelizer (B3, :mod:`ess_tpu_torch.ops.voxel_tiled`) run on one CUDA core.
A work item is one (window, tile) of the grid, a tile being ``tile_h`` rows
by 128 columns (a B1 group: one band by one x-slot). Items are numbered
window-major, ``item = window * n_tiles + ty * n_tx + tx``, and the
persistent blocks walk them grid-strided: block ``b`` takes items ``b, b +
grid, b + 2 * grid, ...``, so the items in flight at any moment are a
contiguous run of one or two windows, whose events stay in L2.

The plan's ``mode`` says which records an item reads (:func:`item_group`):
``'tile'`` (B1 and B3) the group of its own tile, the offsets having
``n_tiles + 1`` columns; ``'band'`` (B3-legacy) its whole band, the offsets
having ``n_ty + 1`` columns: the band's tiles are consecutive items, each
walks the band's range and keeps the records whose ``floor(x)`` lies in
``[128 tx - 1, 128 tx + 127]`` (:func:`band_keeps`).

Per item a block scatters the item's records into a dense ``bins x tile_h
x 128`` accumulator of 64-bit fixed-point cells in shared memory (row
pitch 128 cells, 1 KB): each corner value is rounded to a multiple of
``2^-FRAC_BITS`` (:func:`to_fixed`) and added by an integer atomic, so a
cell's sum does not depend on the order in which the threads' corners
arrive, and two launches give the same bits. Then one pass converts the
tile to f32, stores its rows to the grid (:func:`box_rows` lists them) and
zeroes it. A block holds one accumulator (:data:`BUFS`); at 5 bins (120
KB) one block fits an SM. Every grid element is stored by exactly one
item, empty tiles as zeros, so the grid needs no zero fill.

The plan is computed here, where the CPU tests reach it, and passed to the
kernels as arguments; the CUDA launchers recompute the layout and refuse a
plan that disagrees: change both sides together.

The voxelizer pins select forms of the same core with the same plan:
the drain's :data:`LAYOUTS` (:func:`relayout` is their plain version on an
NCHW grid) and the int8 tent planes (``oh_dtype='int8'``, :func:`corners`
with ``q8``: the TPU kernel's quantized corner weights, integer products
summed exactly, :func:`cells_to_f32`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

TILE_W = 128                 # tile columns = accumulator row pitch, cells
CELL_BYTES = 8               # a 64-bit fixed-point cell
ROW_BYTES = TILE_W * CELL_BYTES   # one 128-cell accumulator row, bytes
FRAC_BITS = 32               # fraction bits of a cell (kFracBits)
MAX_SMEM = 232_448           # dynamic shared memory a block may use (H100)
SM_SMEM = 233_472            # shared memory of one SM
BLOCK_RESERVED = 1_024       # the runtime's share per resident block
SM_THREADS = 2_048           # resident threads per SM
H100_SMS = 132
THREADS = (256, 512)         # block sizes the kernels are built for
# Resident blocks an SM that the kernels' registers allow at least
# (``__launch_bounds__`` of voxel_scatter.cuh::scatter_kernel).
REG_BLOCKS = {256: 2, 512: 1}
# Accumulators per block: one (one block an SM at 5 bins).
BUFS = 1
# 512 threads a block where there is at most one item for each resident
# 256-thread block (B3 at streaming B=1: 100 items), or where 512-thread
# blocks keep more threads on an SM (5 bins: one block an SM either way),
# else 256.
FEW_ITEMS_PER_SLOT = 1
MODES = ("tile", "band")
# Where the drain stores a tile (voxel_scatter.cuh Layout, in this order):
# the NCHW grid, the TPU kernel's raw band accumulator, the space-to-depth
# NCHW stack.
LAYOUTS = ("nchw", "raw", "stack")
# every layout a voxelizer hands out: the drain's and JAX's views of a grid
GRID_LAYOUTS = ("nchw", "nhwc", "s2d", "raw", "stack")
COL_SLOT = TILE_W + 8        # B3's TPU column slot (voxel_pallas.COL_SLOT)
Q_SCALE = 127.0              # the int8 planes' scale (INT8_SCALE)
FROM_Q = float(np.float32(1.0) / np.float32(Q_SCALE * Q_SCALE))
# tent-plane operand types of PipelineConfig.voxel_oh_dtype: 'bfloat16' and
# 'float32' run the f32 core, 'int8' the int8 planes
OH_DTYPES = ("bfloat16", "float32", "int8")


def tile_h_for_bins(bins: int) -> int:
    """Tile (band) height: the largest even ``th`` with ``bins * (th + 1)
    <= 128``, clamped to [4, 64]. The host binnings and the device kernels
    must agree on it (24 for 5 bins, 10 for 10)."""
    th = 128 // bins - 1
    th -= th % 2
    return max(4, min(th, 64))


QUEUE = 64                   # B3-legacy: a warp's queue of kept records


def static_smem(threads: int, mode: str = "tile") -> int:
    """Static shared memory of a block: the stats reduction, (sum, sum of
    squares, nonzero count) per warp, and in mode ``'band'`` each warp's
    queue of :data:`QUEUE` 16-byte records."""
    return (threads // 32) * (3 * 4 + (QUEUE * 16 if mode == "band" else 0))


@dataclass(frozen=True)
class ScatterPlan:
    bins: int
    tile_h: int           # tile rows (tile_h_for_bins)
    n_ty: int             # tile rows of the grid
    n_tx: int             # tile columns of the grid (width // 128)
    n_tiles: int          # n_ty * n_tx: items per window
    n_windows: int
    n_items: int          # n_windows * n_tiles, window-major
    acc_bytes: int        # one accumulator: bins * tile_h * ROW_BYTES
    bufs: int             # accumulators per block (BUFS)
    threads: int          # threads per block
    smem: int             # dynamic shared memory per block: bufs * acc_bytes
    blocks_per_sm: int    # resident blocks an SM: shared memory, threads,
                          # registers (REG_BLOCKS)
    grid: int             # persistent blocks: min(n_items, SMs x blocks/SM)
    mode: str = "tile"    # records an item reads: its tile's or its band's
    n_groups: int = 0     # record groups a window (offsets: n_groups + 1)
    order: str = "window-major"


@functools.lru_cache(maxsize=256)
def scatter_plan(bins: int, height: int, width: int, n_windows: int,
                 n_sm: int = H100_SMS, *, threads: int = 0,
                 mode: str = "tile") -> ScatterPlan:
    """The plan of B1 (``ess_voxel_folded``) or B3 (``ess_voxel_tiled``),
    ``mode='tile'``, or of B3-legacy (``ess_voxel_folded_band``),
    ``mode='band'``, for ``n_windows`` grids of ``(bins, height, width)``;
    ``height`` a multiple of ``tile_h_for_bins(bins)``, ``width`` of 128.
    ``threads`` 0 takes 512 where there are at most
    :data:`FEW_ITEMS_PER_SLOT` items for each resident 256-thread block,
    else 256."""
    if mode not in MODES:
        raise ValueError(f"scatter_plan: mode {mode!r} not in {MODES}")
    th = tile_h_for_bins(bins)
    if height % th or width % TILE_W or height <= 0 or width <= 0:
        raise ValueError(f"scatter_plan: grid {height}x{width} is not a "
                         f"multiple of the {th}x{TILE_W} tile")
    acc = bins * th * ROW_BYTES
    if acc > MAX_SMEM or bins > 256:
        raise ValueError(f"scatter_plan: a {bins} x {th} x {TILE_W} "
                         f"accumulator ({acc} B) exceeds a block's shared "
                         "memory")
    n_ty, n_tx = height // th, width // TILE_W
    n_tiles = n_ty * n_tx
    n_items = n_windows * n_tiles
    smem = BUFS * acc

    def blocks_per_sm(t: int) -> int:
        per_block = smem + static_smem(t, mode) + BLOCK_RESERVED
        return max(1, min(SM_SMEM // per_block, SM_THREADS // t,
                          REG_BLOCKS[t]))

    if not threads:
        few = n_items <= FEW_ITEMS_PER_SLOT * n_sm * blocks_per_sm(256)
        more = 512 * blocks_per_sm(512) > 256 * blocks_per_sm(256)
        threads = 512 if few or more else 256
    if threads not in THREADS:
        raise ValueError(f"scatter_plan: threads={threads} not in {THREADS}")
    bpsm = blocks_per_sm(threads)
    grid = max(1, min(n_items, n_sm * bpsm))
    return ScatterPlan(bins, th, n_ty, n_tx, n_tiles, n_windows, n_items,
                       acc, BUFS, threads, smem, bpsm, grid, mode,
                       n_ty if mode == "band" else n_tiles)


def block_items(plan: ScatterPlan, block: int) -> range:
    """The work items block ``block`` walks, in order."""
    return range(block, plan.n_items, plan.grid)


def item_tile(plan: ScatterPlan, item: int) -> Tuple[int, int, int]:
    """(window, tile row, tile column) of work item ``item``."""
    w, tile = divmod(item, plan.n_tiles)
    ty, tx = divmod(tile, plan.n_tx)
    return w, ty, tx


def item_group(plan: ScatterPlan, item: int) -> int:
    """The record group (offsets column) item ``item`` walks: its tile, or
    its band in mode ``'band'``."""
    _, ty, tx = item_tile(plan, item)
    return ty if plan.mode == "band" else ty * plan.n_tx + tx


def band_keeps(x, tx: int):
    """Mode ``'band'``: whether records at global columns ``x`` reach tile
    column ``tx``: ``floor(x)`` in ``[128 tx - 1, 128 tx + 127]``, tested
    as the kernel does on ``x - 128 tx`` (exact)."""
    xl = x - float(tx * TILE_W)
    return (xl >= -1.0) & (xl < float(TILE_W))


def box_rows(plan: ScatterPlan, item: int) -> List[Tuple[int, int]]:
    """The rows the drain of item ``item`` stores: (element offset in the
    (n_windows, bins, height, width) f32 grid, cell offset in the
    accumulator) of each 128-cell row of its tile, in the accumulator's
    order (bin-major, then row)."""
    w, ty, tx = item_tile(plan, item)
    th, height, width = plan.tile_h, plan.n_ty * plan.tile_h, \
        plan.n_tx * TILE_W
    out = []
    for row in range(plan.bins * th):
        c, r = divmod(row, th)
        out.append((((w * plan.bins + c) * height + ty * th + r) * width
                    + tx * TILE_W, row * TILE_W))
    return out


def to_fixed(v: torch.Tensor) -> torch.Tensor:
    """``voxel_scatter.cuh::to_fixed`` on f32 corner values: int64 units of
    ``2^-FRAC_BITS``, the nearest (ties to even, as ``__float2ll_rn``), or
    one unit of v's sign where that is 0 and v is not."""
    q = torch.round(v.double() * 2.0 ** FRAC_BITS).long()    # exact scaling
    return torch.where((q == 0) & (v != 0), torch.sign(v).long(), q)


def fixed_point_bound(n_corners: int) -> int:
    """The largest |sum| in units that ``n_corners`` corners of |v| <= 1
    (one a record, at most) put in one cell: each rounds to at most
    ``2^FRAC_BITS`` units. A cell cannot overflow while this is below
    ``2^63``: for any record count below ``2^31``."""
    return n_corners << FRAC_BITS


def quantized(oh_dtype) -> bool:
    """Whether ``oh_dtype`` (one of :data:`OH_DTYPES`, a torch dtype of
    them, or None: the default) selects the int8 tent planes. Another
    value raises."""
    if oh_dtype is None:
        return False
    name = (str(oh_dtype).removeprefix("torch.")
            if isinstance(oh_dtype, torch.dtype) else oh_dtype)
    if name not in OH_DTYPES:
        raise ValueError(f"oh_dtype {oh_dtype!r} not in {OH_DTYPES}")
    return name == "int8"


def corners(yl: torch.Tensor, xl: torch.Tensor, ts: torch.Tensor,
            p: torch.Tensor, *, q8: bool = False, gap: int = 0, cb=None):
    """The 8 trilinear corners of events at (yl, xl) of their tile's frame,
    time ``ts`` and value ``p``: a list of (bin, row, column, value), rows
    and columns in the same frame. f32 values (the plain versions' corner
    products), or with ``q8`` the integer products of
    ``voxel_scatter.cuh::deposit_q8``: the TPU kernel's int8 row and column
    weights, each the same f32 expression (row gap ``gap``, global column
    base ``cb``), rounded half to even."""
    if not q8:
        yi, xi, c0 = torch.floor(yl), torch.floor(xl), torch.floor(ts)
        fy, fx, wt = yl - yi, xl - xi, ts - c0
        out = []
        for dc, s in ((0, p * (1.0 - wt)), (1, p * wt)):
            for dy, wy in ((0, 1.0 - fy), (1, fy)):
                for dx, wx in ((0, 1.0 - fx), (1, fx)):
                    out.append((c0.long() + dc, yi.long() + dy,
                                xi.long() + dx, s * wy * wx))
        return out
    cf = torch.floor(ts)
    wt = ts - cf
    s0, s1 = p * (1.0 - wt), p * wt
    fold = torch.where(yl < 0, 1.0 + yl, torch.ones_like(yl))
    s0, s1 = s0 * fold, s1 * fold
    yl = torch.clamp(yl, min=0.0)
    sq = (s0 * Q_SCALE, s1 * Q_SCALE)
    g = float(gap)
    cg = cf * g                                  # exact
    p0 = cg + yl
    ylq = p0 - cg                                # exact
    yf, xf = torch.floor(ylq), torch.floor(xl)
    cx = (cb + xl) * Q_SCALE
    qx, qy = [], [[], []]
    for d in (0, 1):
        col = (cb + (xf + d)) * Q_SCALE          # an exact integer
        qx.append(torch.round(torch.clamp(
            Q_SCALE - (col - cx).abs(), min=0.0)).long())
        w0 = torch.clamp(1.0 - ((yf + d) - ylq).abs(), min=0.0)
        w1 = w0
        if gap % 8:                              # the tall row plane
            row = (cf + 1.0) * g + (yf + d)
            w1 = torch.clamp(1.0 - ((row - p0) - g).abs(), min=0.0)
        qy[0].append(torch.round(w0 * sq[0]).long())
        qy[1].append(torch.round(w1 * sq[1]).long())
    c0, r0, q0 = cf.long(), yf.long(), xf.long()
    return [(c0 + dc, r0 + dy, q0 + dx, qy[dc][dy] * qx[dx])
            for dc in (0, 1) for dy in (0, 1) for dx in (0, 1)]


def cells_to_f32(flat: torch.Tensor) -> torch.Tensor:
    """Summed cells -> f32: int8 products (int64) scaled as the drain does,
    fl(fl(sum) * fl(1 / 127^2)); f32 sums as they are."""
    if flat.dtype != torch.int64:
        return flat
    return flat.to(torch.float32) * torch.tensor(FROM_Q, dtype=torch.float32,
                                                 device=flat.device)


def check_layout(layout: str, allowed=GRID_LAYOUTS) -> None:
    """Raise unless ``layout`` is one of ``allowed``; ``'s4d'`` (4x4 quad
    blocks) where it is not with its own reason: it is a relayout of the
    cropped grid, which ``ops/batch_voxel.py`` makes after the voxelizer
    (:func:`to_s4d`), as the JAX package makes it outside its Pallas
    bodies."""
    if layout == "s4d" and layout not in allowed:
        raise ValueError("layout 's4d' (4x4 quad blocks) is made from the "
                         "cropped grid after the voxelizer (ops/batch_voxel."
                         "py), not by a voxelizer kernel")
    if layout not in allowed:
        raise ValueError(f"layout {layout!r} not in {allowed}")


def to_s4d(grid: torch.Tensor) -> torch.Tensor:
    """An NCHW grid (B, C, H, W) -> its 4x4 blocks (B, H / 4, W / 4, 16C),
    channel (py * 4 + px) * C + c (a copy): the quad-block rollout's
    windows."""
    b, c, h, w = grid.shape
    if h % 4 or w % 4:
        raise ValueError(f"layout 's4d' needs H and W divisible by 4, got "
                         f"{(h, w)}")
    return grid.reshape(b, c, h // 4, 4, w // 4, 4).permute(
        0, 2, 4, 3, 5, 1).reshape(b, h // 4, w // 4, 16 * c)


def relayout(grid: torch.Tensor, layout: str,
             tile_h: int = 0) -> torch.Tensor:
    """An NCHW grid (B, C, H, W) in one of :data:`GRID_LAYOUTS`: itself,
    ``'nhwc'`` (B, H, W, C) (a view), the raw band accumulator (B, H /
    tile_h, C * tile_h, W), the space-to-depth stack ``'stack'`` (B, 4C,
    H / 2, W / 2), channel (py * 2 + px) * C + c, or its blocks ``'s2d'``
    (B, H / 2, W / 2, 4C) (a copy, viewed)."""
    check_layout(layout)
    b, c, h, w = grid.shape
    if layout == "nchw":
        return grid
    if layout == "nhwc":
        return grid.permute(0, 2, 3, 1)
    if layout == "raw":
        return grid.view(b, c, h // tile_h, tile_h, w).permute(
            0, 2, 1, 3, 4).reshape(b, h // tile_h, c * tile_h, w)
    stack = grid.view(b, c, h // 2, 2, w // 2, 2).permute(
        0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)
    return stack if layout == "stack" else stack.permute(0, 2, 3, 1)
