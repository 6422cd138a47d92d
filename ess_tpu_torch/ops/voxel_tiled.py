"""Halo-tiled trilinear voxelizer over tile-sorted raw events.

Counterpart of the halo half of ``ess_tpu/ops/voxel_pallas.py``:
:func:`tile_id`, :func:`bin_events_device`, :func:`host_tile_bin`,
:func:`voxelize_tiled` (``_kernel`` in halo mode plus ``_fold_halo``) and
:func:`voxelize_trilinear` (``voxelize_trilinear_pallas``).

Events keep their raw coordinates and +-1 polarity; they are only sorted by
spatial tile (``tile_h`` rows by 128 columns), on the host
(:func:`host_tile_bin`) or on the device (:func:`bin_events_device`). A
corner that crosses a tile edge belongs to the tile below, to the right or
below-right; the TPU kernel deposits it into a +1 halo row or column and
folds the halos afterwards. Output is NCHW ``(B, bins, height, width)`` f32.

On a CUDA tensor :func:`voxelize_tiled` launches ``csrc/voxel_tiled.cu``, one
launch a call on the persistent scatter core ``csrc/voxel_scatter.cuh``
(plan :func:`voxel_scatter.scatter_plan`): each (window, tile) gathers its
corners from its own event range and those of its upper, left and
upper-left neighbours, so no halo leaves the tile and nothing is folded. On
a CPU tensor it runs :func:`voxelize_tiled_ref`, the plain PyTorch scatter
of the same events. ``oh_dtype='int8'`` takes the TPU kernel's int8 tent
planes in halo mode (the same launch's int8 form: integer corner products
summed exactly); ``layout`` ``'nhwc'`` and ``'s2d'`` are the JAX function's
views of the grid.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ess_tpu_torch.data import native
from ess_tpu_torch.ops import voxel_scatter
from ess_tpu_torch.ops.conv_halo import sm_count
from ess_tpu_torch.ops.voxel import grid_stats, masked_time_norm
from ess_tpu_torch.ops.voxel_scatter import TILE_W, tile_h_for_bins

launches = 0        # kernel launches of voxelize_tiled (CUDA tensors only)
launches_int8 = 0   # those of its int8 form


def tile_id(x: torch.Tensor, y: torch.Tensor, width: int,
            tile_h: int) -> torch.Tensor:
    """Spatial tile index (int32) of an event's truncated coordinate. A
    coordinate in (-1, 0) truncates to 0 and lands in the first tile row or
    column: its out-of-frame corner drops, the in-frame one keeps its
    bilinear weight."""
    tiles_x = width // TILE_W
    tx = torch.clamp(torch.div(x.to(torch.int32), TILE_W,
                               rounding_mode="floor"), 0, tiles_x - 1)
    ty = torch.clamp(torch.div(y.to(torch.int32), tile_h,
                               rounding_mode="floor"), min=0)
    return ty * tiles_x + tx


def bin_events_device(x: torch.Tensor, y: torch.Tensor, ts: torch.Tensor,
                      pol: torch.Tensor, valid: torch.Tensor, *, height: int,
                      width: int, bins: int) -> Tuple[torch.Tensor, ...]:
    """Sort each window's events by spatial tile on their device.

    ``(..., N)`` inputs, sorted along the last axis (stable); invalid events
    sort to the end (tile id = n_tiles). Returns the sorted (x, y, ts, pol)
    and the ``(..., n_tiles + 1)`` int32 offsets. Nothing crosses to the
    host.
    """
    th = tile_h_for_bins(bins)
    n_tiles = (height // th) * (width // TILE_W)
    tid = torch.where(valid, tile_id(x, y, width, th), n_tiles)
    tid, order = torch.sort(tid, dim=-1, stable=True)
    xs, ys, tss, ps = (torch.gather(a, -1, order) for a in (x, y, ts, pol))
    edges = torch.arange(n_tiles + 1, dtype=torch.int32, device=x.device)
    offsets = torch.searchsorted(
        tid, edges.expand(*tid.shape[:-1], n_tiles + 1).contiguous(),
        out_int32=True)
    return xs, ys, tss, ps, offsets


def host_tile_bin(raw_windows: np.ndarray, valid: np.ndarray, *, height: int,
                  width: int, bins: int = 5):
    """(T, N, 4) raw (x, y, t, p) windows + validity -> (raw sorted by
    ``tile_id`` (T, N, 4), valid (T, N) bool, offsets (T, n_tiles + 1) i32)
    on the grid padded to whole tiles, binned by the native library.

    Only valid events with both coordinates in (-1, dim) are kept (a border
    event keeps its in-frame corner). ``bins`` is the voxelizer's effective
    bin count (twice ``num_bins`` for ``separate_pol`` temporal grids): it
    fixes the tile height.
    """
    return native.tile_bin(raw_windows, valid, height=height, width=width,
                           tile_h=tile_h_for_bins(bins), tile_w=TILE_W)


def host_tile_bin_ref(raw_windows: np.ndarray, valid: np.ndarray, *,
                      height: int, width: int, bins: int = 5):
    """Plain numpy version of :func:`host_tile_bin` (stable argsort by tile
    id). Same contract; the test reference."""
    th = tile_h_for_bins(bins)
    hp = -(-height // th) * th
    ntx = -(-width // TILE_W)
    n_tiles = (hp // th) * ntx
    t_dim = raw_windows.shape[0]
    out = np.zeros_like(raw_windows)
    out_valid = np.zeros_like(valid)
    offsets = np.zeros((t_dim, n_tiles + 1), np.int32)
    for i in range(t_dim):
        w = raw_windows[i]
        ok = (valid[i] & (w[:, 0] > -1) & (w[:, 0] < width)
              & (w[:, 1] > -1) & (w[:, 1] < height))
        ev = w[ok]
        tx = np.clip(ev[:, 0].astype(np.int64) // TILE_W, 0, ntx - 1)
        ty = ev[:, 1].astype(np.int64) // th
        tid = ty * ntx + tx
        order = np.argsort(tid, kind="stable")
        m = len(ev)
        out[i, :m] = ev[order]
        out_valid[i, :m] = True
        offsets[i] = np.searchsorted(
            tid[order], np.arange(n_tiles + 1)).astype(np.int32)
    return out, out_valid, offsets


def voxelize_tiled_ref(x: torch.Tensor, y: torch.Tensor, ts: torch.Tensor,
                       pol: torch.Tensor, offsets: torch.Tensor, *,
                       bins: int, height: int, width: int,
                       stats: bool = False, layout: str = "nchw",
                       oh_dtype=None):
    """Plain PyTorch version of :func:`voxelize_tiled`: an index_add scatter
    of each event's 8 trilinear corners in its own tile's frame. A corner
    deposits only inside the tile or its +1 halo row and column, inside the
    grid and inside the bin range; events at or past ``offsets[:, -1]`` are
    not read. ``stats``: also the grid's per-window stats
    (``voxel.grid_stats``). With ``oh_dtype='int8'`` an int64 scatter of
    the int8 planes' integer products (``voxel_scatter.corners``: row gap
    tile_h + 1, column base tile id * COL_SLOT)."""
    q8 = voxel_scatter.quantized(oh_dtype)
    voxel_scatter.check_layout(layout, TILED_LAYOUTS)
    b, n = x.shape
    th = tile_h_for_bins(bins)
    ntx = width // TILE_W
    live = (torch.arange(n, device=x.device)[None, :]
            < offsets[:, -1:].to(torch.int64))
    tx = torch.clamp(torch.div(torch.floor(x), TILE_W, rounding_mode="floor"),
                     0, ntx - 1)
    ty = torch.clamp(torch.div(torch.floor(y), th, rounding_mode="floor"),
                     min=0)
    yl = y - ty * th
    xl = x - tx * TILE_W
    row0 = ty.long() * th
    col0 = tx.long() * TILE_W
    bidx = torch.arange(b, device=x.device)[:, None]
    flat = torch.zeros(b * bins * height * width,
                       dtype=torch.int64 if q8 else torch.float32,
                       device=x.device)
    for c, r, q, v in voxel_scatter.corners(
            yl, xl, ts, pol, q8=q8, gap=th + 1,
            cb=(ty * ntx + tx) * voxel_scatter.COL_SLOT):
        ok = (live & (c >= 0) & (c < bins) & (r >= 0) & (r <= th)
              & (q >= 0) & (q <= TILE_W) & (row0 + r < height)
              & (col0 + q < width))
        if q8:
            ok &= v != 0
        idx = (((bidx * bins + c) * height + row0 + r) * width + col0 + q)
        flat.index_add_(0, idx[ok], v[ok])
    grid = voxel_scatter.cells_to_f32(flat).view(b, bins, height, width)
    out = voxel_scatter.relayout(grid, layout)
    return (out, grid_stats(grid)) if stats else out


# B3's layouts: the raw and stack forms are the folded wire's
TILED_LAYOUTS = ("nchw", "nhwc", "s2d")


def voxelize_tiled(x: torch.Tensor, y: torch.Tensor, ts: torch.Tensor,
                   pol: torch.Tensor, offsets: torch.Tensor, *, bins: int,
                   height: int, width: int, stats: bool = False,
                   layout: str = "nchw", oh_dtype=None):
    """(B, N) tile-sorted events + (B, n_tiles + 1) offsets -> voxel grids
    (B, bins, height, width) f32; with ``stats`` also (B, 3) f32 per-window
    (sum, sum of squares, nonzero count) of the grid: on the card the
    kernel's per-tile partials summed in tile order, the same bits whatever
    the number of windows in the call.

    ``x, y`` are sensor coordinates, ``ts`` the time normalized to
    [0, bins - 1], ``pol`` the signed value (+-1, zero for dropped events);
    events are sorted by :func:`tile_id` and ``offsets`` delimits each
    tile's range. ``height`` is a multiple of ``tile_h_for_bins(bins)`` and
    ``width`` of 128. ``layout`` ``'nhwc'`` (B, H, W, bins) or ``'s2d'``
    (B, H/2, W/2, 4 * bins) instead of NCHW (``'s4d'`` raises);
    ``oh_dtype='int8'`` the int8 tent planes.
    """
    th = tile_h_for_bins(bins)
    b, n = x.shape
    voxel_scatter.check_layout(layout, TILED_LAYOUTS)
    q8 = voxel_scatter.quantized(oh_dtype)
    if height % th or width % TILE_W:
        raise ValueError(f"grid {height}x{width} is not a multiple of the "
                         f"{th}x{TILE_W} tile")
    n_ty, n_tx = height // th, width // TILE_W
    n_tiles = n_ty * n_tx
    if b > 65535:
        raise ValueError(f"voxelize_tiled: {b} windows exceed one launch "
                         "(65535)")
    if tuple(offsets.shape) != (b, n_tiles + 1):
        raise ValueError(f"offsets {tuple(offsets.shape)} != {(b, n_tiles + 1)}")
    if x.device.type == "cpu":
        return voxelize_tiled_ref(x, y, ts, pol, offsets, bins=bins,
                                  height=height, width=width, stats=stats,
                                  layout=layout, oh_dtype=oh_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"voxelize_tiled: unsupported device {x.device}")
    for name, t in (("x", x), ("y", y), ("ts", ts), ("pol", pol)):
        if (t.dtype != torch.float32 or t.shape != (b, n)
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"voxelize_tiled: {name} must be a contiguous "
                             f"float32 ({b}, {n}) tensor on {x.device}")
    if (offsets.dtype != torch.int32 or not offsets.is_contiguous()
            or offsets.device != x.device):
        raise ValueError("voxelize_tiled: offsets must be contiguous int32 "
                         f"on {x.device}")
    from ess_tpu_torch import kernels

    global launches, launches_int8
    lib = kernels.get_lib()
    plan = voxel_scatter.scatter_plan(bins, height, width, b,
                                      sm_count(x.device))
    grid = torch.empty((b, bins, height, width), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cols = (x.data_ptr(), y.data_ptr(), ts.data_ptr(), pol.data_ptr(),
            offsets.data_ptr(), grid.data_ptr())
    shape = (b, n, bins, th, n_ty, n_tx, plan.threads, plan.grid, plan.smem,
             int(q8), stream)
    if stats:
        partials = torch.empty((b, n_tiles, 3), dtype=torch.float32,
                               device=x.device)
        err = lib.ess_voxel_tiled_stats(*cols, partials.data_ptr(), *shape)
    else:
        err = lib.ess_voxel_tiled(*cols, *shape)
    kernels.check(err, "voxel_tiled kernel")
    if q8:
        launches_int8 += 1
    else:
        launches += 1
    out = voxel_scatter.relayout(grid, layout)
    return (out, partials.sum(dim=1)) if stats else out


def voxelize_trilinear(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                       p: torch.Tensor, valid: torch.Tensor, *, num_bins: int,
                       height: int, width: int,
                       offsets: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Trilinear voxelizer on the tiled kernel: (B, N) raw events ->
    (B, num_bins, height, width), for a grid of whole tiles. With no
    ``offsets`` the events are tile-binned on the device first. Only events
    with both coordinates in [0, dim) deposit."""
    ts = masked_time_norm(t.float(), valid, num_bins)
    x, y = x.float(), y.float()
    pol = torch.where(p > 0, 1.0, -1.0).float()
    ok = valid & (x >= 0) & (x < width) & (y >= 0) & (y < height)
    pol = torch.where(ok, pol, torch.zeros_like(pol))
    if offsets is None:
        x, y, ts, pol, offsets = bin_events_device(
            x, y, ts, pol, ok, height=height, width=width, bins=num_bins)
    return voxelize_tiled(x.contiguous(), y.contiguous(), ts.contiguous(),
                          pol.contiguous(),
                          offsets.to(torch.int32).contiguous(), bins=num_bins,
                          height=height, width=width)
