"""Fold-free voxelizer over host ghost-folded (band, x-slot) records.

Counterpart of ``ess_tpu/ops/voxel_pallas.py``: :func:`host_band_bin_folded`
(trilinear or integer-coordinate, with or without x-slots) and
:func:`voxelize_folded` on both of its wires: the x-slot branch that runs
``_kernel_slotted`` and the legacy full-width band branch that runs
``_kernel`` with ``k_tiles=1``.

The host pass rewrites every event whose bilinear footprint crosses a frame
edge, a band of ``tile_h`` rows or a 128-column x-slot into single-corner
records with the crossing weight folded into a pre-weighted polarity, and
sorts the records by (band, x-slot) group. Integer-coordinate streams
(DDD17, ``trilinear=False``) have no spatial fractions: their records are
the in-frame events with +-1 polarity, sorted the same way, with no ghosts.
Each group then deposits only
into its own ``bins x tile_h x 128`` tile of the grid, so the x-slot kernel
(``csrc/voxel_folded.cu`` on the persistent scatter core
``csrc/voxel_scatter.cuh``, plan :func:`voxel_scatter.scatter_plan`) takes
each (window, group) as one work item: its persistent blocks accumulate a
tile in fixed point in shared memory (the same bits on every launch),
store it and reduce its
normalization partials (sum, sum of squares, nonzero count), one launch a
call; the partials are summed per window in group order.

Without x-slots (``x_slots=False``, the legacy wire) the host folds across
band rows and frame edges only, groups are whole bands and columns stay
global; the offsets then have ``n_bands + 1`` columns and the kernel's
second entry (``ess_voxel_folded_band``) runs the same core with the plan's
``mode='band'``: each (window, band, 128-column tile) is a work item that
walks its band's range and keeps the records that reach its tile, with the
same tile stores and partials, one launch a call.
:func:`voxelize_folded` picks the wire by the width of the offsets, as the
JAX function does; at a 128-wide grid the two wires are the same and run the
x-slot kernel.

On a CUDA tensor :func:`voxelize_folded` launches that kernel; on a CPU
tensor it runs :func:`voxelize_folded_ref`, the plain PyTorch scatter of the
same records.

The opt-in pins are forms of the same launch (``voxel_scatter.cuh``):
``oh_dtype='int8'`` the TPU kernel's int8 tent planes (integer corner
products summed exactly), ``layout='raw'`` the raw band accumulator
``(B, n_bands, bins * tile_h, width)`` on either wire, ``layout='stack'``
(x-slot wire) the space-to-depth NCHW stack ``(B, 4 * bins, height / 2,
width / 2)``, and ``layout='s2d', deint=True`` the s2d grid taken from the
stack emission; ``'nhwc'`` and ``'s2d'`` are otherwise views or copies of
the NCHW grid, as the JAX function's layouts. The stats are the same bits
in every layout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ess_tpu_torch.data import native
from ess_tpu_torch.ops import voxel_scatter
from ess_tpu_torch.ops.conv_halo import sm_count
from ess_tpu_torch.ops.voxel_scatter import TILE_W, tile_h_for_bins

# kernel launches (CUDA tensors only), one count a form: the x-slot wire's
# default (f32, NCHW grid), stack, raw and int8 (any layout) forms, and the
# full-width band wire's default, raw and int8 forms
launches = 0
launches_stack = 0
launches_raw = 0
launches_int8 = 0
launches_legacy = 0
launches_legacy_raw = 0
launches_legacy_int8 = 0


def _geometry(height: int, width: int, bins: int) -> tuple[int, int, int]:
    th = tile_h_for_bins(bins)
    hp = -(-height // th) * th
    wp = -(-width // TILE_W) * TILE_W
    return th, hp, wp


def _capacity(n: int, trilinear: bool, capacity: Optional[int]) -> int:
    """Record capacity: ``capacity``, else room for the trilinear wire's
    ghosts, else ``n`` (integer-coordinate records never split)."""
    if capacity is not None:
        return capacity
    return native.folded_capacity(n) if trilinear else n


def host_band_bin_folded(raw_windows: np.ndarray, valid: np.ndarray, *,
                         height: int, width: int, bins: int = 5,
                         trilinear: bool = True,
                         capacity: Optional[int] = None,
                         x_slots: bool = True):
    """(T, N, 4) raw (x, y, t, p) windows + validity -> (records (T, N2, 4)
    f32 with pre-weighted signed polarity, valid (T, N2) bool, offsets
    (T, n_groups + 1) i32), binned by the native library. ``x_slots``
    groups by (band, 128-column slot), ``n_groups = n_bands * n_slots``;
    without it by band only (the legacy wire), ``n_groups = n_bands``.
    ``trilinear=False`` bins integer-coordinate events (no folds, no
    ghosts, capacity ``N`` unless given). ``bins`` is the voxelizer's
    channel count (``batch_voxel.effective_bins``): it fixes the band
    height."""
    th, hp, wp = _geometry(height, width, bins)
    return native.band_bin_folded(
        raw_windows, valid, height=height, width=width, tile_h=th,
        trilinear=trilinear,
        capacity=_capacity(raw_windows.shape[1], trilinear, capacity),
        ntx=wp // TILE_W if x_slots else 1, slot_w=TILE_W)


def host_band_bin_folded_ref(raw_windows: np.ndarray, valid: np.ndarray, *,
                             height: int, width: int, bins: int = 5,
                             trilinear: bool = True,
                             capacity: Optional[int] = None,
                             x_slots: bool = True):
    """Plain numpy version of :func:`host_band_bin_folded` (float64 folds,
    stable argsort by group). Same contract; the test reference."""
    th, hp, wp = _geometry(height, width, bins)
    n_bands = hp // th
    ntx = wp // TILE_W if x_slots else 1
    t_dim, n = raw_windows.shape[:2]
    n2 = _capacity(n, trilinear, capacity)

    per_window = []
    for i in range(t_dim):
        w = raw_windows[i]
        x = w[:, 0].astype(np.float64)
        y = w[:, 1].astype(np.float64)
        t = w[:, 2].astype(np.float64)
        p = np.where(w[:, 3] > 0, 1.0, -1.0)
        if not trilinear:
            # integer coordinates: the in-frame events, sorted as they are
            ok = (valid[i] & (np.floor(x) >= 0) & (np.floor(x) < width)
                  & (np.floor(y) >= 0) & (np.floor(y) < height))
            x, y, t, p = x[ok], y[ok], t[ok], p[ok]
            band = np.clip((y // th).astype(np.int64), 0, n_bands - 1)
            slot = np.clip((x // TILE_W).astype(np.int64), 0, ntx - 1)
            group = band * ntx + slot
            order = np.argsort(group, kind="stable")
            per_window.append((x[order], y[order], t[order], p[order],
                               group[order]))
            continue
        ok = valid[i] & (x > -1) & (x < width) & (y > -1) & (y < height)
        x, y, t, p = x[ok], y[ok], t[ok], p[ok]
        # frame edges: a coordinate in (-1, 0) or (dim-1, dim) keeps only its
        # in-frame corner, its weight folded into p
        m = x < 0
        p[m] *= 1.0 + x[m]
        x[m] = 0.0
        m = x > width - 1
        p[m] *= width - x[m]
        x[m] = width - 1
        m = y < 0
        p[m] *= 1.0 + y[m]
        y[m] = 0.0
        m = y > height - 1
        p[m] *= height - y[m]
        y[m] = height - 1
        # band boundary: the record keeps the band's last row, a ghost on the
        # next band's first row carries the remainder
        band = (y // th).astype(np.int64)
        yl = y - band * th
        frac = yl - (th - 1)
        bm = frac > 0
        gx, gt = x[bm], t[bm]
        gp = p[bm] * frac[bm]
        gy = (band[bm] + 1) * float(th)
        p[bm] *= th - yl[bm]
        y[bm] = band[bm] * th + (th - 1)
        x = np.concatenate([x, gx])
        y = np.concatenate([y, gy])
        t = np.concatenate([t, gt])
        p = np.concatenate([p, gp])
        if x_slots:
            # x-slot boundary: a right corner on a TILE_W multiple moves to
            # a ghost on the next slot's first column
            fx = x - np.floor(x)
            xr = np.floor(x) + 1.0
            bm = (fx > 0) & (np.mod(xr, TILE_W) == 0) & (xr <= width - 1)
            gx2, gy2, gt2 = xr[bm], y[bm], t[bm]
            gp2 = p[bm] * fx[bm]
            p[bm] *= 1.0 - fx[bm]
            x[bm] = np.floor(x[bm])
            x = np.concatenate([x, gx2])
            y = np.concatenate([y, gy2])
            t = np.concatenate([t, gt2])
            p = np.concatenate([p, gp2])
        band = np.clip((y // th).astype(np.int64), 0, n_bands - 1)
        slot = np.clip((x // TILE_W).astype(np.int64), 0, ntx - 1)
        group = band * ntx + slot
        order = np.argsort(group, kind="stable")
        per_window.append((x[order], y[order], t[order], p[order],
                           group[order]))

    needed = max((len(pw[0]) for pw in per_window), default=0)
    if needed > n2:
        n2 = native.quantize_folded_capacity(needed, n)

    out = np.zeros((t_dim, n2, 4), np.float32)
    out_valid = np.zeros((t_dim, n2), bool)
    offsets = np.zeros((t_dim, n_bands * ntx + 1), np.int32)
    for i, (x, y, t, p, group) in enumerate(per_window):
        m = len(x)
        out[i, :m, 0] = x
        out[i, :m, 1] = y
        out[i, :m, 2] = t
        out[i, :m, 3] = p
        out_valid[i, :m] = True
        offsets[i] = np.searchsorted(
            group, np.arange(n_bands * ntx + 1)).astype(np.int32)
    return out, out_valid, offsets


def voxelize_folded_ref(x: torch.Tensor, y: torch.Tensor, ts: torch.Tensor,
                        pol: torch.Tensor, offsets: torch.Tensor, *,
                        bins: int, height: int, width: int,
                        layout: str = "nchw", oh_dtype=None,
                        deint: bool = False):
    """Plain PyTorch version of :func:`voxelize_folded`: an index_add scatter
    of each record's 8 trilinear corners, with every corner outside its
    record's group (band and x-slot, or the whole band on the legacy wire)
    or bin range dropped (those corners carry zero weight on folded
    input); with ``oh_dtype='int8'`` an int64 scatter of the int8 planes'
    integer products (``voxel_scatter.corners``). Layouts as
    :func:`voxelize_folded` (``deint`` changes no value)."""
    q8 = voxel_scatter.quantized(oh_dtype)
    _check_layout(layout, offsets, bins, height)
    b, n = x.shape
    th = tile_h_for_bins(bins)
    n_bands = height // th
    ntx = (offsets.shape[1] - 1) // n_bands
    slot_w = width // ntx
    live = (torch.arange(n, device=x.device)[None, :]
            < offsets[:, -1:].to(torch.int64))
    band = torch.clamp(torch.div(torch.floor(y), th, rounding_mode="floor"),
                       0, n_bands - 1)
    slot = torch.clamp(torch.div(torch.floor(x), slot_w,
                                 rounding_mode="floor"), 0, ntx - 1)
    yl = y - band * th
    xl = x - slot * slot_w
    row0 = band.long() * th
    col0 = slot.long() * slot_w
    bidx = torch.arange(b, device=x.device)[:, None]
    flat = torch.zeros(b * bins * height * width,
                       dtype=torch.int64 if q8 else torch.float32,
                       device=x.device)
    # the TPU kernel's global column base: band * width + slot column
    for c, r, col, v in voxel_scatter.corners(
            yl, xl, ts, pol, q8=q8, gap=th, cb=band * width + slot * slot_w):
        ok = (live & (c >= 0) & (c < bins) & (r >= 0) & (r < th)
              & (col >= 0) & (col < slot_w))
        if q8:
            ok &= v != 0
        idx = (((bidx * bins + c) * height + row0 + r) * width + col0 + col)
        flat.index_add_(0, idx[ok], v[ok])
    grid = voxel_scatter.cells_to_f32(flat).view(b, bins, height, width)
    stats = torch.stack([grid.sum((1, 2, 3)), (grid * grid).sum((1, 2, 3)),
                         (grid != 0).sum((1, 2, 3)).float()], dim=-1)
    return voxel_scatter.relayout(grid, layout, th), stats


def _check_layout(layout: str, offsets: torch.Tensor, bins: int,
                  height: int) -> None:
    """Raise on a layout :func:`voxelize_folded` does not emit for these
    offsets (the stack needs the x-slot wire with more than one slot, as
    JAX's assert)."""
    voxel_scatter.check_layout(layout)
    n_bands = height // tile_h_for_bins(bins)
    if layout == "stack" and offsets.shape[1] - 1 == n_bands:
        raise ValueError("layout 'stack' needs the x-slot wire (per-slot "
                         "offsets, more than one 128-column slot)")


def voxelize_folded(x: torch.Tensor, y: torch.Tensor, ts: torch.Tensor,
                    pol: torch.Tensor, offsets: torch.Tensor, *,
                    bins: int, height: int, width: int,
                    layout: str = "nchw", oh_dtype=None,
                    deint: bool = False):
    """(B, N) folded records + (B, n_groups + 1) offsets -> (grid (B, bins,
    height, width) f32, stats (B, 3) f32 = per-window sum, sum of squares
    and nonzero count of the grid).

    ``layout``: ``'nchw'`` (above), ``'nhwc'`` (B, H, W, bins), ``'s2d'``
    (B, H/2, W/2, 4 * bins) space-to-depth blocks, ``'raw'`` the raw band
    accumulator (B, n_bands, bins * tile_h, W), ``'stack'`` (x-slot wire)
    the s2d NCHW stack (B, 4 * bins, H/2, W/2); ``'s4d'`` raises.
    ``deint`` with ``'s2d'`` on the x-slot wire (tile height a multiple of
    8, as JAX's) emits the s2d grid from the stack form; elsewhere it is
    ignored, as in JAX. ``oh_dtype``: ``'int8'`` the int8 tent planes,
    ``'bfloat16'`` / ``'float32'`` / None the f32 core.

    ``x, y`` are sensor coordinates, ``ts`` the time normalized to
    [0, bins - 1], ``pol`` the pre-weighted polarity (zero for dropped
    records); only records before ``offsets[:, -1]`` are read. ``height`` is
    a multiple of ``tile_h_for_bins(bins)`` and ``width`` of 128. The width
    of the offsets picks the wire: ``n_bands * width // 128 + 1`` columns
    the x-slot one, ``n_bands + 1`` the legacy full-width band one.
    """
    th = tile_h_for_bins(bins)
    b, n = x.shape
    if height % th or width % TILE_W:
        raise ValueError(f"grid {height}x{width} is not a multiple of the "
                         f"{th}x{TILE_W} tile")
    n_bands, n_slots = height // th, width // TILE_W
    if b > 65535:
        raise ValueError(f"voxelize_folded: {b} windows exceed one launch "
                         "(65535)")
    if (offsets.ndim != 2 or offsets.shape[0] != b
            or offsets.shape[1] - 1 not in (n_bands * n_slots, n_bands)):
        raise ValueError(f"offsets {tuple(offsets.shape)} are neither "
                         f"{(b, n_bands * n_slots + 1)} (x-slots) nor "
                         f"{(b, n_bands + 1)} (full-width bands)")
    legacy = offsets.shape[1] - 1 != n_bands * n_slots
    _check_layout(layout, offsets, bins, height)
    q8 = voxel_scatter.quantized(oh_dtype)
    if x.device.type == "cpu":
        return voxelize_folded_ref(x, y, ts, pol, offsets, bins=bins,
                                   height=height, width=width, layout=layout,
                                   oh_dtype=oh_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"voxelize_folded: unsupported device {x.device}")
    for name, t in (("x", x), ("y", y), ("ts", ts), ("pol", pol)):
        if (t.dtype != torch.float32 or t.shape != (b, n)
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"voxelize_folded: {name} must be a contiguous "
                             f"float32 ({b}, {n}) tensor on {x.device}")
    if (offsets.dtype != torch.int32 or not offsets.is_contiguous()
            or offsets.device != x.device):
        raise ValueError("voxelize_folded: offsets must be contiguous int32 "
                         f"on {x.device}")
    from ess_tpu_torch import kernels

    global launches, launches_stack, launches_raw, launches_int8, \
        launches_legacy, launches_legacy_raw, launches_legacy_int8
    lib = kernels.get_lib()
    deint = (deint and layout == "s2d" and not legacy and n_slots > 1
             and th % 8 == 0)
    form = ("stack" if deint else layout if layout in ("raw", "stack")
            else "nchw")
    shape = {"nchw": (b, bins, height, width),
             "raw": (b, n_bands, bins * th, width),
             "stack": (b, 4 * bins, height // 2, width // 2)}[form]
    grid = torch.empty(shape, dtype=torch.float32, device=x.device)
    code = voxel_scatter.LAYOUTS.index(form)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cols = (x.data_ptr(), y.data_ptr(), ts.data_ptr(), pol.data_ptr(),
            offsets.data_ptr(), grid.data_ptr())
    plan = voxel_scatter.scatter_plan(bins, height, width, b,
                                      sm_count(x.device),
                                      mode="band" if legacy else "tile")
    partials = torch.empty((b, n_bands * n_slots, 3), dtype=torch.float32,
                           device=x.device)
    if legacy:
        err = lib.ess_voxel_folded_band(
            *cols, partials.data_ptr(), b, n, bins, th, n_bands, width,
            plan.threads, plan.grid, plan.smem, code, int(q8), stream)
        kernels.check(err, "voxel_folded band kernel")
        if q8:
            launches_legacy_int8 += 1
        elif form == "raw":
            launches_legacy_raw += 1
        else:
            launches_legacy += 1
    else:
        err = lib.ess_voxel_folded(
            *cols, partials.data_ptr(), b, n, bins, th, n_bands, n_slots,
            width, plan.threads, plan.grid, plan.smem, code, int(q8), stream)
        kernels.check(err, "voxel_folded kernel")
        if q8:
            launches_int8 += 1
        elif form == "stack":
            launches_stack += 1
        elif form == "raw":
            launches_raw += 1
        else:
            launches += 1
    stats = partials.sum(dim=1)
    if deint:
        return grid.permute(0, 2, 3, 1), stats
    return (grid if form != "nchw"
            else voxel_scatter.relayout(grid, layout, th)), stats
