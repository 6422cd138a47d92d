"""Event windows -> dense grids: the plain trilinear voxel grid, the
temporal-bilinear grid, the event histogram, and nonzero normalization.

Counterpart of ``ess_tpu/ops/voxel.py`` (``EventWindow``,
``voxel_grid_temporal``, ``voxel_grid_trilinear``, ``event_histogram``,
``normalize_nonzero``) and of the scatter branch of
``ess_tpu/ops/batch_voxel.py::voxelize_window_soa``. The trilinear grid is
batched over windows and in NCHW: it is the reference the folded kernel
path is tested against. ``voxel_grid_temporal`` and ``event_histogram``
take one :class:`EventWindow` of (N,) tensors, as JAX's do, and are ATen
scatters (``index_add_``) as JAX's are XLA scatters: no kernel of the port
stands behind them.

One deliberate difference from the upstream torch voxelizer, shared with the
JAX kernels: a coordinate in (-1, 0) floors to -1, so its out-of-frame
corner drops and only the in-frame corner keeps its bilinear weight
(upstream truncates toward zero and deposits a negative weight at index 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ess_tpu_torch import resolve_device


class EventWindow(NamedTuple):
    """A fixed-capacity window of events with a validity mask: (N,)
    tensors ``x``, ``y``, ``t``, ``p`` (f32) and ``valid`` (bool); padded
    lanes may hold anything."""

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def from_arrays(x, y, t, p, valid=None, *, device=None) -> "EventWindow":
        """Columns (numpy arrays, tensors or sequences) as f32 tensors on
        ``device`` (None: the first CUDA device); ``valid`` None: every
        lane."""
        dev = resolve_device(device)
        col = lambda a: torch.as_tensor(a).to(dev, torch.float32)  # noqa
        x, y, t, p = col(x), col(y), col(t), col(p)
        valid = (torch.ones(x.shape, dtype=torch.bool, device=dev)
                 if valid is None else torch.as_tensor(valid).to(dev,
                                                                  torch.bool))
        return EventWindow(x, y, t, p, valid)


def masked_time_norm(t: torch.Tensor, valid: torch.Tensor,
                     num_bins: int) -> torch.Tensor:
    """Per-window time normalized to [0, num_bins - 1] over the valid
    events of each row of ``t`` (B, N)."""
    big = torch.finfo(torch.float32).max
    t0 = torch.where(valid, t, big).amin(dim=-1, keepdim=True)
    t1 = torch.where(valid, t, -big).amax(dim=-1, keepdim=True)
    delta = torch.where(t1 - t0 <= 0, torch.ones_like(t0), t1 - t0)
    return (num_bins - 1) * (t - t0) / delta


def voxel_grid_trilinear(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                         p: torch.Tensor, valid: torch.Tensor, *,
                         num_bins: int, height: int, width: int,
                         normalize: bool = False) -> torch.Tensor:
    """(B, N) raw events -> (B, num_bins, height, width) f32 voxel grids.

    Each valid event deposits ``(2p-1) * wx * wy * wt`` into its 8
    surrounding (bin, row, column) corners; corners outside the grid drop.
    """
    b = x.shape[0]
    ts = masked_time_norm(t.float(), valid, num_bins)
    pol = torch.where(p > 0, 1.0, -1.0).float()
    x, y = x.float(), y.float()
    x0, y0, t0 = torch.floor(x), torch.floor(y), torch.floor(ts)
    cells = height * width
    boff = (torch.arange(b, device=x.device) * num_bins * cells)[:, None]
    flat = torch.zeros(b * num_bins * cells, dtype=torch.float32,
                       device=x.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dt in (0, 1):
                xl, yl, tl = x0 + dx, y0 + dy, t0 + dt
                ok = (valid & (xl >= 0) & (xl < width) & (yl >= 0)
                      & (yl < height) & (tl >= 0) & (tl < num_bins))
                w = (pol * (1.0 - torch.abs(xl - x))
                     * (1.0 - torch.abs(yl - y))
                     * (1.0 - torch.abs(tl - ts)))
                idx = boff + (tl.long() * cells + yl.long() * width
                              + xl.long())
                flat.index_add_(0, idx[ok], w[ok])
    grid = flat.view(b, num_bins, height, width)
    return normalize_nonzero(grid) if normalize else grid


def grid_stats(grid: torch.Tensor) -> torch.Tensor:
    """Per-sample (sum, sum of squares, nonzero count) (B, 3) f32 of (B, C,
    H, W) grids. On the card torch's reductions sum in an order that
    depends on B, so two calls over different batches of the same windows
    may differ in the last bit; the voxelizers' own stats do not."""
    g = grid.float()
    return torch.stack([g.sum((1, 2, 3)), (g * g).sum((1, 2, 3)),
                        (g != 0).sum((1, 2, 3)).float()], dim=-1)


def normalize_nonzero(grid: torch.Tensor) -> torch.Tensor:
    """Standardize each sample's nonzero entries to mean 0 / std 1 (biased
    std over nonzeros; zeros stay zero; an all-zero sample is unchanged)."""
    return normalize_from_stats(grid, grid_stats(grid))


def normalize_from_stats(grid: torch.Tensor,
                         stats: torch.Tensor) -> torch.Tensor:
    """Nonzero standardization of (B, ...) grids from per-sample (sum, sum of
    squares, nonzero count) ``stats`` (B, 3), as the JAX package applies it
    after its voxelizer kernel."""
    num = stats[:, 2]
    num_f = torch.clamp(num, min=1.0)
    mean = stats[:, 0] / num_f
    var = stats[:, 1] / num_f - mean * mean
    std = torch.sqrt(torch.clamp(var, min=0.0))
    std = torch.where(std > 0, std, torch.ones_like(std))
    shape = (-1,) + (1,) * (grid.dim() - 1)
    shift = mean.to(grid.dtype).view(shape)
    scale = (1.0 / std).to(grid.dtype).view(shape)
    normed = torch.where(grid != 0, (grid - shift) * scale,
                         torch.zeros_like(grid))
    return torch.where((num > 0).view(shape), normed, grid)


def voxel_grid_temporal(ev: EventWindow, *, num_bins: int, height: int,
                        width: int, separate_pol: bool = False
                        ) -> torch.Tensor:
    """Temporal-bilinear voxel grid of one window with integer pixels: each
    in-frame event splits its polarity between its two neighbouring time
    bins at its (y, x) pixel. Coordinates are cast to integers toward zero;
    an event is in frame where its pixel is and its *float* normalized time
    ``ts`` has ``0 <= ts < num_bins`` (masked min / max time bounds, a
    window of one time normalized over 1). Returns (2 * num_bins, H, W)
    with ``separate_pol`` (the positive events' grid, then the negative
    ones'), else the signed (num_bins, H, W) grid."""
    xs = ev.x.to(torch.int32)
    ys = ev.y.to(torch.int32)
    ts = masked_time_norm(ev.t.float()[None], ev.valid[None], num_bins)[0]
    tis = ts.to(torch.int32)
    dts = ts - tis.float()
    in_frame = ((xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
                & (ts >= 0.0) & (ts < num_bins) & ev.valid)
    cells = height * width
    pix = ys.long() * width + xs.long()
    pos = ev.p > 0

    def scatter(values: torch.Tensor) -> torch.Tensor:
        flat = torch.zeros(num_bins * cells, dtype=torch.float32,
                           device=ev.x.device)
        left = in_frame & (tis < num_bins)
        right = in_frame & (tis + 1 < num_bins)
        flat.index_add_(0, (tis.long() * cells + pix)[left],
                        (values * (1.0 - dts))[left])
        flat.index_add_(0, ((tis.long() + 1) * cells + pix)[right],
                        (values * dts)[right])
        return flat.view(num_bins, height, width)

    if separate_pol:
        return torch.cat([scatter(pos.float()), scatter((~pos).float())])
    return scatter(torch.where(pos, 1.0, -1.0))


def event_histogram(ev: EventWindow, *, height: int, width: int
                    ) -> torch.Tensor:
    """(2, H, W) event counts of one window: channel 0 the negative events,
    1 the positive ones (``p > 0``); coordinates cast toward zero, events
    outside the frame dropped."""
    xs = ev.x.to(torch.int32).long()
    ys = ev.y.to(torch.int32).long()
    ok = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height) & ev.valid
    cells = height * width
    idx = (ev.p > 0).long() * cells + ys * width + xs
    flat = torch.zeros(2 * cells, dtype=torch.float32, device=ev.x.device)
    flat.index_add_(0, idx[ok], torch.ones_like(ev.x)[ok])
    return flat.view(2, height, width)
