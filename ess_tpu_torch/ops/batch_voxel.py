"""Batched voxelization of event windows on the two event wires.

Counterpart of ``ess_tpu/ops/batch_voxel.py``: ``effective_bins``, the two
branches of ``_voxelize_pallas``, the ``histogram`` and ``ev_segnet``
representations and their dispatcher ``voxelize_window_soa``.

- :func:`voxelize_band` (``offsets_kind='band'``): host ghost-folded records
  with pre-weighted polarity through the fold-free voxelizer, normalized
  from its per-window stats; float-coordinate (trilinear, DSEC) or
  integer-coordinate (temporal bilinear, DDD17: floored coordinates, the
  time clipped to the bin range, ``separate_pol`` folding the polarity into
  the bin axis) records.
- :func:`voxelize_tile` (``offsets_kind='tile'``): raw events with +-1
  polarity, tile-sorted on the host (``ev_tile_offsets``) or on the device
  (no offsets), through the halo-tiled voxelizer, normalized over the grid.

Both apply the per-window time normalization over the valid events (or
take the time as it comes with ``t_prenormalized``: a decoded packed
window, whose host ingest normalized it) and the in-frame mask, voxelize on
the grid padded to whole tiles, and crop back to the sensor size.

- :func:`event_histogram` and :func:`ev_segnet_grid`: raw events of any
  order (tile offsets are ignored) through one flat ATen scatter-add, as
  the JAX package computes them with an XLA scatter, not a Pallas kernel.
- :func:`rectify_events`: DSEC's rectification on the device, a gather of
  the (H, W, 2) rectify map at each event's integer sensor pixel (a plain
  tensor op, as JAX's is an XLA gather); ``voxelize_window_soa(
  rectify_map=...)`` applies it before any representation and then
  voxelizes trilinearly.
- :func:`voxelize_windows`: the dense form, (B, T, N, 4) events ->
  (B, T, H, W, C) grids, all B*T windows in one voxelizer launch.

Grids are NCHW but for :func:`voxelize_windows`, whose output keeps the
JAX package's channel-last order, and for the voxel grid's other layouts
(``layout=``, JAX's ``_voxelize_pallas``): ``'nhwc'``, ``'s2d'`` (B, H/2,
W/2, 4C), ``'s4d'`` (B, H/4, W/4, 16C; relaid from the cropped grid after
the voxelizer, where JAX too makes it outside its kernels), and on the
band wire ``'raw'`` (the kernel's raw band
accumulator and its stats, normalized and width-resized only where a
resize folds in) and ``'stack'`` (the s2d NCHW stack and its stats, x-slot
wire); ``oh_dtype='int8'`` selects the voxelizers' int8 tent planes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ess_tpu_torch.ops.resize import resize_bilinear
from ess_tpu_torch.ops.voxel import (
    masked_time_norm, normalize_from_stats, normalize_nonzero)
from ess_tpu_torch.ops.voxel_folded import (
    TILE_W, tile_h_for_bins, voxelize_folded)
from ess_tpu_torch.ops.voxel_scatter import (
    GRID_LAYOUTS, check_layout, relayout, to_s4d)

# the voxel grid's layouts here: the voxelizers' and the quad-block
# rollout's 4x4 blocks, relaid from the cropped grid (voxel_scatter.to_s4d)
BATCH_LAYOUTS = GRID_LAYOUTS + ("s4d",)


def _laid_out(grid: torch.Tensor, layout: str) -> torch.Tensor:
    return to_s4d(grid) if layout == "s4d" else relayout(grid, layout)
from ess_tpu_torch.ops.voxel_tiled import bin_events_device, voxelize_tiled


def rectify_events(x: torch.Tensor, y: torch.Tensor,
                   rectify_map: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rectified float coordinates of events at sensor coordinates (x, y):
    ``rectify_map[y, x] = (x_rect, y_rect)``, the coordinates cast to
    integers toward zero and clipped to the map's shape first, as JAX's
    ``rectify_events``. One gather on the events' device; the map must lie
    there too."""
    if rectify_map.device != x.device:
        raise ValueError(f"the rectify map lies on {rectify_map.device}, "
                         f"the events on {x.device}")
    h, w = rectify_map.shape[:2]
    xi = x.to(torch.int32).clamp(0, w - 1).long()
    yi = y.to(torch.int32).clamp(0, h - 1).long()
    rect = rectify_map.reshape(h * w, 2)[yi * w + xi]
    return rect[..., 0], rect[..., 1]


def effective_bins(num_bins: int, separate_pol: bool, trilinear: bool) -> int:
    """Channel count the voxelizer builds (``separate_pol`` folds polarity
    into the bin axis on the temporal-bilinear path). Host tile binning
    (``host_tile_bin(bins=...)``) must use this value: it fixes the tile
    height."""
    return 2 * num_bins if (separate_pol and not trilinear) else num_bins


def _padded(height: int, width: int, bins: int) -> tuple[int, int]:
    th = tile_h_for_bins(bins)
    return -(-height // th) * th, -(-width // TILE_W) * TILE_W


def _time(t: torch.Tensor, valid: torch.Tensor, num_bins: int,
          t_prenormalized: bool) -> torch.Tensor:
    t = t.float()
    return t if t_prenormalized else masked_time_norm(t, valid, num_bins)


def band_operands(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                  p: torch.Tensor, valid: torch.Tensor,
                  offsets: torch.Tensor, *, num_bins: int, height: int,
                  width: int, separate_pol: bool = False,
                  trilinear: bool = True, t_prenormalized: bool = False):
    """``voxelize_folded``'s operands and keywords for (B, N) folded
    records: ``((x, y, ts, pol, offsets), dict(bins, height, width))``,
    the grid padded to the kernel's tiles (:func:`voxelize_band`).

    ``p`` is the host's pre-weighted signed polarity; ``offsets`` the
    (B, n_groups + 1) group offsets of :func:`host_band_bin_folded`, binned
    with ``bins=C``. ``ts`` is the normalized time (``t`` itself with
    ``t_prenormalized``); ``trilinear=False`` floors the coordinates and
    clips ``ts`` to [0, num_bins - 1] (pure temporal bilinear); with
    ``separate_pol`` negative records then go to bins
    ``num_bins .. 2 * num_bins - 1`` with their magnitude. ``pol`` is
    0 on invalid records and on records outside the sensor frame.
    """
    x, y, p = x.float(), y.float(), p.float()
    ok = valid & (x > -1) & (x < width) & (y > -1) & (y < height)
    ts = _time(t, valid, num_bins, t_prenormalized)
    pol = p
    if not trilinear:
        x, y = torch.floor(x), torch.floor(y)
        ts = torch.clamp(ts, 0.0, num_bins - 1)
    bins_eff = effective_bins(num_bins, separate_pol, trilinear)
    if bins_eff != num_bins:
        ts = ts + torch.where(pol < 0, float(num_bins), 0.0)
        pol = pol.abs()
    hp, wp = _padded(height, width, bins_eff)
    pol = torch.where(ok, pol, torch.zeros_like(pol))
    args = (x.contiguous(), y.contiguous(), ts.contiguous(), pol.contiguous(),
            offsets.to(torch.int32).contiguous())
    return args, dict(bins=bins_eff, height=hp, width=wp)


def resize_width(x: torch.Tensor, width: int,
                 align_corners: bool = True) -> torch.Tensor:
    """A width-only bilinear resize of (..., H, W) (``resize_bilinear`` at
    the same height): the minor-axis resize JAX folds into its voxelizer."""
    shape = x.shape
    y = resize_bilinear(x.reshape(-1, 1, *shape[-2:]), shape[-2], width,
                        align_corners=align_corners)
    return y.view(*shape[:-1], width)


def voxelize_band(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                  p: torch.Tensor, valid: torch.Tensor,
                  offsets: torch.Tensor, *, num_bins: int, height: int,
                  width: int, separate_pol: bool = False,
                  trilinear: bool = True, normalize: bool = False,
                  t_prenormalized: bool = False, layout: str = "nchw",
                  oh_dtype=None, deint: bool = False,
                  resize_width_to: Optional[int] = None,
                  resize_align_corners: bool = True):
    """(B, N) folded records -> (B, C, height, width) f32 grids, C =
    ``effective_bins(...)``: :func:`band_operands` (which says what each
    option does), then ``voxelize_folded``. Normalization uses the
    kernel's stats over the grid at sensor resolution.

    ``layout``: ``'nhwc'`` / ``'s2d'`` / ``'s4d'`` the grid so laid out
    (``deint`` the s2d grid from the stack emission), after the width
    resize to
    ``resize_width_to`` where one is given; ``'raw'`` -> (raw band
    accumulator (B, n_bands, C * tile_h, W_pad), stats), with a resize
    normalized (if asked), cut to the sensor width and resized, else as
    the kernel wrote it; ``'stack'`` -> (the s2d NCHW stack cut to
    (B, 4C, height / 2, width / 2), stats), no resize. ``oh_dtype``: the
    tent planes (``voxel_scatter.quantized``).
    """
    args, kw = band_operands(x, y, t, p, valid, offsets, num_bins=num_bins,
                             height=height, width=width,
                             separate_pol=separate_pol, trilinear=trilinear,
                             t_prenormalized=t_prenormalized)
    resize = resize_width_to is not None and resize_width_to != width
    if layout == "stack":
        if resize:
            raise ValueError("layout 'stack' cannot fold a resize")
        stack, stats = voxelize_folded(*args, **kw, layout="stack",
                                       oh_dtype=oh_dtype)
        return stack[:, :, :height // 2, :width // 2], stats
    if layout == "raw":
        raw, stats = voxelize_folded(*args, **kw, layout="raw",
                                     oh_dtype=oh_dtype)
        if resize:
            if normalize:
                raw = normalize_from_stats(raw, stats)
            raw = resize_width(raw[..., :width], resize_width_to,
                               resize_align_corners)
        return raw, stats
    if layout == "s2d" and deint and not resize:
        grid, stats = voxelize_folded(*args, **kw, layout="s2d", deint=True,
                                      oh_dtype=oh_dtype)
        if normalize:
            grid = normalize_from_stats(grid, stats)
        return grid[:, :height // 2, :width // 2]
    grid, stats = voxelize_folded(*args, **kw, oh_dtype=oh_dtype)
    if normalize:
        grid = normalize_from_stats(grid, stats)
    grid = grid[:, :, :height, :width]
    if resize:
        grid = resize_width(grid, resize_width_to, resize_align_corners)
    return _laid_out(grid, layout)


def voxelize_tile(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                  p: torch.Tensor, valid: torch.Tensor,
                  offsets: Optional[torch.Tensor] = None, *, num_bins: int,
                  height: int, width: int, separate_pol: bool = False,
                  trilinear: bool = False, normalize: bool = False,
                  t_prenormalized: bool = False, layout: str = "nchw",
                  oh_dtype=None) -> torch.Tensor:
    """(B, N) raw events -> (B, C, height, width) f32 grids, C =
    ``effective_bins(...)``.

    ``offsets`` are the (B, n_tiles + 1) tile offsets of ``host_tile_bin``
    for events that arrive tile-sorted; with None the events are sorted on
    the device. ``trilinear=False`` floors the coordinates (pure temporal
    bilinear); with ``separate_pol`` negative events then go to bins
    ``num_bins .. 2 * num_bins - 1`` with weight +1. ``t_prenormalized``
    takes ``t`` as the normalized time. ``layout`` ``'nhwc'``, ``'s2d'`` or
    ``'s4d'`` lays the normalized grid out so; ``oh_dtype`` picks the tent planes.
    """
    if layout in ("raw", "stack"):
        raise ValueError(f"layout {layout!r} needs the folded band wire "
                         "(band offsets)")
    check_layout(layout, BATCH_LAYOUTS)
    x, y = x.float(), y.float()
    ok = valid & (x > -1) & (x < width) & (y > -1) & (y < height)
    ts = _time(t, valid, num_bins, t_prenormalized)
    pol = torch.where(p > 0, 1.0, -1.0).float()
    if not trilinear:
        x, y = torch.floor(x), torch.floor(y)
        ts = torch.clamp(ts, 0.0, num_bins - 1)
    bins_eff = effective_bins(num_bins, separate_pol, trilinear)
    if bins_eff != num_bins:
        ts = ts + torch.where(pol < 0, float(num_bins), 0.0)
        pol = pol.abs()
    hp, wp = _padded(height, width, bins_eff)
    pol = torch.where(ok, pol, torch.zeros_like(pol))
    if offsets is None:
        x, y, ts, pol, offsets = bin_events_device(
            x, y, ts, pol, ok, height=hp, width=wp, bins=bins_eff)
    cols = (x.contiguous(), y.contiguous(), ts.contiguous(),
            pol.contiguous(), offsets.to(torch.int32).contiguous())
    kw = dict(bins=bins_eff, height=hp, width=wp, oh_dtype=oh_dtype)
    if normalize and (hp, wp) == (height, width):
        # the voxelizer's own stats: the same bits whether the windows come
        # in one call or one batch at a time (torch's reductions would not)
        return _laid_out(normalize_from_stats(
            *voxelize_tiled(*cols, **kw, stats=True)), layout)
    grid = voxelize_tiled(*cols, **kw)[:, :, :height, :width]
    return _laid_out(normalize_nonzero(grid) if normalize else grid, layout)


def _pixel_index(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                 height: int, width: int):
    """(in-frame mask, flat pixel index) of (B, N) events: coordinates cast
    to integers toward zero (an x in (-1, 0) lands in column 0), as JAX's
    ``astype(int32)``."""
    xi = x.float().to(torch.int64)
    yi = y.float().to(torch.int64)
    ok = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height) & valid
    return ok, yi * width + xi


def _scatter_planes(ok: torch.Tensor, index: torch.Tensor,
                    values: Sequence[torch.Tensor], planes: int,
                    cells: int) -> list:
    """Sum each of ``values`` (B, N) at ``index`` (B, N, in [0, planes *
    cells)) of its sample's ``planes`` planes; events outside ``ok`` add
    nothing. One flat ``index_add_`` a value -> (B, planes, cells) f32."""
    b = ok.shape[0]
    boff = torch.arange(b, device=ok.device)[:, None] * (planes * cells)
    idx = torch.where(ok, boff + index, 0).reshape(-1)
    out = []
    for v in values:
        flat = torch.zeros(b * planes * cells, dtype=torch.float32,
                           device=ok.device)
        flat.index_add_(0, idx, torch.where(ok, v, 0.0).reshape(-1))
        out.append(flat.view(b, planes, cells))
    return out


def event_histogram(x: torch.Tensor, y: torch.Tensor, p: torch.Tensor,
                    valid: torch.Tensor, *, height: int, width: int
                    ) -> torch.Tensor:
    """(B, N) events -> (B, 2, height, width) f32 event counts per pixel:
    channel 0 the negative events, 1 the positive ones (``p > 0``)."""
    ok, pix = _pixel_index(x, y, valid, height, width)
    cells = height * width
    chan = (p > 0).to(torch.int64)
    (grid,) = _scatter_planes(ok, chan * cells + pix,
                              [torch.ones_like(x, dtype=torch.float32)],
                              2, cells)
    return grid.view(-1, 2, height, width)


def ev_segnet_grid(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                   p: torch.Tensor, valid: torch.Tensor, *, height: int,
                   width: int) -> torch.Tensor:
    """(B, N) events -> (B, 6, height, width) f32: EV-SegNet's
    representation, per polarity the event count and the mean and standard
    deviation of the timestamps normalized to [0, 1] over the window's
    valid events, in the order [cnt+, cnt-, mean_t+, mean_t-, std_t+,
    std_t-]. A window with no valid event gives zeros."""
    ok, pix = _pixel_index(x, y, valid, height, width)
    cells = height * width
    t = t.float()
    tmax = torch.where(valid, t, -torch.inf).amax(-1, keepdim=True)
    tmin = torch.where(valid, t, torch.inf).amin(-1, keepdim=True)
    tn = (t - tmin) / torch.clamp(tmax - tmin, min=1e-9)
    chan = torch.where(p > 0, 0, 1)
    cnt, s_t, s_t2 = _scatter_planes(
        ok, chan * cells + pix, [torch.ones_like(tn), tn, tn * tn], 2, cells)
    denom = torch.clamp(cnt, min=1.0)
    mean = s_t / denom
    std = torch.sqrt(torch.clamp(s_t2 / denom - mean * mean, min=0.0))
    return torch.cat([cnt, mean, std], 1).view(-1, 6, height, width)


REPRESENTATIONS = ("voxel_grid", "histogram", "ev_segnet")


def voxelize_window_soa(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                        p: torch.Tensor, valid: torch.Tensor, *,
                        num_bins: int, height: int, width: int,
                        representation: str = "voxel_grid",
                        separate_pol: bool = False, trilinear: bool = False,
                        normalize: bool = False,
                        rectify_map: Optional[torch.Tensor] = None,
                        tile_offsets: Optional[torch.Tensor] = None,
                        offsets_kind: str = "tile",
                        t_prenormalized: bool = False,
                        layout: str = "nchw", oh_dtype=None,
                        deint: bool = False,
                        resize_width_to: Optional[int] = None,
                        resize_align_corners: bool = True):
    """One batched window of struct-of-arrays events -> (B, C, H, W) grids.
    ``rectify_map`` (an (H, W, 2) tensor on the events' device) rectifies
    the sensor coordinates first (:func:`rectify_events`), for every
    representation, and makes the voxel grid trilinear; host offsets were
    computed on the coordinates before rectification, so a map with any
    offsets raises, as JAX's assert does.
    The ``voxel_grid`` representation runs on the voxelizer that
    ``offsets_kind`` names: ``'band'`` for host-folded records
    (``tile_offsets`` are then the band offsets), ``'tile'`` for raw events
    with host tile offsets or none. ``'histogram'`` and ``'ev_segnet'``
    take raw events and ignore ``num_bins``, ``separate_pol``,
    ``trilinear``, ``normalize`` and any tile offsets, as JAX's branches
    do (EV-SegNet normalizes whatever time it is given over the window,
    ``t_prenormalized`` or not); folded band records (pre-weighted
    polarities) cannot feed them. ``t_prenormalized``: ``t`` is the time
    normalized to [0, num_bins - 1] already. The voxel grid's ``layout``,
    ``oh_dtype``, ``deint`` and (band wire) ``resize_width_to`` are
    :func:`voxelize_band`'s and :func:`voxelize_tile`'s; ``'raw'`` and
    ``'stack'`` need the voxel grid on band records, as JAX asserts, and
    the other representations take ``'nchw'`` or ``'nhwc'``."""
    if representation not in REPRESENTATIONS:
        raise ValueError(f"unknown representation {representation!r}; "
                         f"expected one of {REPRESENTATIONS}")
    if layout in ("raw", "stack") and (representation != "voxel_grid"
                                       or offsets_kind != "band"):
        raise ValueError(f"layout {layout!r} needs the voxel grid on "
                         "pre-folded band records")
    if rectify_map is not None:
        if tile_offsets is not None:
            raise ValueError("host offsets were computed on the coordinates "
                             "before rectification: rectify on the host "
                             "before binning instead")
        x, y = rectify_events(x, y, rectify_map)
        trilinear = True
    if representation != "voxel_grid":
        if offsets_kind == "band":
            raise ValueError(f"the {representation!r} representation takes "
                             "raw events, not folded band records")
        check_layout(layout, ("nchw", "nhwc"))
        if representation == "histogram":
            grid = event_histogram(x, y, p, valid, height=height,
                                   width=width)
        else:
            grid = ev_segnet_grid(x, y, t, p, valid, height=height,
                                  width=width)
        return relayout(grid, layout)
    kw = dict(num_bins=num_bins, height=height, width=width,
              normalize=normalize, t_prenormalized=t_prenormalized,
              layout=layout, oh_dtype=oh_dtype)
    if offsets_kind == "band":
        if tile_offsets is None:
            raise ValueError("band offsets require host binning")
        return voxelize_band(x, y, t, p, valid, tile_offsets,
                             separate_pol=separate_pol, trilinear=trilinear,
                             deint=deint, resize_width_to=resize_width_to,
                             resize_align_corners=resize_align_corners,
                             **kw)
    if offsets_kind != "tile":
        raise ValueError(f"unknown offsets_kind {offsets_kind!r}")
    return voxelize_tile(x, y, t, p, valid, tile_offsets,
                         separate_pol=separate_pol, trilinear=trilinear, **kw)


def voxelize_windows(events: torch.Tensor, valid: torch.Tensor, *,
                     num_bins: int, height: int, width: int,
                     representation: str = "voxel_grid",
                     separate_pol: bool = False, trilinear: bool = False,
                     rectify_map: Optional[torch.Tensor] = None,
                     normalize: bool = False) -> torch.Tensor:
    """(B, T, N, 4) raw events (x, y, t, p) and (B, T, N) validity ->
    (B, T, H, W, C) grids, the JAX package's dense layout: the B*T windows
    in one :func:`voxelize_window_soa` call (the voxel grid on the
    halo-tiled voxelizer, the events tile-sorted on the device), each
    window normalized over itself. The result is a channel-last view of
    channel-first windows: ``permute(0, 1, 4, 2, 3)`` gives them back
    without a copy."""
    grids = flat_windows(events, valid, num_bins=num_bins, height=height,
                         width=width, representation=representation,
                         separate_pol=separate_pol, trilinear=trilinear,
                         rectify_map=rectify_map, normalize=normalize)
    b, t_dim = events.shape[:2]
    return grids.view(b, t_dim, *grids.shape[1:]).permute(0, 1, 3, 4, 2)


def flat_windows(events: torch.Tensor, valid: torch.Tensor,
                 **kw) -> torch.Tensor:
    """(B, T, N, 4) events -> (B*T, C, H, W) grids, sample-major:
    :func:`voxelize_window_soa` over the flattened window axis."""
    n = events.shape[2]
    col = lambda i: events[..., i].reshape(-1, n)
    return voxelize_window_soa(col(0), col(1), col(2), col(3),
                               valid.reshape(-1, n), **kw)
