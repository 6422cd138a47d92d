"""Event windows -> the normalized model input, in plain PyTorch (f32).

Written from the ESS event representation: each window's timestamps are
scaled to [0, bins - 1] over its own events; every event deposits its
signed polarity (+1 / -1) into the 8 (bin, row, column) corners around it,
each weighted by (1 - |distance|) along the three axes; corners outside the
grid are dropped. Integer-coordinate sensors (DDD17) deposit at their pixel,
split between two time bins only. Each window is then standardized over its
nonzero cells (mean 0, biased std 1, zeros kept), at sensor resolution; the
bottom rows are cropped, and where the configuration resizes (DDD17's 346 ->
352 width) the window is resized bilinearly with aligned corners.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def voxel_grid(ev: torch.Tensor, *, bins: int, height: int, width: int,
               integer: bool) -> torch.Tensor:
    """(W, N, 4) windows of (x, y, t, p) events -> (W, bins, H, W) f32."""
    ev = ev.float()
    x, y, t, p = ev.unbind(-1)
    t0 = t.amin(dim=1, keepdim=True)
    t1 = t.amax(dim=1, keepdim=True)
    span = torch.where(t1 - t0 <= 0, torch.ones_like(t0), t1 - t0)
    ts = (bins - 1) * (t - t0) / span
    pol = torch.where(p > 0, 1.0, -1.0)
    if integer:
        x, y = torch.floor(x), torch.floor(y)
    x0, y0, tb0 = torch.floor(x), torch.floor(y), torch.floor(ts)
    nw = ev.shape[0]
    cells = height * width
    base = (torch.arange(nw, device=ev.device) * bins * cells)[:, None]
    flat = torch.zeros(nw * bins * cells, dtype=torch.float32,
                       device=ev.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dt in (0, 1):
                xl, yl, tl = x0 + dx, y0 + dy, tb0 + dt
                ok = ((xl >= 0) & (xl < width) & (yl >= 0) & (yl < height)
                      & (tl >= 0) & (tl < bins))
                w = (pol * (1 - (xl - x).abs()) * (1 - (yl - y).abs())
                     * (1 - (tl - ts).abs()))
                idx = base + (tl.long() * cells + yl.long() * width
                              + xl.long())
                flat.index_add_(0, idx[ok], w[ok])
    return flat.view(nw, bins, height, width)


def normalize_nonzero(grid: torch.Tensor) -> torch.Tensor:
    """Standardize each window's nonzero cells (biased std; zeros stay
    zero; an all-zero window or one of zero spread is left as it is)."""
    nz = grid != 0
    n = nz.sum(dim=(1, 2, 3), keepdim=True).float()
    mean = grid.sum(dim=(1, 2, 3), keepdim=True) / n.clamp(min=1)
    var = (grid * grid).sum(dim=(1, 2, 3), keepdim=True) / n.clamp(min=1) \
        - mean * mean
    std = var.clamp(min=0).sqrt()
    std = torch.where(std > 0, std, torch.ones_like(std))
    out = torch.where(nz, (grid - mean) / std, torch.zeros_like(grid))
    return torch.where(n > 0, out, grid)


def model_input(ev: torch.Tensor, *, bins: int, sensor: Tuple[int, int],
                crop_bottom: int, integer: bool,
                resize_to: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(W, N, 4) windows -> (W, bins, H, W) normalized, cropped (and
    resized) f32 windows, as the model reads them."""
    h, w = sensor
    grid = normalize_nonzero(voxel_grid(ev, bins=bins, height=h, width=w,
                                        integer=integer))
    grid = grid[:, :, :h - crop_bottom]
    if resize_to is not None and tuple(resize_to) != tuple(grid.shape[2:]):
        grid = F.interpolate(grid, size=tuple(resize_to), mode="bilinear",
                             align_corners=True)
    return grid
