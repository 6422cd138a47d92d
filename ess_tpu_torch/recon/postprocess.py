"""Reconstruction post-processing: tone mapping, sharpening, filtering.

Counterpart of ``ess_tpu/recon/postprocess.py``. The device ops run as
tensor ops on the frames' device, on NCHW tensors where JAX's take NHWC:

- ``robust_min`` / ``robust_max``: percentiles with linear interpolation
  between the two nearest ranks (``kthvalue``), in ``jnp.percentile``'s
  f32 expressions, so equal to JAX's at any size (``torch.quantile``
  interpolates in another form and takes at most 2^24 elements);
- ``rescale_intensity``: [imin, imax] -> [0, 1], clipped, with the 8-bit
  truncation round trip (``floor`` then / 255);
- ``IntensityRescaler``: fixed bounds, or auto-HDR percentile bounds
  smoothed by the median of the last ``median_filter_size`` frames' bounds
  (a ``deque`` on the host);
- ``gaussian_kernel`` and ``unsharp_mask``: an edge-replicate pad and a
  depthwise conv, ``(img + a * (img - blur)) / (1 + a)``;
- ``zero_hot_pixels``: (x, y) hot pixels zeroed in every channel.

``bilateral_filter`` runs on the host without cv2: a numpy emulation of
the 8-bit ``cv2.bilateralFilter(img8, 5, 25 sigma, 25 sigma)`` that JAX's
calls, as OpenCV's x86 build computes it (through Intel IPP): the 13-tap
disc of radius 2, space weights ``float(exp(r^2 gs))`` and a color lookup
table ``float(exp(d^2 gc))`` (``g = -1 / (2 (25 sigma)^2)``), reflect-101
borders, f32 sums of ``v * w`` and ``w`` in tap order, and ``sum / wsum``
truncated, except on the two outer columns of each side outside the two
outer rows of each end, which IPP rounds. On pixels where ``sum / wsum``
lies within f32 rounding of an integer, IPP's arithmetic (not reproduced)
can land one level lower (``tests/test_torch_postprocess.py`` states the
bound).
"""

from __future__ import annotations

from collections import deque
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

def _percentile(img: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of all of ``img``'s values: the two nearest
    ranks of ``pos = q * f32(0.01) * (n - 1)`` weighted ``1 - frac`` and
    ``frac``, all in f32, as XLA evaluates ``jnp.percentile``: its
    division by 100 becomes a product with the reciprocal, and the high
    rank's product is fused into the sum (rounded once; exact in f64)."""
    x = img.reshape(-1).float()
    n = x.numel()
    pos = np.float32(q) * np.float32(0.01) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    v_low = torch.kthvalue(x, int(np.clip(low, 0, n - 1)) + 1).values
    v_high = torch.kthvalue(x, int(np.clip(high, 0, n - 1)) + 1).values
    low_part = v_low * float(np.float32(1) - w_high)
    return (v_high.double() * float(w_high) + low_part.double()).float()


def robust_min(img: torch.Tensor, top_percent: float = 5.0) -> torch.Tensor:
    return _percentile(img, top_percent)


def robust_max(img: torch.Tensor, top_percent: float = 95.0) -> torch.Tensor:
    return _percentile(img, top_percent)


def rescale_intensity(img: torch.Tensor, imin=0.0, imax=1.0) -> torch.Tensor:
    """[imin, imax] -> [0, 1], clipped, through the 8-bit truncation:
    ``floor(clip(255 (img - imin) / max(imax - imin, 1e-9))) / 255``."""
    num = 255.0 * (img - imin)
    # a true division, as JAX's: torch multiplies by the reciprocal of a
    # scalar divisor, which moves values across the floor
    den = torch.full((), max(imax - imin, 1e-9), dtype=num.dtype,
                     device=num.device).expand_as(num)
    return torch.floor(torch.clamp(num / den, 0.0, 255.0)) / 255.0


class IntensityRescaler:
    """Intensity rescaling by fixed bounds, or by auto-HDR bounds: each
    frame's ``percentile`` and ``100 - percentile`` percentiles, smoothed by
    the median over the last ``median_filter_size`` frames."""

    def __init__(self, auto_hdr: bool = False, imin: float = 0.0,
                 imax: float = 1.0, median_filter_size: int = 10,
                 percentile: float = 5.0):
        self.auto_hdr = auto_hdr
        self.imin, self.imax = imin, imax
        self.percentile = percentile
        self._mins: deque = deque(maxlen=median_filter_size)
        self._maxs: deque = deque(maxlen=median_filter_size)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        imin, imax = self.imin, self.imax
        if self.auto_hdr:
            self._mins.append(float(robust_min(img, self.percentile)))
            self._maxs.append(float(robust_max(img, 100 - self.percentile)))
            imin = float(np.median(self._mins))
            imax = float(np.median(self._maxs))
        return rescale_intensity(img, imin, imax)


def gaussian_kernel(size: int = 5, sigma: float = 1.0, *,
                    device=None) -> torch.Tensor:
    """(size, size) f32 gaussian kernel summing to 1."""
    x = torch.arange(size, dtype=torch.float32, device=device) - (
        size - 1) / 2.0
    g1 = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    k = torch.outer(g1, g1)
    return k / k.sum()


def unsharp_mask(img: torch.Tensor, amount: float = 0.3, sigma: float = 1.0,
                 size: int = 5) -> torch.Tensor:
    """``(img + amount (img - blur(img))) / (1 + amount)`` of (B, C, H, W)
    images, the blur a gaussian over an edge-replicated border."""
    c = img.shape[1]
    pad = size // 2
    k = gaussian_kernel(size, sigma, device=img.device).to(img.dtype)
    blurred = F.conv2d(F.pad(img, (pad, pad, pad, pad), mode="replicate"),
                       k.expand(c, 1, size, size), groups=c)
    return (img + amount * (img - blurred)) / (1.0 + amount)


def zero_hot_pixels(events: torch.Tensor,
                    hot_pixels: Sequence) -> torch.Tensor:
    """Zero the (x, y) ``hot_pixels`` of (B, C, H, W) event tensors in
    every channel; pixels outside the frame are ignored."""
    if len(hot_pixels) == 0:
        return events
    h, w = events.shape[-2:]
    mask = np.ones((h, w), np.float32)
    for x, y in np.asarray(hot_pixels, np.int64):
        if 0 <= y < h and 0 <= x < w:
            mask[y, x] = 0.0
    return events * torch.from_numpy(mask).to(events.device)


RADIUS = 2    # cv2.bilateralFilter(d=5)


def bilateral_quotients(img8: np.ndarray, sigma: float) -> np.ndarray:
    """``sum / wsum`` (f32) of the 8-bit bilateral filter of diameter 5
    with ``sigma_color = sigma_space = sigma`` at every pixel, before its
    conversion to 8 bits (module docstring)."""
    gc = -0.5 / (sigma * sigma)
    lut = np.exp(np.arange(256, dtype=np.float64) ** 2 * gc).astype(
        np.float32)
    h, w = img8.shape
    padded = np.pad(img8.astype(np.int32), RADIUS, mode="reflect")
    center = img8.astype(np.int32)
    s = np.zeros((h, w), np.float32)
    ws = np.zeros((h, w), np.float32)
    for i in range(-RADIUS, RADIUS + 1):
        for j in range(-RADIUS, RADIUS + 1):
            r = np.sqrt(float(i * i + j * j))
            if r > RADIUS:
                continue
            sw = np.float32(np.exp(r * r * gc))
            v = padded[RADIUS + i:RADIUS + i + h, RADIUS + j:RADIUS + j + w]
            wt = sw * lut[np.abs(v - center)]
            ws += wt
            s += v.astype(np.float32) * wt
    return s / ws


def _bilateral8(img8: np.ndarray, sigma: float) -> np.ndarray:
    """:func:`bilateral_quotients` in 8 bits: truncated, rounded on the
    outer columns outside the outer rows."""
    q = bilateral_quotients(img8, sigma)
    h, w = q.shape
    out = q.astype(np.uint8)                       # truncation
    rows = slice(RADIUS, h - RADIUS)
    cols = [*range(RADIUS), *range(w - RADIUS, w)]
    out[rows, cols] = np.floor(q[rows, cols] + np.float32(0.5)).astype(
        np.uint8)
    return out


def bilateral_filter(img_hw: np.ndarray, sigma: float = 0.0) -> np.ndarray:
    """Host bilateral filter of an (H, W) frame in [0, 1]: the identity at
    ``sigma <= 0``, else the frame in 8 bits filtered with ``25 sigma``
    color and space widths, back in [0, 1] as f32."""
    if sigma <= 0:
        return img_hw
    img8 = (np.clip(img_hw, 0, 1) * 255).astype(np.uint8)
    return _bilateral8(img8, 25.0 * sigma).astype(np.float32) / 255.0
