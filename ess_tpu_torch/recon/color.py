"""Color reconstruction from a DAVIS346color Bayer event stream, without cv2.

Counterpart of ``ess_tpu/recon/color.py`` (``BAYER_PHASES``,
``bayer_split``, ``shift_image``, ``upsample_color_image``,
``merge_channels_into_color_image``). A DAVIS346color sensor
has an RGBW Bayer mosaic: pixel (2i+r, 2j+s) sees color [R G; W B][r][s], so
slicing the normalized full-resolution voxel grid at the four 2x2 phases
yields one half-resolution event stream per color; the reconstruction
program runs the four through one grayscale network as a batch of 4 and
merges the four half-resolution frames with the full-resolution gray one
here, on the host.

The cv2 calls of the JAX module are reproduced on uint8 images, equal at
every pixel (the tests hold the Lab conversions against ``cv2`` over all
2^24 triples and the merge against the JAX module's):

- ``cv2.resize(fx=2, fy=2, INTER_LINEAR)``: :func:`ess_tpu_torch.data.
  imgproc.resize_linear`;
- ``cv2.addWeighted(g, 0.5, w, 0.5, 0, dtype=CV_8U)``: ``(g + w) * 0.5``
  rounded half to even;
- ``cv2.cvtColor(..., COLOR_BGR2LAB)`` and ``COLOR_LAB2BGR`` on 8-bit
  images: :func:`bgr_to_lab` and :func:`lab_to_bgr`, OpenCV's fixed-point
  arithmetic (sRGB gamma, D65 white, ``L * 255 / 100``, ``a + 128``,
  ``b + 128``) and its lookup tables, built here in float64.

The ``'HSV'`` and ``'HLS'`` lightness replacements are not ported (no entry
point uses them) and raise.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from ess_tpu_torch.data.imgproc import resize_linear

# Bayer phase of each color channel: channel -> (row offset, col offset).
BAYER_PHASES = {"R": (0, 0), "G": (0, 1), "W": (1, 0), "B": (1, 1)}

# OpenCV's fixed-point Lab constants (color_lab.cpp)
_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_BASE = 1 << 14
_MIN_AB = -8145
_SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                         [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]])
_XYZ_TO_SRGB = np.array([[3.240479, -1.53715, -0.498535],
                         [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])
_D65 = np.array([0.950456, 1.0, 1.088754])


def bayer_split(grid):
    """(..., H, W) grid (numpy or torch) -> {'R', 'G', 'W', 'B': (..., H/2,
    W/2)} phases. The JAX function slices an (H, W, C) grid; the port's
    grids are NCHW, so the phases are sliced from the last two axes."""
    return {ch: grid[..., r::2, s::2] for ch, (r, s) in BAYER_PHASES.items()}


def shift_image(x: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Roll by (dy, dx) with edge-replicated borders."""
    x = np.roll(x, dy, axis=0)
    x = np.roll(x, dx, axis=1)
    if dy > 0:
        x[:dy, :] = x[dy, :][None]
    elif dy < 0:
        x[dy:, :] = x[dy, :][None]
    if dx > 0:
        x[:, :dx] = x[:, dx][:, None]
    elif dx < 0:
        x[:, dx:] = x[:, dx][:, None]
    return x


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _cbrt_f32_down(x: np.ndarray) -> np.ndarray:
    """The cube root of float32 ``x`` rounded toward zero to float32 (what
    OpenCV's table of it holds: at the four entries where the two
    roundings differ, a round to nearest disagrees with cv2)."""
    exact = np.cbrt(x.astype(np.float64))
    r = exact.astype(np.float32)
    return np.where(r.astype(np.float64) > exact,
                    np.nextafter(r, np.float32(0)), r)


@functools.cache
def _to_lab_tables():
    """(gamma table (256,), cube-root table (3072,), coefficients (3, 3)
    rows X, Y, Z over R, G, B) of OpenCV's 8-bit BGR -> Lab."""
    f32 = np.float32
    x = np.arange(256) / 255.0
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(255 * (1 << _GAMMA_SHIFT) * gamma).astype(np.int64)
    n = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)
    xs = (f32(1) / (f32(255) * f32(1 << _GAMMA_SHIFT))
          * np.arange(n, dtype=f32)).astype(f32)
    linear = (xs.astype(np.float64) * (f32(841) / f32(108))
              + (f32(16) / f32(116))).astype(f32)
    f = np.where(xs < f32(216) / f32(24389), linear, _cbrt_f32_down(xs))
    cbrt_tab = np.rint(f.astype(np.float64) * (1 << _LAB_SHIFT2)).astype(
        np.int64)
    coefs = np.rint((1 << _LAB_SHIFT) * _SRGB_TO_XYZ
                    / _D65[:, None]).astype(np.int64)
    for t in (gamma_tab, cbrt_tab, coefs):
        t.flags.writeable = False
    return gamma_tab, cbrt_tab, coefs


def bgr_to_lab(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, cv2.COLOR_BGR2LAB)`` for uint8 (..., 3) images:
    linearized channels from the gamma table, XYZ over the white point in
    12-bit fixed point, f(t) from the cube-root table, then ``L = (296 fY
    - 1336934) >> 15``, ``a = 500 (fX - fY) + 128``, ``b = 200 (fY - fZ)
    + 128`` in 15-bit fixed point, rounded and saturated."""
    gamma_tab, cbrt_tab, coefs = _to_lab_tables()
    rgb = gamma_tab[bgr[..., ::-1].astype(np.int64)]
    fx, fy, fz = (cbrt_tab[_descale(rgb @ coefs[i], _LAB_SHIFT)]
                  for i in range(3))
    lscale = (116 * 255 + 50) // 100
    lshift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    mid = 128 * (1 << _LAB_SHIFT2)
    lab = np.stack([_descale(lscale * fy + lshift, _LAB_SHIFT2),
                    _descale(500 * (fx - fy) + mid, _LAB_SHIFT2),
                    _descale(200 * (fy - fz) + mid, _LAB_SHIFT2)], -1)
    return np.clip(lab, 0, 255).astype(np.uint8)


@functools.cache
def _from_lab_tables():
    """(L -> (y, f(y)) table (256, 2), f -> x or z table from ``_MIN_AB``,
    inverse gamma table (4096,), coefficients (3, 3) rows R, G, B over X,
    Y, Z) of OpenCV's 8-bit Lab -> BGR, at 14-bit fixed point."""
    i = np.arange(256)
    fy = i * 100 * _BASE / (255 * 116.0) + 16 * _BASE / 116.0
    low = i <= 20   # L <= 8: the linear segment
    yf = np.stack([
        np.where(low, np.rint(i * _BASE * 180 / 414613.0),
                 np.rint(fy * fy * fy / (_BASE * _BASE))),
        np.where(low, np.rint(_BASE * (16 / 116 + i * 5 / 1479.0)),
                 np.rint(fy))], -1).astype(np.int64)
    k = np.arange(_MIN_AB, 3 * _BASE)
    # C's integer division, which truncates toward zero
    lin = (np.sign(k) * (np.abs(k) * 108 // 841)
           - (_BASE * 16 // 116) * 108 // 841)
    xz = np.where(k <= 3390, lin, (k * k // _BASE) * k // _BASE)
    x = np.arange(4096) / 4096.0
    inv = np.where(x <= 0.0031308, x * 12.92,
                   1.055 * x ** (1 / 2.4) - 0.055)
    inv_tab = np.rint(255 * inv).astype(np.int64)
    coefs = np.rint((1 << _LAB_SHIFT) * _XYZ_TO_SRGB
                    * _D65[None, :]).astype(np.int64)
    for t in (yf, xz, inv_tab, coefs):
        t.flags.writeable = False
    return yf, xz, inv_tab, coefs


def lab_to_bgr(lab: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(lab, cv2.COLOR_LAB2BGR)`` for uint8 (..., 3) images:
    y and f(y) from the L table, f(x) = f(y) + a / 500 and f(z) = f(y) -
    b / 200 in 14-bit fixed point, x and z from the inverse-f table, linear
    R, G, B at 12 bits, then the inverse gamma table."""
    yf, xz, inv_tab, coefs = _from_lab_tables()
    lab = lab.astype(np.int64)
    y, ify = yf[lab[..., 0], 0], yf[lab[..., 0], 1]
    adiv = ((5 * lab[..., 1] * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((lab[..., 2] * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    xyz = np.stack([xz[ify + adiv - _MIN_AB], y, xz[ify - bdiv - _MIN_AB]],
                   -1)
    shift = _LAB_SHIFT + 2   # 14-bit XYZ times 12-bit coefficients -> 12 bits
    out = [inv_tab[np.clip(_descale(xyz @ coefs[row], shift), 0, 4095)]
           for row in (2, 1, 0)]
    return np.stack(out, -1).astype(np.uint8)


def upsample_color_image(grayscale_highres: np.ndarray,
                         color_lowres_bgr: np.ndarray,
                         colorspace: str = "LAB") -> np.ndarray:
    """Replace the lightness of a BGR uint8 color image with a grayscale
    image of the same size (the Lab L channel)."""
    if grayscale_highres.ndim != 2:
        raise ValueError("grayscale_highres must be (H, W)")
    if color_lowres_bgr.ndim != 3 or color_lowres_bgr.shape[2] != 3:
        raise ValueError("color_lowres_bgr must be (H, W, 3)")
    if colorspace in ("HSV", "HLS"):
        raise NotImplementedError(
            f"colorspace {colorspace!r}: only 'LAB' is ported (ROADMAP.md, "
            "A15)")
    if colorspace != "LAB":
        raise ValueError(f"unknown colorspace {colorspace!r}")
    lab = bgr_to_lab(color_lowres_bgr)
    lab[:, :, 0] = grayscale_highres
    return lab_to_bgr(lab)


def merge_channels_into_color_image(channels: Dict[str, np.ndarray]
                                    ) -> np.ndarray:
    """Full-res grayscale + four half-res RGBW uint8 reconstructions ->
    full-res BGR uint8 image: bilinear x2 upsample per channel, origin
    shifts B (1, 1), G (1, 0), W (0, 1), green = mean(G, W), Lab lightness
    replacement."""
    for key in ("R", "G", "W", "B", "grayscale"):
        if key not in channels:
            raise KeyError(key)
    up = {ch: resize_linear(channels[ch], 2 * channels[ch].shape[0],
                            2 * channels[ch].shape[1])
          for ch in ("R", "G", "W", "B")}
    up["B"] = shift_image(up["B"], dx=1, dy=1)
    up["G"] = shift_image(up["G"], dx=1, dy=0)
    up["W"] = shift_image(up["W"], dx=0, dy=1)
    green = np.rint((up["G"].astype(np.float32) + up["W"]) * np.float32(0.5))
    reconstruction_bgr = np.dstack([up["B"], green.astype(np.uint8), up["R"]])
    return upsample_color_image(channels["grayscale"], reconstruction_bgr)
