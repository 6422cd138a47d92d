"""Color reconstruction from a DAVIS346color Bayer event stream, without cv2.

Counterpart of ``ess_tpu/recon/color.py`` (``BAYER_PHASES``,
``bayer_split``, ``shift_image``, ``upsample_color_image``,
``merge_channels_into_color_image``, ``to_uint8``). A DAVIS346color sensor
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
  ``b + 128``) and its lookup tables, built here in float64;
- ``COLOR_BGR2HSV`` / ``COLOR_HSV2BGR`` and ``COLOR_BGR2HLS`` /
  ``COLOR_HLS2BGR`` on 8-bit images (hue in [0, 180)), for
  ``upsample_color_image``'s ``'HSV'`` and ``'HLS'`` lightness
  replacements: :func:`bgr_to_hsv` (OpenCV's integer division tables,
  12-bit shift), :func:`hsv_to_bgr`, :func:`bgr_to_hls` and
  :func:`hls_to_bgr` (OpenCV's f32 arithmetic, its fused multiply-adds
  evaluated exactly in float64 and rounded once, as its x86 build with
  AVX-512 runs them: HSV2BGR truncates to 8 bits in the 32-pixel vector
  blocks of each row and rounds the rest of the row, the others round).
  Each equals ``cv2.cvtColor`` on all 2^24 triples and on frames whose
  rows end in a partial block (``tests/test_torch_color_hsv.py``).
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


_HSV_SHIFT = 12
# the BGR channel each HSV / HLS sector takes from (v, p, q, t) tables
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])
_F32 = np.float32


@functools.lru_cache(maxsize=1)
def _hsv_tables():
    """OpenCV's 8-bit BGR2HSV division tables: 255 << 12 / v and
    180 << 12 / (6 d), rounded half to even."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


def _unit(a: np.ndarray) -> np.ndarray:
    return a.astype(_F32) * _F32(1.0 / 255.0)


def _fma(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` rounded once (the product is exact in f64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(_F32)


def _sector_pick(tabs, sector: np.ndarray) -> np.ndarray:
    return np.take_along_axis(np.stack(tabs, -1), _SECTORS[sector], -1)


def bgr_to_hsv(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, COLOR_BGR2HSV)`` of an 8-bit (..., 3) image."""
    sdiv, hdiv = _hsv_tables()
    b, g, r = (bgr[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


HSV_VECTOR_BLOCK = 32   # pixels of a row in one vector step of HSV2BGR


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` of an 8-bit (..., W, 3) image,
    rows of W pixels."""
    h = (hsv[..., 0].astype(_F32) * _F32(6.0 / 180.0)).astype(_F32)
    s, v = _unit(hsv[..., 1]), _unit(hsv[..., 2])
    whole = np.trunc(h)
    frac = h - whole
    one = _F32(1.0)
    sector = (whole - np.trunc(whole * _F32(1.0 / 6.0)) * 6).astype(np.int64)
    tabs = (v, v * (one - s), v * _fma(-s, frac, one),
            v * _fma(-s, one - frac, one))
    out = _sector_pick(tabs, sector) * _F32(255.0)
    w = hsv.shape[-2]
    vector = np.arange(w) < w // HSV_VECTOR_BLOCK * HSV_VECTOR_BLOCK
    out = np.where(vector[:, None], np.trunc(out), np.rint(out))
    return np.clip(out, 0, 255).astype(np.uint8)


def bgr_to_hls(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, COLOR_BGR2HLS)`` of an 8-bit (..., 3) image."""
    b, g, r = (_unit(bgr[..., k]) for k in range(3))
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff, total = vmax - vmin, vmax + vmin
    light = total * _F32(0.5)
    rmax, gmax = vmax == r, vmax == g
    dh = np.where(rmax, g - b, np.where(gmax, b - r, r - g))
    base = np.where(rmax, np.where(g < b, _F32(360.0), _F32(0.0)),
                    np.where(gmax, _F32(120.0), _F32(240.0)))
    with np.errstate(divide="ignore", invalid="ignore"):  # grays: masked
        sat = diff / np.where(light < _F32(0.5), total, _F32(2.0) - total)
        hue = _fma(dh, _F32(60.0) / diff, base) * _F32(0.5)
    some = diff > np.finfo(np.float32).eps
    hue, sat = np.where(some, hue, 0), np.where(some, sat, 0)
    return np.clip(np.rint(np.stack([hue, light * _F32(255.0),
                                     sat * _F32(255.0)], -1)),
                   0, 255).astype(np.uint8)


def hls_to_bgr(hls: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hls, COLOR_HLS2BGR)`` of an 8-bit (..., 3) image."""
    h = (hls[..., 0].astype(_F32) * _F32(6.0 / 180.0)).astype(_F32)
    light, s = _unit(hls[..., 1]), _unit(hls[..., 2])
    whole = np.trunc(h)
    frac = h - whole
    one = _F32(1.0)
    sector = (whole - np.trunc(h * _F32(1.0 / 6.0)) * 6).astype(np.int64)
    p2 = np.where(light <= _F32(0.5), light * (one + s),
                  (light + s) - light * s)
    p1 = _F32(2.0) * light - p2
    d = p2 - p1
    tabs = (p2, p1, p1 + d * (one - frac), p1 + d * frac)
    out = np.where((s == 0)[..., None], light[..., None],
                   _sector_pick(tabs, sector))
    return np.clip(np.rint(out * _F32(255.0)), 0, 255).astype(np.uint8)


# colorspace -> (to, from, the lightness channel)
_LIGHTNESS = {"LAB": (bgr_to_lab, lab_to_bgr, 0),
              "HSV": (bgr_to_hsv, hsv_to_bgr, 2),
              "HLS": (bgr_to_hls, hls_to_bgr, 1)}


def upsample_color_image(grayscale_highres: np.ndarray,
                         color_lowres_bgr: np.ndarray,
                         colorspace: str = "LAB") -> np.ndarray:
    """Replace the lightness of a BGR uint8 color image with a grayscale
    image of the same size: the L channel of ``'LAB'`` or ``'HLS'``, the V
    channel of ``'HSV'``."""
    if grayscale_highres.ndim != 2:
        raise ValueError("grayscale_highres must be (H, W)")
    if color_lowres_bgr.ndim != 3 or color_lowres_bgr.shape[2] != 3:
        raise ValueError("color_lowres_bgr must be (H, W, 3)")
    if colorspace not in _LIGHTNESS:
        raise ValueError(f"unknown colorspace {colorspace!r}")
    to, back, ch = _LIGHTNESS[colorspace]
    img = to(color_lowres_bgr)
    img[:, :, ch] = grayscale_highres
    return back(img)


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


def merge_move_bound(b_min: int = 0) -> Dict[str, int]:
    """The largest move, in levels, of a value of
    :func:`merge_channels_into_color_image`'s output that a one-level move
    of one value of one of its input frames (a half-resolution R, G, W or
    B frame, or the full-resolution gray one) can cause. Returns the parts
    and their maximum, ``"bound"``:

    - ``"resize"``: the 2x linear resize moves an upsampled value by at
      most this much (a scan of seeded one-level moves); ``"green"``: the
      G and W mean, over all 256^2 pairs. Both are 1, so a phase frame's
      move moves one of the B, G, R values the Lab conversion reads by at
      most one level;
    - ``"color"``: the 8-bit Lab round trip with the lightness replaced:
      the output's largest move when one of B, G, R moves by one level,
      over every one of the 2^24 BGR triples (or those with B >= ``b_min``,
      a scan an eighth as long at 224 that finds the same maxima) and
      every gray level;
    - ``"gray"``: its largest move when the gray level moves by one, over
      the (a, b) of those triples.
    """
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (64, 9, 12), np.uint8)
    moved = frames.copy()
    at = (np.arange(64), rng.integers(0, 9, 64), rng.integers(0, 12, 64))
    moved[at] = np.where(frames[at] < 255, frames[at] + 1, frames[at] - 1)
    resize = max(int(np.abs(resize_linear(f, 18, 24).astype(np.int16)
                            - resize_linear(m, 18, 24)).max())
                 for f, m in zip(frames, moved))
    g = np.arange(256, dtype=np.float32)
    mean = np.rint((g[:, None] + g[None, :]) * np.float32(0.5))
    green = int(np.abs(np.diff(mean, axis=0)).max())

    v = np.arange(256, dtype=np.uint8)
    cube = np.stack(np.meshgrid(v[b_min:], v, v, indexing="ij"), -1)
    lab = bgr_to_lab(cube).astype(np.uint32)
    codes = lab[..., 1] * 256 + lab[..., 2]          # (a, b) of (B, G, R)
    del cube, lab
    # (a, b) before and after a one-level move of B, G or R; every (a, b)
    # of a triple is in some pair
    pairs = np.unique(np.concatenate([
        (np.take(codes, np.arange(n - 1), ax) * 65536
         + np.take(codes, np.arange(1, n), ax)).ravel()
        for ax, n in enumerate(codes.shape)]))
    cols, inv = np.unique(np.concatenate([pairs // 65536, pairs % 65536]),
                          return_inverse=True)
    p0, p1 = inv[:len(pairs)], inv[len(pairs):]
    grid = np.empty((256, len(cols), 3), np.uint8)
    grid[..., 0] = v[:, None]
    grid[..., 1], grid[..., 2] = cols // 256, cols % 256
    table = lab_to_bgr(grid).astype(np.int16)       # (L, (a, b), BGR)
    color = 0
    for i in range(0, len(pairs), 1 << 16):
        sl = slice(i, i + (1 << 16))
        color = max(color, int(np.abs(table[:, p0[sl]]
                                      - table[:, p1[sl]]).max()))
    gray = int(np.abs(np.diff(table, axis=0)).max())
    return {"resize": resize, "green": green, "color": color, "gray": gray,
            "bound": max(color, gray) if max(resize, green) <= 1 else -1}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """A [0, 1] float frame -> uint8 (clip, times 255, truncate)."""
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
