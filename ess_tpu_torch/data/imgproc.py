"""The image operations of the sensor-A image sets, in numpy, without cv2.

Each function reproduces one OpenCV call on uint8 images (OpenCV 4.11 and
later, whose warps interpolate in float32), vectorised over the whole image,
and its docstring names the call and the bound it holds against it; the
tests hold every bound on the CPU against ``cv2``:

- :func:`resize_linear`: ``cv2.resize(..., INTER_LINEAR)``, its 11-bit
  fixed-point arithmetic (or the 2x2 mean where OpenCV takes ``INTER_AREA``
  for an exact halving), equal at every pixel; it runs in the C++ of
  ``csrc/image_host.cpp`` (a frame's resize is on the image sets' hot
  path), its numpy plain version is :func:`resize_linear_ref`;
- :func:`warp_affine` and :func:`warp_perspective`: ``cv2.warpAffine`` and
  ``cv2.warpPerspective`` with ``BORDER_CONSTANT`` 0, linear or nearest;
- :func:`perspective_transform`: ``cv2.getPerspectiveTransform``;
- :func:`gaussian_blur`, :func:`box_blur3`, :func:`filter2d3`:
  ``cv2.GaussianBlur(img, (0, 0), 1)``, ``cv2.blur(img, (3, 3))`` and
  ``cv2.filter2D(img, -1, k)`` for a 3x3 ``k``, all with
  ``BORDER_REFLECT_101``, equal at every pixel.

``INTER_NEAREST`` resizing is :func:`ess_tpu_torch.data.png.resize_nearest`.
"""

from __future__ import annotations

import math

import numpy as np

from ess_tpu_torch.data import png

_F32 = np.float32
_F64 = np.float64


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (np.asarray(a, _F64) * np.asarray(b, _F64)
            + np.asarray(c, _F64)).astype(_F32)


def _resize_coefs(dst: int, src: int, clamp: bool):
    """Source indices and 11-bit weights of ``cv2.resize``'s linear
    interpolation along one axis: the source coordinate ``(d + 0.5) *
    scale - 0.5`` rounded to float32, its floor and fraction; along x
    (``clamp``) a coordinate left of the first pixel or right of the last
    reads that pixel alone, along y only the row indices are clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    if clamp:
        f = np.where(s < 0, _F32(0), f)
        s = np.maximum(s, 0)
        last = s >= src - 1
        f = np.where(last, _F32(0), f)
        s = np.where(last, src - 1, s)
    w1 = np.rint(f * 2048).astype(np.int32)
    w0 = np.rint((_F32(1) - f) * 2048).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def _halve(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """OpenCV's ``INTER_AREA`` for an exact halving: the rounded mean of
    each 2x2 block."""
    s = img.reshape(height, 2, width, 2).astype(np.int32).sum((1, 3))
    return ((s + 2) >> 2).astype(np.uint8)


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    for a 2-D uint8 image, equal at every pixel: the arithmetic of
    :func:`resize_linear_ref` in the C++ of ``csrc/image_host.cpp``."""
    src_h, src_w = img.shape
    if (src_h, src_w) == (2 * height, 2 * width):
        return _halve(img, height, width)
    img = np.ascontiguousarray(img, np.uint8)
    coefs = [np.ascontiguousarray(c, np.int32) for c in
             _resize_coefs(width, src_w, True)
             + _resize_coefs(height, src_h, False)]
    out = np.empty((height, width), np.uint8)
    png.get_lib().resize_linear_u8(img, src_w, out, height, width, *coefs)
    return out


def resize_linear_ref(img: np.ndarray, height: int,
                      width: int) -> np.ndarray:
    """Plain version of :func:`resize_linear`, in numpy: a horizontal pass
    of 11-bit weights into int32, then the vertical pass as OpenCV's SIMD
    rows compute it, ``((((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16)
    + 2) >> 2``. An exact halving of both sides is ``INTER_AREA`` there, the
    rounded mean of each 2x2 block."""
    src_h, src_w = img.shape
    if (src_h, src_w) == (2 * height, 2 * width):
        return _halve(img, height, width)
    xs0, xs1, xw0, xw1 = _resize_coefs(width, src_w, True)
    ys0, ys1, yw0, yw1 = _resize_coefs(height, src_h, False)
    rows = np.unique(np.concatenate([ys0, ys1]))
    src = img[rows].astype(np.int32)
    horiz = (src[:, xs0] * xw0 + src[:, xs1] * xw1) >> 4
    r0 = horiz[np.searchsorted(rows, ys0)].astype(np.int64)
    r1 = horiz[np.searchsorted(rows, ys1)].astype(np.int64)
    v = (((r0 * yw0[:, None]) >> 16) + ((r1 * yw1[:, None]) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def _sample(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
            nearest: bool) -> np.ndarray:
    """``img`` read at float32 source coordinates, 0 outside the image:
    the nearest pixel (coordinates rounded half to even), or the bilinear
    mix in float32, ``lerp(b, lerp(a, p00, p01), lerp(a, p10, p11))`` with
    each lerp a fused multiply-add, rounded half to even."""
    h, w = img.shape
    if nearest:
        ix = np.rint(sx).astype(np.int64)
        iy = np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        return np.where(inside, img[np.clip(iy, 0, h - 1),
                                    np.clip(ix, 0, w - 1)], 0).astype(
            img.dtype)
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = (sx - fx).astype(_F32), (sy - fy).astype(_F32)
    ix = np.clip(fx, -1, w).astype(np.int64)
    iy = np.clip(fy, -1, h).astype(np.int64)
    pad = np.pad(img.astype(_F32), 1)   # the zero border, one pixel wide
    px = np.clip(ix + 1, 0, w + 1)
    py = np.clip(iy + 1, 0, h + 1)
    px1, py1 = np.minimum(px + 1, w + 1), np.minimum(py + 1, h + 1)
    p00, p01 = pad[py, px], pad[py, px1]
    p10, p11 = pad[py1, px], pad[py1, px1]
    # a coordinate more than a pixel outside reads the border alone
    far = (fx < -1) | (fx > w) | (fy < -1) | (fy > h)
    top = _fma(a, p01 - p00, p00)
    bottom = _fma(a, p11 - p10, p10)
    v = _fma(b, (bottom - top).astype(_F32), top)
    v = np.where(far, _F32(0), v)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """OpenCV's inverse of a 2x3 affine map, in double."""
    m = np.asarray(m, _F64).reshape(6)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a0, a1, a3, a4 = m[4] * d, -m[1] * d, -m[3] * d, m[0] * d
    return np.array([a0, a1, -a0 * m[2] - a1 * m[5],
                     a3, a4, -a3 * m[2] - a4 * m[5]])


def warp_affine(img: np.ndarray, m: np.ndarray, height: int, width: int, *,
                nearest: bool = False) -> np.ndarray:
    """``cv2.warpAffine(img, m, (width, height), flags=INTER_LINEAR or
    INTER_NEAREST, borderMode=BORDER_CONSTANT, borderValue=0)`` for a 2-D
    uint8 image: ``m`` inverted in double, then per pixel the source
    coordinate ``fma(M0, x, M1 * y + M2)`` in float32 (OpenCV's SIMD
    columns). Nearest: equal at every pixel. Linear: within 1 level, and
    equal but on pixels of the columns that OpenCV leaves to its scalar
    tail (its coordinates round the product there), under 0.1 %."""
    inv = _invert_affine(m).astype(_F32)
    x = np.arange(width, dtype=_F32)[None]
    y = np.arange(height, dtype=_F32)[:, None]
    sx = _fma(inv[0], x, (inv[1] * y + inv[2]).astype(_F32))
    sy = _fma(inv[3], x, (inv[4] * y + inv[5]).astype(_F32))
    return _sample(img, sx, sy, nearest)


def _invert3(m: np.ndarray) -> np.ndarray:
    """OpenCV's closed-form inverse of a 3x3 matrix (``invert``,
    ``DECOMP_LU``), in double."""
    s = np.asarray(m, _F64)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
         - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    d = 1.0 / d if d != 0 else 0.0
    return np.array([
        (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
        (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
        (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d,
        (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
        (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
        (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
        (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
        (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
        (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d])


def warp_perspective(img: np.ndarray, m: np.ndarray, height: int,
                     width: int, *, nearest: bool = False) -> np.ndarray:
    """``cv2.warpPerspective(img, m, (width, height), flags=INTER_LINEAR or
    INTER_NEAREST, borderMode=BORDER_CONSTANT, borderValue=0)`` for a 2-D
    uint8 image: ``m`` inverted in double, then per pixel ``fma(M0, x, M1 *
    y + M2) / fma(M6, x, M7 * y + M8)`` and the same for y, in float32.
    Nearest: equal but on under 0.01 % of pixels (coordinates within a
    float32 rounding of a half). Linear: within 1 level, equal but on
    under 0.1 %."""
    inv = _invert3(m).astype(_F32)
    x = np.arange(width, dtype=_F32)[None]
    y = np.arange(height, dtype=_F32)[:, None]
    den = _fma(inv[6], x, (inv[7] * y + inv[8]).astype(_F32))
    sx = (_fma(inv[0], x, (inv[1] * y + inv[2]).astype(_F32)) / den)
    sy = (_fma(inv[3], x, (inv[4] * y + inv[5]).astype(_F32)) / den)
    return _sample(img, sx.astype(_F32), sy.astype(_F32), nearest)


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)``: the (3, 3) float64 map of
    the four points ``src`` (4, 2) onto ``dst``, ``m[2, 2] = 1``, from the
    same 8x8 linear system solved by LU; within 1e-8 of OpenCV's."""
    src = np.asarray(src, _F64)
    dst = np.asarray(dst, _F64)
    a = np.zeros((8, 8))
    for i, ((x, y), (u, v)) in enumerate(zip(src, dst)):
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
    b = np.concatenate([dst[:, 0], dst[:, 1]])
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _gaussian_taps() -> np.ndarray:
    """OpenCV's 8-bit fixed-point kernel for sigma 1 (7 taps, the size
    ``cvRound(sigma * 3 * 2 + 1) | 1``): the normalized Gaussian scaled by
    256 and rounded outward in with the error carried to the next tap, the
    centre taking what makes the sum 256."""
    k = np.array([math.exp(-(i - 3) ** 2 / 2.0) for i in range(7)])
    k = k / k.sum()
    taps, err = np.zeros(7, np.int64), 0.0
    for i in range(3):
        v = k[i] * 256 + err
        taps[i] = taps[6 - i] = round(v)
        err = v - taps[i]
    taps[3] = 256 - 2 * taps[:3].sum()
    return taps


def gaussian_blur(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), 1.0)`` for a 2-D uint8 image, equal
    at every pixel: OpenCV's bit-exact 8-bit path, a 7-tap integer kernel of
    sum 256 (:func:`_gaussian_taps`) along rows then columns,
    ``BORDER_REFLECT_101``, the result rounded from 16 fraction bits."""
    taps = _gaussian_taps()
    h, w = img.shape
    p = np.pad(img.astype(np.int64), 3, mode="reflect")  # = REFLECT_101
    rows = sum(int(taps[i]) * p[:, i:i + w] for i in range(7))
    cols = sum(int(taps[j]) * rows[j:j + h] for j in range(7))
    return ((cols + (1 << 15)) >> 16).astype(np.uint8)


def box_blur3(img: np.ndarray) -> np.ndarray:
    """``cv2.blur(img, (3, 3))`` for a 2-D uint8 image, equal at every
    pixel: the 3x3 sum with ``BORDER_REFLECT_101``, divided by 9 and
    rounded (a ninth is never a half)."""
    h, w = img.shape
    p = np.pad(img.astype(np.int32), 1, mode="reflect")
    s = sum(p[j:j + h, i:i + w] for j in range(3) for i in range(3))
    return ((2 * s + 9) // 18).astype(np.uint8)


def filter2d3(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` for a 2-D uint8 image and a 3x3
    float32 ``kernel`` (anchor at the centre, ``BORDER_REFLECT_101``): the
    nonzero taps summed in float32 in row-major order, rounded half to even
    and saturated to uint8. Equal at every pixel for the motion-blur
    kernels of the image sets (1/3 on the middle row or column)."""
    kernel = np.asarray(kernel, _F32)
    h, w = img.shape
    p = np.pad(img, 1, mode="reflect").astype(_F32)
    acc = np.zeros((h, w), _F32)
    for j in range(3):
        for i in range(3):
            if kernel[j, i] != 0:
                acc = (acc + kernel[j, i] * p[j:j + h, i:i + w]).astype(_F32)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)
