"""8-bit grayscale and RGB PNGs without ``cv2``.

DDD17's segmentation masks and Cityscapes' ``gtFine`` label ids are 8-bit
grayscale PNGs, Cityscapes' ``leftImg8bit`` frames 8-bit RGB ones.
:func:`decode` reads either kind with ``zlib`` and the host C++ of
``csrc/image_host.cpp``, :func:`imread_gray` gives what ``cv2.imread(path,
0)`` gives for both, and :func:`resize_nearest` computes what
``cv2.resize(..., interpolation=cv2.INTER_NEAREST)`` does, so the image
sets run where ``cv2`` is not installed. Palette, 16-bit, alpha and
interlaced PNGs raise ``ValueError``.

Decoding inflates the image data with ``zlib`` and undoes the five PNG
row filters, a row at a time since Up, Average and Paeth read the row
above, in the C++ library, which also holds the arithmetic of
``imgproc.resize_linear``; it is built with ``g++`` on first use
(``native.build_library``) and a failed build raises. The unfilter's plain
version, :func:`unfilter_ref`, does None, Sub (a running sum mod 256, per
channel) and Up in numpy and Average and Paeth, which read the byte just
decoded one pixel to the left, in a Python loop; the tests hold the two
equal.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from ess_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "image_host.cpp")
_CHANNELS = {0: 1, 2: 3}  # PNG color type -> bytes a pixel at 8 bits
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG: no IEND chunk")


def get_lib() -> ctypes.CDLL:
    """The image host library, built on first use. Raises if ``g++``
    fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = native.build_library(_SRC, "libimage_host")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            c_i64 = ctypes.c_int64
            lib.png_unfilter.argtypes = [u8p, c_i64, c_i64, c_i64, u8p, u8p]
            lib.png_unfilter.restype = c_i64
            lib.png_unfilter_gray.argtypes = [u8p, c_i64, c_i64, u8p, u8p,
                                              u8p]
            lib.png_unfilter_gray.restype = c_i64
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.resize_linear_u8.argtypes = [u8p, c_i64, u8p, c_i64, c_i64] \
                + [i32p] * 8
            lib.resize_linear_u8.restype = None
            _lib = lib
    return _lib


def _rows(data: bytes):
    """(rows (H, 1 + W * channels) uint8, each a filter byte and the row's
    filtered bytes; channels) of an 8-bit gray or RGB, non-interlaced PNG
    held in ``data``, inflated by ``zlib``."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"only 8-bit grayscale and RGB PNGs are read: bit "
                         f"depth {depth}, color type {color}")
    if (compression, filt, interlace) != (0, 0, 0):
        raise ValueError("only non-interlaced PNGs with the standard "
                         "compression and filter method are read")
    channels = _CHANNELS[color]
    row_bytes = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"PNG data of {raw.size} bytes for {height} rows of "
                         f"{width} pixels of {channels} bytes")
    return raw.reshape(height, row_bytes + 1), channels


def decode(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit grayscale or RGB PNG held in ``data``: (H, W)
    or (H, W, 3) uint8 in the file's R, G, B order. Other kinds raise
    ``ValueError``."""
    rows, channels = _rows(data)
    out = unfilter(rows, channels)
    return out.reshape(out.shape[0], -1, 3) if channels == 3 else out


def decode_gray8(data: bytes) -> np.ndarray:
    """The (H, W) uint8 pixels of an 8-bit grayscale, non-interlaced PNG
    held in ``data``; any other kind of PNG raises ``ValueError``."""
    img = decode(data)
    if img.ndim != 2:
        raise ValueError("an 8-bit RGB PNG where 8-bit grayscale was asked "
                         "for")
    return img


def rgb_to_gray_ref(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) R, G, B uint8 -> (H, W) uint8 as ``cv2.imread(path, 0)``
    converts an RGB PNG: libpng's truncating 15-bit mix (see
    ``csrc/image_host.cpp``); the plain version of the mix that
    :func:`unfilter_gray` applies."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def imread_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, 0)`` for an 8-bit grayscale or RGB PNG: gray
    pixels as they are, RGB ones through :func:`unfilter_gray`."""
    with open(path, "rb") as f:
        rows, channels = _rows(f.read())
    return unfilter(rows, 1) if channels == 1 else unfilter_gray(rows)


def unfilter_gray(rows: np.ndarray) -> np.ndarray:
    """:func:`unfilter` of RGB ``rows`` (H, 1 + 3 W) with each row turned
    gray as soon as it is unfiltered, in one C++ call: (H, W) uint8, equal
    to ``rgb_to_gray_ref`` of the unfiltered pixels."""
    rows = np.ascontiguousarray(rows, np.uint8)
    height, n = rows.shape[0], rows.shape[1] - 1
    out = np.empty((height, n // 3), np.uint8)
    _check(get_lib().png_unfilter_gray(rows, height, n, out,
                                       np.empty(2 * n, np.uint8),
                                       np.zeros(n, np.uint8)), rows, 3)
    return out


def unfilter(rows: np.ndarray, channels: int) -> np.ndarray:
    """Undo the PNG row filters of ``rows`` (H, 1 + n) uint8, each row its
    filter byte and n filtered bytes, ``channels`` bytes a pixel (1 or 3),
    with the C++ library: (H, n) uint8."""
    rows = np.ascontiguousarray(rows, np.uint8)
    height, n = rows.shape[0], rows.shape[1] - 1
    out = np.empty((height, n), np.uint8)
    _check(get_lib().png_unfilter(rows, height, n, channels, out,
                                  np.zeros(n, np.uint8)), rows, channels)
    return out


def _check(bad: int, rows: np.ndarray, channels: int) -> None:
    """Raise for what the C++ unfilter returned other than 0."""
    if bad < 0:
        raise ValueError(f"PNG pixels of {channels} bytes")
    if bad:
        raise ValueError(f"unknown PNG row filter {int(rows[bad - 1, 0])}")


def unfilter_ref(rows: np.ndarray, channels: int) -> np.ndarray:
    """Plain version of :func:`unfilter` (module docstring); the row above
    the first is zeros, as are the bytes left of each row."""
    height, n = rows.shape[0], rows.shape[1] - 1
    out = np.empty((height, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    for y in range(height):
        k, f = rows[y, 0], rows[y, 1:]
        if k == 0:
            row = f
        elif k == 1:
            row = (np.cumsum(f.reshape(-1, channels), 0, dtype=np.int64)
                   & 255).astype(np.uint8).reshape(-1)
        elif k == 2:
            row = f + prev               # uint8 arithmetic wraps mod 256
        elif k in (3, 4):
            row = np.frombuffer(bytes(
                (_average if k == 3 else _paeth)(f.tolist(), prev.tolist(),
                                                 channels)), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {int(k)}")
        out[y] = row
        prev = out[y]
    return out


def _average(f: list, up: list, bpp: int) -> list:
    row = []
    for i, (fx, b) in enumerate(zip(f, up)):
        a = row[i - bpp] if i >= bpp else 0
        row.append((fx + ((a + b) >> 1)) & 255)
    return row


def _paeth(f: list, up: list, bpp: int) -> list:
    row = []
    for i, (fx, b) in enumerate(zip(f, up)):
        a, c = (row[i - bpp], up[i - bpp]) if i >= bpp else (0, 0)
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row.append((fx + pred) & 255)
    return row


def read_gray8(path: str) -> np.ndarray:
    """``cv2.imread(path, 0)`` for an 8-bit grayscale PNG (module
    docstring); other PNG kinds raise."""
    with open(path, "rb") as f:
        return decode_gray8(f.read())


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``:
    destination pixel x reads source ``floor(x * (1 / (width / src_w)))``,
    in double and clamped to the last column, and the same for rows."""
    src_h, src_w = img.shape[:2]

    def index(dst: int, src: int) -> np.ndarray:
        scale = 1.0 / (dst / src)
        i = np.floor(np.arange(dst, dtype=np.float64) * scale).astype(np.int64)
        return np.minimum(i, src - 1)

    return img[index(height, src_h)[:, None], index(width, src_w)[None, :]]
