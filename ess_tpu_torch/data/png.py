"""8-bit grayscale PNG masks without ``cv2``.

DDD17's segmentation masks are 8-bit grayscale PNGs. :func:`read_gray8`
decodes such a file with ``zlib`` and numpy, and :func:`resize_nearest`
computes what ``cv2.resize(..., interpolation=cv2.INTER_NEAREST)`` does, so
the DDD17 loader runs where ``cv2`` is not installed.

Decoding undoes the five PNG row filters, a row at a time since Up,
Average and Paeth read the row above: None, Sub (a running sum mod 256)
and Up in numpy, Average and Paeth, which read the pixel just decoded to
their left, in a Python loop over the row's pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG: no IEND chunk")


def decode_gray8(data: bytes) -> np.ndarray:
    """The (H, W) uint8 pixels of an 8-bit grayscale, non-interlaced PNG
    held in ``data``; any other kind of PNG raises ``ValueError``."""
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
    if (depth, color) != (8, 0):
        raise ValueError(f"only 8-bit grayscale PNGs are read: bit depth "
                         f"{depth}, color type {color}")
    if (compression, filt, interlace) != (0, 0, 0):
        raise ValueError("only non-interlaced PNGs with the standard "
                         "compression and filter method are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width + 1):
        raise ValueError(f"PNG data of {raw.size} bytes for {height} rows of "
                         f"{width} pixels")
    rows = raw.reshape(height, width + 1)
    kinds, filtered = rows[:, 0], rows[:, 1:]
    if (kinds > 4).any():
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    return _unfilter(kinds, filtered)


def _unfilter(kinds: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the row filters row by row (module docstring); the row above
    the first is zeros, as is the pixel left of each row."""
    height, width = filtered.shape
    out = np.empty((height, width), np.uint8)
    prev = np.zeros(width, np.uint8)
    for y in range(height):
        f, k = filtered[y], kinds[y]
        if k == 0:
            row = f
        elif k == 1:
            row = (np.cumsum(f, dtype=np.int64) & 255).astype(np.uint8)
        elif k == 2:
            row = f + prev               # uint8 arithmetic wraps mod 256
        else:
            row = np.frombuffer(bytes(
                (_average if k == 3 else _paeth)(f.tolist(), prev.tolist())),
                np.uint8)
        out[y] = row
        prev = out[y]
    return out


def _average(f: list, up: list) -> list:
    row, a = [], 0
    for fx, b in zip(f, up):
        a = (fx + ((a + b) >> 1)) & 255
        row.append(a)
    return row


def _paeth(f: list, up: list) -> list:
    row, a, c = [], 0, 0
    for fx, b in zip(f, up):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a, c = (fx + pred) & 255, b
        row.append(a)
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
