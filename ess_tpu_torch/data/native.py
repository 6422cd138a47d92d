"""ctypes binding to the framework-free host ingest (native/ess_host.cpp).

The port's own binding: it builds the shared library with ``g++`` into
``build/ess_tpu_torch/`` at the repository root (never next to the source,
where the JAX package keeps its copy), keyed by a hash of the source, and
raises if the build fails. Bound here: the ghost-folded band binning of the
fold-free voxelizer and the tile binning of the halo-tiled one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO, "native", "ess_host.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "ess_tpu_torch")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libess_host_{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build to a private name and rename: concurrent test workers never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build {_SRC}:\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    cdll = ctypes.CDLL(lib_path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_i64 = ctypes.c_int64
    cdll.band_bin_folded_f32.argtypes = [
        f32p, u8p, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64,
        ctypes.c_int, c_i64, c_i64, f32p, u8p, i32p, i64p, f32p, i32p]
    cdll.band_bin_folded_f32.restype = c_i64
    cdll.tile_bin_f32.argtypes = [
        f32p, u8p, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64,
        f32p, u8p, i32p, i64p, i32p]
    cdll.tile_bin_f32.restype = None
    return cdll


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use. Raises if ``g++`` fails."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
    return _lib


def folded_capacity(n: int) -> int:
    """Default record capacity for ghost-folded binning of ``n`` events:
    ghosts are bounded by the events in each band's last row plus the
    x-slot boundary columns; the margin covers heavy spatial skew."""
    return n + n // 8 + n // 64 + 8


def quantize_folded_capacity(needed: int, n: int) -> int:
    """Capacity level for an overflowing window: the next multiple of the
    default margin step above ``needed``, so skewed samples share a small
    set of buffer shapes (every event splits into at most 4 records)."""
    base = max(folded_capacity(n) - n, 1)
    over = needed - n
    return n + -(-over // base) * base


def band_bin_folded(
    raw_windows: np.ndarray, valid: np.ndarray, *, height: int, width: int,
    tile_h: int, trilinear: bool = True, capacity: Optional[int] = None,
    ntx: int = 1, slot_w: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ghost-folded counting sort of (T, N, 4) raw windows by (band, x-slot).

    Returns (records (T, cap2, 4) f32 with pre-weighted polarity, valid
    (T, cap2) bool, offsets (T, n_bands * ntx + 1) i32). Grows to the next
    quantized capacity level when a window overflows the ghost margin.
    """
    lib = get_lib()
    hp = -(-height // tile_h) * tile_h
    n_bands = hp // tile_h
    t_dim, n = raw_windows.shape[:2]
    cap2 = capacity if capacity is not None else folded_capacity(n)
    ev = np.ascontiguousarray(raw_windows, np.float32)
    vd = np.ascontiguousarray(valid, np.uint8)
    n_groups = n_bands * ntx
    while True:
        out = np.empty((t_dim, cap2, 4), np.float32)
        out_valid = np.empty((t_dim, cap2), np.uint8)
        offsets = np.empty((t_dim, n_groups + 1), np.int32)
        counts = np.empty(n_groups, np.int64)
        rec_scratch = np.empty((4 * n, 4), np.float32)
        band_scratch = np.empty(4 * n, np.int32)
        needed = lib.band_bin_folded_f32(
            ev, vd, t_dim, n, cap2, height, width, tile_h, n_bands,
            1 if trilinear else 0, ntx, slot_w, out, out_valid, offsets,
            counts, rec_scratch, band_scratch)
        if needed <= cap2:
            return out, out_valid.astype(bool), offsets
        cap2 = quantize_folded_capacity(int(needed), n)


def tile_bin(
    raw_windows: np.ndarray, valid: np.ndarray, *, height: int, width: int,
    tile_h: int, tile_w: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Counting sort of (T, N, 4) raw windows by spatial tile id.

    Returns (sorted (T, N, 4) f32, valid (T, N) bool, offsets
    (T, n_tiles + 1) i32) on the grid padded to whole ``tile_h x tile_w``
    tiles; events outside the frame or invalid are dropped, the tail is
    zero.
    """
    lib = get_lib()
    hp = -(-height // tile_h) * tile_h
    wp = -(-width // tile_w) * tile_w
    ntx = wp // tile_w
    n_tiles = (hp // tile_h) * ntx
    t_dim, n = raw_windows.shape[:2]
    ev = np.ascontiguousarray(raw_windows, np.float32)
    vd = np.ascontiguousarray(valid, np.uint8)
    out = np.empty_like(ev)
    out_valid = np.empty((t_dim, n), np.uint8)
    offsets = np.empty((t_dim, n_tiles + 1), np.int32)
    counts = np.empty(n_tiles, np.int64)
    tid_scratch = np.empty(n, np.int32)
    lib.tile_bin_f32(ev, vd, t_dim, n, height, width, tile_h, tile_w, ntx,
                     n_tiles, out, out_valid, offsets, counts, tid_scratch)
    return out, out_valid.astype(bool), offsets
