"""ctypes binding to the framework-free host ingest (native/ess_host.cpp).

The port's own binding: it builds the shared library with ``g++`` into
``build/ess_tpu_torch/`` at the repository root (never next to the source,
where the JAX package keeps its copy), keyed by a hash of the source, and
raises if the build fails. Bound here: the host voxelizers
(:func:`voxelize_host`, trilinear and temporal-bilinear grids built on the
CPU), the ghost-folded band binning of the
fold-free voxelizer and the tile binning of the halo-tiled one, the fused
DSEC ingests (rectify + per-window time re-zero + one of the two binnings,
in one pass over the raw event columns) on the f32 wire and on the packed
u16 wire, the gather-pad of event windows, a vectorized ``searchsorted``
and the gather-pad straight from DDD17's memmap layout (int64 times, int16
x, y, p).

The packed wire carries an event (or a folded record) in 7 bytes instead
of 16-17: x and y in 1/``COORD_SCALE`` pixel steps (u16), the time already
normalized over its window to [0, 1] in 1/``TIME_SCALE`` steps (u16) and
the polarity (u8 0/1 on the tile wire; on the folded wire the
pre-weighted polarity in 1/``POL_SCALE`` steps, i8). Validity follows
from the offsets: a window's first ``offsets[-1]`` entries are its events.

The contracts are those of ``ess_tpu/data/native.py``, except that nothing
returns ``None``: without the library every entry point raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, Optional

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO, "native", "ess_host.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "ess_tpu_torch")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_library(src: str, stem: str) -> ctypes.CDLL:
    """Build ``src`` (C++ with a plain C interface) with ``g++ -O3`` into
    ``BUILD_DIR/<stem>_<digest of the source>.so``, unless that library is
    there already, and load it. Raises if ``g++`` fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build to a private name and rename: concurrent test workers never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build {src}:\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(lib_path)


def _build() -> ctypes.CDLL:
    cdll = build_library(_SRC, "libess_host")
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
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    cdll.voxelize_trilinear_f32.argtypes = [f32p, u8p, c_i64, c_i64, c_i64,
                                            c_i64, f32p]
    cdll.voxelize_trilinear_f32.restype = None
    cdll.voxelize_temporal_f32.argtypes = [f32p, u8p, c_i64, c_i64, c_i64,
                                           c_i64, ctypes.c_int, f32p]
    cdll.voxelize_temporal_f32.restype = None
    cdll.searchsorted_i64.argtypes = [i64p, c_i64, i64p, c_i64, i64p]
    cdll.searchsorted_i64.restype = None
    cdll.pad_windows_f64.argtypes = [f64p, i64p, i64p, c_i64, c_i64, f32p,
                                     u8p]
    cdll.pad_windows_f64.restype = None
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    cdll.pad_windows_i16.argtypes = [i64p, i16p, c_i64, i64p, i64p, c_i64,
                                     c_i64, f32p, u8p]
    cdll.pad_windows_i16.restype = None
    cdll.ingest_rectify_bin_f32.argtypes = [
        u16p, u16p, i64p, u8p, i64p, i64p, c_i64, c_i64,
        f32p, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64,
        f32p, u8p, i32p, i64p, f32p, i32p]
    cdll.ingest_rectify_bin_f32.restype = None
    cdll.ingest_rectify_bin_folded.argtypes = [
        u16p, u16p, i64p, u8p, i64p, i64p, c_i64, c_i64, c_i64,
        f32p, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64,
        f32p, u8p, i32p, i64p, f32p, i32p]
    cdll.ingest_rectify_bin_folded.restype = c_i64
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    cdll.ingest_rectify_bin_packed.argtypes = [
        u16p, u16p, i64p, u8p, i64p, i64p, c_i64, c_i64,
        f32p, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64,
        u16p, u16p, u16p, u8p, i32p, i64p, i32p, i32p]
    cdll.ingest_rectify_bin_packed.restype = None
    cdll.ingest_rectify_bin_packed_folded.argtypes = [
        u16p, u16p, i64p, u8p, i64p, i64p, c_i64, c_i64, c_i64,
        f32p, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64,
        u16p, u16p, u16p, i8p, i32p, i64p, f32p, i32p]
    cdll.ingest_rectify_bin_packed_folded.restype = c_i64
    return cdll


COORD_SCALE = 64       # packed wire: coordinates in 1/64-pixel steps
TIME_SCALE = 60000     # packed wire: window-normalized time in 1/60000 steps
POL_SCALE = 127        # packed folded wire: pre-weighted polarity steps


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use. Raises if ``g++`` fails."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
    return _lib


def available() -> bool:
    """Whether the native library builds and loads here (the entry points
    raise where it does not)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


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


def voxelize_host(raw_windows: np.ndarray, valid: np.ndarray, *,
                  num_bins: int, height: int, width: int,
                  trilinear: bool = False, separate_pol: bool = False
                  ) -> np.ndarray:
    """(T, N, 4) [x, y, t, p] raw windows and their (T, N) validity ->
    (T, C, H, W) f32 grids, built on the host by the library's voxelizers:
    the trilinear grid (``trilinear``), else the temporal-bilinear one,
    with 2 * num_bins channels under ``separate_pol``."""
    lib = get_lib()
    t_dim = raw_windows.shape[0]
    channels = num_bins * 2 if (separate_pol and not trilinear) else num_bins
    out = np.zeros((t_dim, channels, height, width), np.float32)
    ev = np.ascontiguousarray(raw_windows, np.float32)
    vd = np.ascontiguousarray(valid, np.uint8)
    for i in range(t_dim):
        if trilinear:
            lib.voxelize_trilinear_f32(ev[i], vd[i], ev.shape[1], num_bins,
                                       height, width, out[i])
        else:
            lib.voxelize_temporal_f32(ev[i], vd[i], ev.shape[1], num_bins,
                                      height, width, int(separate_pol),
                                      out[i])
    return out


def searchsorted_i64(t: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """First index with ``t[i] >= q`` for each query (``t`` sorted int64):
    ``np.searchsorted(t, queries, side='left')`` as int64."""
    lib = get_lib()
    t = np.ascontiguousarray(t, np.int64)
    q = np.ascontiguousarray(queries, np.int64)
    out = np.empty(len(q), np.int64)
    lib.searchsorted_i64(t, len(t), q, len(q), out)
    return out


def pad_windows_from_bounds(
    events_f64: np.ndarray, starts: np.ndarray, ends: np.ndarray,
    capacity: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Gather-pad (N, 4) float64 events into (T, capacity, 4) f32 + (T,
    capacity) bool, window ``i`` holding events ``[starts[i], ends[i])``:
    a longer window keeps its last ``capacity`` events, times re-zeroed to
    the window's first kept event (``slicer.pad_windows``)."""
    lib = get_lib()
    t_dim = len(starts)
    ev = np.ascontiguousarray(events_f64, np.float64)
    out = np.empty((t_dim, capacity, 4), np.float32)
    valid = np.empty((t_dim, capacity), np.uint8)
    lib.pad_windows_f64(ev, np.ascontiguousarray(starts, np.int64),
                        np.ascontiguousarray(ends, np.int64), t_dim,
                        capacity, out, valid)
    return out, valid.astype(bool)


def pad_windows_ddd17(
    t: np.ndarray, xyp: np.ndarray, starts: np.ndarray, ends: np.ndarray,
    capacity: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Gather-pad DDD17 windows straight from its memmap layout (``t``
    int64 nanoseconds, ``xyp`` (N, 3) int16): (T, capacity, 4) f32 (x, y,
    t re-zeroed to the window's first kept event, p) + (T, capacity) bool,
    the contract of :func:`pad_windows_from_bounds`. Only the region the
    windows touch is read from the memmaps."""
    lib = get_lib()
    t_dim = len(starts)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    lo = int(starts.min()) if t_dim else 0
    hi = int(ends.max()) if t_dim else 0
    out = np.empty((t_dim, capacity, 4), np.float32)
    valid = np.empty((t_dim, capacity), np.uint8)
    lib.pad_windows_i16(np.ascontiguousarray(t[lo:hi], np.int64),
                        np.ascontiguousarray(xyp[lo:hi], np.int16), hi - lo,
                        np.ascontiguousarray(starts - lo),
                        np.ascontiguousarray(ends - lo), t_dim, capacity,
                        out, valid)
    return out, valid.astype(bool)


def _event_columns(ev: dict):
    return (np.ascontiguousarray(ev["x"], np.uint16),
            np.ascontiguousarray(ev["y"], np.uint16),
            np.ascontiguousarray(ev["t"], np.int64),
            np.ascontiguousarray(ev["p"], np.uint8))


def ingest_rectify_bin(
    ev: dict, starts: np.ndarray, ends: np.ndarray, capacity: int,
    rectify_map: np.ndarray, *, tile_h: int, tile_w: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused DSEC ingest on the tile wire: rectify (``rectify_map[y, x]``)
    + pad + tile binning of raw event columns ``ev`` ({"x", "y", "t", "p"}
    as in events.h5), window ``i`` over ``[starts[i], ends[i])``. Returns
    (raw (T, capacity, 4) f32, valid (T, capacity) bool, offsets (T,
    n_tiles + 1) i32), as :func:`tile_bin` on the rectified windows."""
    lib = get_lib()
    mh, mw = rectify_map.shape[:2]
    hp = -(-mh // tile_h) * tile_h
    wp = -(-mw // tile_w) * tile_w
    ntx = wp // tile_w
    n_tiles = (hp // tile_h) * ntx
    t_dim = len(starts)
    out = np.empty((t_dim, capacity, 4), np.float32)
    out_valid = np.empty((t_dim, capacity), np.uint8)
    offsets = np.empty((t_dim, n_tiles + 1), np.int32)
    counts = np.empty(n_tiles, np.int64)
    xy_scratch = np.empty((capacity, 2), np.float32)
    tid_scratch = np.empty(capacity, np.int32)
    lib.ingest_rectify_bin_f32(
        *_event_columns(ev), np.ascontiguousarray(starts, np.int64),
        np.ascontiguousarray(ends, np.int64), t_dim, capacity,
        np.ascontiguousarray(rectify_map, np.float32), mh, mw, tile_h,
        tile_w, ntx, n_tiles, out, out_valid, offsets, counts, xy_scratch,
        tid_scratch)
    return out, out_valid.astype(bool), offsets


def ingest_rectify_bin_folded(
    ev: dict, starts: np.ndarray, ends: np.ndarray, capacity: int,
    rectify_map: np.ndarray, *, tile_h: int,
    out_capacity: Optional[int] = None, ntx: int = 1, slot_w: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused DSEC ingest on the folded wire: rectify + per-window time
    re-zero + ghost-folded band binning of raw event columns in one pass.
    ``ntx`` x-slots of ``slot_w`` columns per band (``ntx=1``: the legacy
    full-width bands). Returns (records (T, cap2, 4) f32 with pre-weighted
    polarity, valid (T, cap2) bool, offsets (T, n_bands * ntx + 1) i32),
    growing ``cap2`` (default :func:`folded_capacity` of ``capacity``) to
    the next quantized level when a window overflows it."""
    lib = get_lib()
    mh, mw = rectify_map.shape[:2]
    n_bands = -(-mh // tile_h)
    t_dim = len(starts)
    cols = _event_columns(ev)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    rmap = np.ascontiguousarray(rectify_map, np.float32)
    cap2 = (out_capacity if out_capacity is not None
            else folded_capacity(capacity))
    n_groups = n_bands * ntx
    while True:
        out = np.empty((t_dim, cap2, 4), np.float32)
        out_valid = np.empty((t_dim, cap2), np.uint8)
        offsets = np.empty((t_dim, n_groups + 1), np.int32)
        counts = np.empty(n_groups, np.int64)
        rec_scratch = np.empty((4 * capacity, 4), np.float32)
        band_scratch = np.empty(4 * capacity, np.int32)
        needed = lib.ingest_rectify_bin_folded(
            *cols, starts, ends, t_dim, capacity, cap2, rmap, mh, mw,
            tile_h, n_bands, ntx, slot_w, out, out_valid, offsets, counts,
            rec_scratch, band_scratch)
        if needed <= cap2:
            return out, out_valid.astype(bool), offsets
        cap2 = quantize_folded_capacity(int(needed), capacity)


def ingest_rectify_bin_packed(
    ev: dict, starts: np.ndarray, ends: np.ndarray, capacity: int,
    rectify_map: np.ndarray, *, tile_h: int, tile_w: int = 128,
) -> Dict[str, np.ndarray]:
    """:func:`ingest_rectify_bin` on the packed wire: {"ev_xq", "ev_yq",
    "ev_tq": (T, capacity) u16, "ev_pq": (T, capacity) u8 (0 / 1),
    "tile_offsets": (T, n_tiles + 1) i32}. The tile ids come from the
    quantized coordinates, so the binning and the voxelizer see the same
    tile of every event; the entries past a window's event count are
    zero."""
    lib = get_lib()
    mh, mw = rectify_map.shape[:2]
    hp = -(-mh // tile_h) * tile_h
    wp = -(-mw // tile_w) * tile_w
    ntx = wp // tile_w
    n_tiles = (hp // tile_h) * ntx
    t_dim = len(starts)
    out = {k: np.empty((t_dim, capacity), np.uint16)
           for k in ("ev_xq", "ev_yq", "ev_tq")}
    out["ev_pq"] = np.empty((t_dim, capacity), np.uint8)
    offsets = np.empty((t_dim, n_tiles + 1), np.int32)
    counts = np.empty(n_tiles, np.int64)
    q_scratch = np.empty((capacity, 2), np.int32)
    tid_scratch = np.empty(capacity, np.int32)
    lib.ingest_rectify_bin_packed(
        *_event_columns(ev), np.ascontiguousarray(starts, np.int64),
        np.ascontiguousarray(ends, np.int64), t_dim, capacity,
        np.ascontiguousarray(rectify_map, np.float32), mh, mw, tile_h,
        tile_w, ntx, n_tiles, out["ev_xq"], out["ev_yq"], out["ev_tq"],
        out["ev_pq"], offsets, counts, q_scratch, tid_scratch)
    out["tile_offsets"] = offsets
    return out


def ingest_rectify_bin_packed_folded(
    ev: dict, starts: np.ndarray, ends: np.ndarray, capacity: int,
    rectify_map: np.ndarray, *, tile_h: int,
    out_capacity: Optional[int] = None, ntx: int = 1, slot_w: int = 128,
) -> Dict[str, np.ndarray]:
    """:func:`ingest_rectify_bin_folded` on the packed wire: {"ev_xq",
    "ev_yq", "ev_tq": (T, cap2) u16, "ev_pq": (T, cap2) i8 pre-weighted
    polarity, "band_offsets": (T, n_bands * ntx + 1) i32}. The coordinates
    are quantized before the folding, so the (band, x-slot) groups and the
    voxelizer's tents agree; ``cap2`` grows as on the f32 wire."""
    lib = get_lib()
    mh, mw = rectify_map.shape[:2]
    n_bands = -(-mh // tile_h)
    t_dim = len(starts)
    cols = _event_columns(ev)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    rmap = np.ascontiguousarray(rectify_map, np.float32)
    cap2 = (out_capacity if out_capacity is not None
            else folded_capacity(capacity))
    n_groups = n_bands * ntx
    while True:
        out = {k: np.empty((t_dim, cap2), np.uint16)
               for k in ("ev_xq", "ev_yq", "ev_tq")}
        out["ev_pq"] = np.empty((t_dim, cap2), np.int8)
        offsets = np.empty((t_dim, n_groups + 1), np.int32)
        counts = np.empty(n_groups, np.int64)
        rec_scratch = np.empty((4 * capacity, 4), np.float32)
        band_scratch = np.empty(4 * capacity, np.int32)
        needed = lib.ingest_rectify_bin_packed_folded(
            *cols, starts, ends, t_dim, capacity, cap2, rmap, mh, mw,
            tile_h, n_bands, ntx, slot_w, out["ev_xq"], out["ev_yq"],
            out["ev_tq"], out["ev_pq"], offsets, counts, rec_scratch,
            band_scratch)
        if needed <= cap2:
            out["band_offsets"] = offsets
            return out
        cap2 = quantize_folded_capacity(int(needed), capacity)
