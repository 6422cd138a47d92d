"""Event stores and the time/count slicer (host ingest).

Counterpart of ``ess_tpu/data/slicer.py``: ``ArrayEventStore`` (events in
plain arrays), ``H5EventStore`` (a DSEC ``events.h5`` with its
per-millisecond ``ms_to_idx`` index and ``t_offset``), ``DDD17EventStore``
(DDD17's ``events.dat.t`` / ``events.dat.xyp`` memmaps and its image ->
event index), ``EventSlicer`` (time and count window queries with the
reference's boundary semantics), ``events_dict_to_xytp`` and
``pad_windows``.

A window ``[t_start, t_end)`` holds exactly the events with ``t_start <= t <
t_end`` after the ``t_offset`` is removed. The index ``ms_to_idx`` satisfies
``t[ms_to_idx[ms]] >= ms * 1000 > t[ms_to_idx[ms] - 1]``, so a query reads
only the millisecond around its bound and refines it with
``np.searchsorted``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


class ArrayEventStore:
    """Events held in plain arrays (sorted by t, microseconds)."""

    def __init__(self, x, y, t, p, t_offset: int = 0, ms_to_idx=None):
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.t = np.asarray(t, np.int64)
        self.p = np.asarray(p)
        self.t_offset = int(t_offset)
        if ms_to_idx is None:
            last_ms = int(self.t[-1]) // 1000 + 1 if len(self.t) else 0
            ms = np.arange(last_ms + 1, dtype=np.int64) * 1000
            ms_to_idx = np.searchsorted(self.t, ms, side="left")
        self.ms_to_idx = np.asarray(ms_to_idx, np.int64)

    def __len__(self) -> int:
        return len(self.t)

    def read(self, start: int, end: int) -> Dict[str, np.ndarray]:
        return {
            "x": np.asarray(self.x[start:end]),
            "y": np.asarray(self.y[start:end]),
            "t": np.asarray(self.t[start:end]),
            "p": np.asarray(self.p[start:end]),
        }

    def read_t(self, start: int, end: int) -> np.ndarray:
        return np.asarray(self.t[start:end])


class H5EventStore(ArrayEventStore):
    """DSEC events.h5 store: lazy h5py datasets (``h5py`` is imported here,
    and ``hdf5plugin``'s codecs where installed)."""

    def __init__(self, path: str):
        import h5py
        try:
            import hdf5plugin  # registers blosc/zstd filters  # noqa: F401
        except ImportError:
            pass
        self._h5 = h5py.File(path, "r")
        ev = self._h5["events"]
        self.x, self.y, self.t, self.p = ev["x"], ev["y"], ev["t"], ev["p"]
        self.ms_to_idx = np.asarray(self._h5["ms_to_idx"], np.int64)
        self.t_offset = (int(self._h5["t_offset"][()])
                         if "t_offset" in self._h5 else 0)

    def __len__(self) -> int:
        return self.t.shape[0]


@dataclass
class DDD17EventStore:
    """DDD17 memmap store; timestamps in **nanoseconds**."""

    t: np.ndarray
    xyp: np.ndarray
    # index rows: (img_timestamp_ns, event_idx, event_idx_before)
    img_index: np.ndarray

    @staticmethod
    def open(directory: str, t_interval_ms: int = 50) -> "DDD17EventStore":
        """Open a recording directory: ``events.dat.t`` (int64),
        ``events.dat.xyp`` (int16 x, y, p) and
        ``index/index_{10,50,250}ms.npy`` (50 ms for any other interval)."""
        interval = t_interval_ms if t_interval_ms in (10, 50, 250) else 50
        idx = np.load(os.path.join(directory, "index",
                                   f"index_{interval}ms.npy"))
        t_file = os.path.join(directory, "events.dat.t")
        n = os.path.getsize(t_file) // 8
        t = np.memmap(t_file, dtype="int64", mode="r", shape=(n,))
        xyp = np.memmap(os.path.join(directory, "events.dat.xyp"),
                        dtype="int16", mode="r", shape=(n, 3))
        return DDD17EventStore(t=t, xyp=xyp, img_index=idx)

    def window_for_image(self, img_idx: int, *, fixed_duration: bool,
                         nr_events: int) -> np.ndarray:
        """(N, 4) float64 events [x, y, t_ns, p] ending at image
        ``img_idx``: from the index's ``event_idx_before`` in fixed-duration
        mode, else the last ``nr_events`` events."""
        row = self.img_index[img_idx]
        end = int(row[1])
        start = (max(int(row[2]), 0) if fixed_duration
                 else max(end - nr_events, 0))
        t = np.asarray(self.t[start:end], np.int64)
        xyp = np.asarray(self.xyp[start:end], np.int64)
        out = np.empty((end - start, 4), np.float64)
        out[:, 0] = xyp[:, 0]
        out[:, 1] = xyp[:, 1]
        out[:, 2] = t
        out[:, 3] = xyp[:, 2]
        return out


class EventSlicer:
    """Time and count window queries over an event store (microseconds)."""

    def __init__(self, store):
        self.store = store

    @property
    def t_offset(self) -> int:
        return self.store.t_offset

    def start_time_us(self) -> int:
        return self.store.t_offset

    def final_time_us(self) -> int:
        n = len(self.store)
        return int(self.store.read_t(n - 1, n)[0]) + self.store.t_offset

    def _ms2idx(self, ms: int) -> Optional[int]:
        if ms < 0 or ms >= len(self.store.ms_to_idx):
            return None
        return int(self.store.ms_to_idx[ms])

    def _refine(self, lo_idx: int, hi_idx: int, t_query_us: int,
                side: str) -> int:
        """Exact index of ``t_query_us`` within the chunk [lo, hi)."""
        t_chunk = self.store.read_t(lo_idx, hi_idx)
        return lo_idx + int(np.searchsorted(t_chunk, t_query_us, side=side))

    def index_of_time(self, t_us: int) -> Optional[int]:
        """First event index with t >= t_us (gps time); None outside the
        recording's index."""
        t = t_us - self.store.t_offset
        lo_ms = t // 1000
        lo = self._ms2idx(lo_ms)
        hi = self._ms2idx(lo_ms + 1)
        if lo is None:
            return None
        if hi is None:
            hi = len(self.store)
        return self._refine(lo, hi, t, "left")

    def get_events(self, t_start_us: int, t_end_us: int
                   ) -> Optional[Dict[str, np.ndarray]]:
        assert t_start_us < t_end_us
        i0 = self.index_of_time(t_start_us)
        i1 = self.index_of_time(t_end_us)
        if i0 is None or i1 is None:
            return None
        return self.store.read(i0, i1)

    def get_events_fixed_num(self, t_end_us: int, nr_events: int
                             ) -> Optional[Dict[str, np.ndarray]]:
        """The last ``nr_events`` events strictly before ``t_end_us``."""
        i1 = self.index_of_time(t_end_us)
        if i1 is None:
            return None
        return self.store.read(max(i1 - nr_events, 0), i1)

    def get_events_fixed_num_recurrent(self, idx_start: int, idx_end: int
                                       ) -> Dict[str, np.ndarray]:
        assert idx_start < idx_end
        return self.store.read(idx_start, idx_end)


def events_dict_to_xytp(ev: Dict[str, np.ndarray]) -> np.ndarray:
    """(N, 4) float64 array in (x, y, t, p) column order."""
    out = np.empty((len(ev["t"]), 4), np.float64)
    out[:, 0] = ev["x"]
    out[:, 1] = ev["y"]
    out[:, 2] = ev["t"]
    out[:, 3] = ev["p"]
    return out


def pad_windows(windows: list[np.ndarray], capacity: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length (Ni, 4) windows into a fixed (T, capacity, 4)
    float32 buffer + (T, capacity) validity. A window longer than
    ``capacity`` keeps its most recent events; times are re-zeroed to each
    window's first kept event, so they stay exact in float32."""
    t_dim = len(windows)
    out = np.zeros((t_dim, capacity, 4), np.float32)
    valid = np.zeros((t_dim, capacity), bool)
    for i, w in enumerate(windows):
        n = min(len(w), capacity)
        if n > 0:
            chunk = w[-n:]
            out[i, :n] = chunk.astype(np.float32)
            out[i, :n, 2] = (chunk[:, 2] - chunk[0, 2]).astype(np.float32)
            valid[i, :n] = True
    return out, valid
