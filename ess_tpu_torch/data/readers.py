"""Text/zip event-stream readers of the standalone reconstruction program.

Counterpart of ``ess_tpu/data/readers.py``: ``read_header``,
``FixedSizeEventReader`` (N events a window; the last partial window is
dropped) and ``FixedDurationEventReader`` (a window closes with the first
event past its cutoff, which it keeps; the tail is yielded).

Files are whitespace-separated ``t x y p`` rows after a ``width height``
header line, as the public E2VID datasets ship them, plain or as the only
member of a zip archive. ``start_index`` skips that many lines after the
header; lines without four fields are skipped. Text windows are float64
(N, 4) ``[t, x, y, p]`` arrays.

``H5DurationReader`` iterates over a DSEC ``events.h5`` in windows of a
fixed duration (``data/slicer.py``'s store and slicer; ``h5py`` is
imported when a reader opens a file), yielding (N, 4) ``[x, y, t, p]``
arrays.
"""

from __future__ import annotations

import contextlib
import io
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np


@contextlib.contextmanager
def _open_text(path: str):
    """The text of ``path``, or of the first member of a ``.zip``."""
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf, zf.open(zf.namelist()[0]) as raw:
            yield io.TextIOWrapper(raw, encoding="utf-8")
    else:
        with open(path) as f:
            yield f


def read_header(path: str) -> Tuple[int, int]:
    """(width, height) from the first line."""
    with _open_text(path) as f:
        parts = f.readline().split()
    return int(parts[0]), int(parts[1])


def _rows(f, start_index: int) -> Iterator[list]:
    """The ``[t, x, y, p]`` floats of every 4-field line after the header
    and ``start_index`` skipped lines."""
    f.readline()
    for _ in range(start_index):
        f.readline()
    for line in f:
        parts = line.split()
        if len(parts) == 4:
            yield [float(v) for v in parts]


class FixedSizeEventReader:
    """Yields (N, 4) [t, x, y, p] float64 windows with N events each."""

    def __init__(self, path: str, num_events: int = 10000,
                 start_index: int = 0):
        self.path = path
        self.num_events = num_events
        self.start_index = start_index

    def __iter__(self) -> Iterator[np.ndarray]:
        buf = []
        with _open_text(self.path) as f:
            for row in _rows(f, self.start_index):
                buf.append(row)
                if len(buf) == self.num_events:
                    yield np.asarray(buf)
                    buf = []


class FixedDurationEventReader:
    """Yields windows covering ``duration_ms`` each: a window closes with
    the first event later than its first event + the duration."""

    def __init__(self, path: str, duration_ms: float = 50.0,
                 start_index: int = 0):
        self.path = path
        self.duration_s = duration_ms / 1000.0
        self.start_index = start_index

    def __iter__(self) -> Iterator[np.ndarray]:
        buf = []
        last_stamp: Optional[float] = None
        with _open_text(self.path) as f:
            for row in _rows(f, self.start_index):
                t = row[0]
                if last_stamp is None:
                    last_stamp = t
                buf.append(row)
                if t > last_stamp + self.duration_s:
                    yield np.asarray(buf)
                    buf = []
                    last_stamp = t
        if buf:
            yield np.asarray(buf)



class H5DurationReader:
    """Windows of ``delta_t_ms`` over a DSEC events.h5 stream, from its
    first event time while a whole window fits before its last: (N_i, 4)
    [x, y, t, p] arrays, empty windows skipped."""

    def __init__(self, h5_path: str, delta_t_ms: float = 50.0):
        from ess_tpu_torch.data.slicer import EventSlicer, H5EventStore

        self.store = H5EventStore(h5_path)
        self.slicer = EventSlicer(self.store)
        self.delta_t_us = int(delta_t_ms * 1000)

    def __iter__(self) -> Iterator[np.ndarray]:
        from ess_tpu_torch.data.slicer import events_dict_to_xytp

        t = self.slicer.start_time_us()
        t_final = self.slicer.final_time_us()
        while t + self.delta_t_us <= t_final:
            ev = self.slicer.get_events(t, t + self.delta_t_us)
            if ev is not None and len(ev["t"]):
                yield events_dict_to_xytp(ev)
            t += self.delta_t_us
