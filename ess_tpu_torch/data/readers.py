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

