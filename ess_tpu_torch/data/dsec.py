"""DSEC-Semantic event dataset (host ingest).

Counterpart of ``ess_tpu/data/dsec.py``: a recorded sequence
(``events.h5`` + ``rectify_map.h5`` + label PNGs with ``timestamps.txt``)
becomes label-aligned samples of fixed-capacity event windows, rectified
and binned on the host by the native library's fused ingest in one pass
over the raw event columns (``native.ingest_rectify_bin_folded`` /
``ingest_rectify_bin``, or their ``_packed`` forms). The 480x640 sensor,
the train/val sequence lists, the dropped first labels (too little event
history), the label stride 2 and the fixed-count and fixed-duration window
modes are the JAX package's.

Binnings (``binning``):

- ``'folded'``: ghost-folded records grouped by (band, 128-column x-slot),
  ``band_offsets`` of ``n_bands * 5 + 1`` columns (the JAX default);
- ``'folded_bands'``: the same records grouped by full-width band only
  (the legacy wire, ``ntx=1``), ``band_offsets`` of ``n_bands + 1``
  columns;
- ``'tile'``: events sorted by halo tile, ``tile_offsets``.

``tile_bin=False`` ships rectified, padded raw windows with no offsets.

Wires (``wire_format``): ``'f32'`` ships ``raw_events`` (T, N, 4) f32 and
``valid``; ``'packed'`` ships the quantized columns ``ev_xq``, ``ev_yq``,
``ev_tq`` (u16) and ``ev_pq`` (u8, or i8 pre-weighted on the folded wire)
beside the offsets (``native`` says what they hold), for ``'folded'`` and
``'tile'``; ``'folded_bands'`` has no packed form and raises. As in the
JAX module the packed wire is the fused ingest's: without ``tile_bin``,
and for fixed-duration windows that reach outside the recording's index,
samples take the f32 slicer chain.

Unlike the JAX module there is no numpy fallback for a missing native
library (it raises); only windows that reach outside the recording's index
leave the fused fixed-duration ingest for the per-window slicer chain, as
in the JAX module.

:class:`SequenceRecurrent` streams a whole sequence as consecutive
single-window samples for ``train.streaming.run_streaming_eval``.
``h5py`` is imported where files are read, and label PNGs are read by
:mod:`ess_tpu_torch.data.png`; :meth:`DSECSequence.from_store` builds a
sequence from an event store, a rectify map and label arrays held in
memory, which needs no ``h5py``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ess_tpu_torch.data import native, png
from ess_tpu_torch.data.slicer import (
    EventSlicer, H5EventStore, events_dict_to_xytp, pad_windows)
from ess_tpu_torch.ops import voxel_folded, voxel_tiled

SENSOR_HEIGHT, SENSOR_WIDTH = 480, 640
CROP_BOTTOM = 40  # labels are provided at 440x640
SLOT_W = 128
BINNINGS = ("folded", "folded_bands", "tile")
WIRES = ("f32", "packed")

TRAIN_SEQUENCES = [
    "zurich_city_00_a", "zurich_city_01_a", "zurich_city_02_a",
    "zurich_city_04_a", "zurich_city_05_a", "zurich_city_06_a",
    "zurich_city_07_a", "zurich_city_08_a",
]
VAL_SEQUENCES = ["zurich_city_13_a", "zurich_city_14_c", "zurich_city_15_a"]

Label = Union[str, np.ndarray]


class DSECSequence:
    """One recorded sequence: label-aligned raw event windows.

    Settings (keywords of the constructor and of :meth:`from_store`, with
    the JAX module's defaults): ``mode``, ``nr_events_data`` (T windows per
    sample), ``nr_events_window`` (events per window, the capacity),
    ``fixed_duration`` and ``delta_t_per_data`` (ms per window), the dropped
    first labels' ``remove_time_window``, ``tile_bin`` (False: raw
    windows), ``tile_bins``, ``wire_format`` and ``binning`` (module
    docstring)."""

    def __init__(self, seq_path: str, mode: str = "train", *,
                 semseg_num_classes: int = 11, **kw):
        import h5py

        ts_file = os.path.join(seq_path, "semantic", "timestamps.txt")
        class_dir = {11: "11classes", 19: "19classes"}[semseg_num_classes]
        label_dir = os.path.join(seq_path, "semantic", class_dir, "data")
        label_files = sorted(glob.glob(os.path.join(label_dir, "*.png")))
        ev_dir = os.path.join(seq_path, "events", "left")
        with h5py.File(os.path.join(ev_dir, "rectify_map.h5"), "r") as f:
            rectify_map = f["rectify_map"][()]  # (480, 640, 2) float32
        self.seq_path = seq_path
        self._setup(H5EventStore(os.path.join(ev_dir, "events.h5")),
                    rectify_map, np.loadtxt(ts_file, dtype="int64"),
                    label_files, mode=mode, **kw)

    @classmethod
    def from_store(cls, store, rectify_map: np.ndarray,
                   timestamps: np.ndarray, labels: Sequence[np.ndarray],
                   **kw) -> "DSECSequence":
        """A sequence held in memory: an event store (``slicer.
        ArrayEventStore``), its (480, 640, 2) rectify map, the label
        timestamps and one (440, 640) uint8 label per timestamp, in place
        of the files; ``kw`` as :class:`DSECSequence` takes them."""
        self = cls.__new__(cls)
        self.seq_path = None
        self._setup(store, np.asarray(rectify_map, np.float32),
                    np.asarray(timestamps, np.int64), list(labels), **kw)
        return self

    def _setup(self, store, rectify_map: np.ndarray, timestamps: np.ndarray,
               labels: List[Label], *, mode: str = "train",
               nr_events_data: int = 20, nr_events_window: int = 100000,
               fixed_duration: bool = False, delta_t_per_data: int = 50,
               remove_time_window: int = 250, tile_bin: bool = True,
               tile_bins: int = 5, wire_format: str = "f32",
               binning: str = "folded") -> None:
        if wire_format not in WIRES:
            raise ValueError(f"wire_format={wire_format!r} is not one of "
                             f"{WIRES}")
        if binning not in BINNINGS:
            raise ValueError(f"binning={binning!r} is not one of {BINNINGS}")
        if wire_format == "packed" and binning == "folded_bands":
            raise ValueError("binning='folded_bands' has no packed wire: "
                             "use 'folded' or 'tile'")
        if len(labels) != timestamps.size:
            raise ValueError(f"{len(labels)} labels for {timestamps.size} "
                             "timestamps")
        self.mode = mode
        self.nr_events_data = nr_events_data
        self.nr_events_window = nr_events_window
        self.fixed_duration = fixed_duration
        self.tile_bin = tile_bin
        self.tile_bins = tile_bins  # kernel-effective bin count (tile height)
        self.wire_format = wire_format
        self.binning = binning
        # sticky folded-record capacity: once a sample grows past the
        # default margin, every later sample of this sequence is binned at
        # the same quantized level, so batch shapes stay stable
        self._folded_cap: Optional[int] = None
        self.delta_t_us = nr_events_data * delta_t_per_data * 1000
        # not enough event history before the first labels
        skip = (remove_time_window // 100 + 1) * 2
        self.timestamps = timestamps[skip:]
        self.label_files = labels[skip:]
        self.store = store
        self.slicer = EventSlicer(store)
        self.rectify_map = rectify_map

    def __len__(self) -> int:
        return (self.timestamps.size + 1) // 2

    def read_label(self, li: int) -> np.ndarray:
        """Label ``li`` (after the dropped first ones) as (440, 640) uint8."""
        lbl = self.label_files[li]
        if not isinstance(lbl, str):
            return np.asarray(lbl, np.uint8)
        return png.imread_gray(lbl)

    def _rectify(self, ev: np.ndarray) -> np.ndarray:
        """x, y -> rectify_map[y, x] float coordinates, in place."""
        rect = self.rectify_map[ev[:, 1].astype(np.int64),
                                ev[:, 0].astype(np.int64)]
        ev[:, 0] = rect[:, 0]
        ev[:, 1] = rect[:, 1]
        return ev

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        label = self.read_label(index * 2)
        ts_end = int(self.timestamps[index * 2])
        t_dim = self.nr_events_data
        if self.fixed_duration:
            ts_start = ts_end - self.delta_t_us
            per_us = self.delta_t_us / t_dim
            if self.tile_bin:
                got = self._fused_ingest_duration(ts_start, per_us, t_dim)
                if got is not None:
                    got["label"] = label
                    return got
            chunks = []
            for i in range(t_dim):
                ev = self.slicer.get_events(
                    int(ts_start + i * per_us),
                    int(ts_start + (i + 1) * per_us))
                chunks.append(self._rectify(events_dict_to_xytp(ev))
                              if ev is not None else np.zeros((0, 4)))
        else:
            ev = self.slicer.get_events_fixed_num(
                ts_end, t_dim * self.nr_events_window)
            if self.tile_bin:
                got = self._fused_ingest(ev, t_dim)
                got["label"] = label
                return got
            events = self._rectify(events_dict_to_xytp(ev))
            per = len(events) // t_dim
            chunks = [events[i * per: (i + 1) * per] for i in range(t_dim)]

        raw, valid = pad_windows(chunks, self.nr_events_window)
        out = {"raw_events": raw, "valid": valid, "label": label}
        if self.tile_bin:
            out.update(self._host_bin(raw, valid))
        return out

    def _ntx(self) -> int:
        return -(-SENSOR_WIDTH // SLOT_W) if self.binning == "folded" else 1

    def _host_bin(self, raw, valid) -> Dict[str, np.ndarray]:
        """Host binning of already rectified padded windows (the slicer
        chain's end), per ``self.binning``."""
        if self.binning != "tile":
            raw, valid, offsets = voxel_folded.host_band_bin_folded(
                raw, valid, height=SENSOR_HEIGHT, width=SENSOR_WIDTH,
                bins=self.tile_bins, capacity=self._folded_cap,
                x_slots=self.binning == "folded")
            self._folded_cap = raw.shape[1]
            return {"raw_events": raw, "valid": valid,
                    "band_offsets": offsets}
        raw, valid, offsets = voxel_tiled.host_tile_bin(
            raw, valid, height=SENSOR_HEIGHT, width=SENSOR_WIDTH,
            bins=self.tile_bins)
        return {"raw_events": raw, "valid": valid, "tile_offsets": offsets}

    def _ingest(self, ev: dict, starts: np.ndarray, ends: np.ndarray
                ) -> Dict[str, np.ndarray]:
        """The fused native rectify + pad + binning of raw event columns
        over per-window [start, end) bounds, on ``self.wire_format``."""
        th = voxel_folded.tile_h_for_bins(self.tile_bins)
        if self.wire_format == "packed":
            if self.binning == "tile":
                return native.ingest_rectify_bin_packed(
                    ev, starts, ends, self.nr_events_window,
                    self.rectify_map, tile_h=th)
            got = native.ingest_rectify_bin_packed_folded(
                ev, starts, ends, self.nr_events_window, self.rectify_map,
                tile_h=th, ntx=self._ntx(), slot_w=SLOT_W,
                out_capacity=self._folded_cap)
            self._folded_cap = got["ev_xq"].shape[1]
            return got
        if self.binning == "tile":
            raw, valid, offsets = native.ingest_rectify_bin(
                ev, starts, ends, self.nr_events_window, self.rectify_map,
                tile_h=th)
            return {"raw_events": raw, "valid": valid,
                    "tile_offsets": offsets}
        raw, valid, offsets = native.ingest_rectify_bin_folded(
            ev, starts, ends, self.nr_events_window, self.rectify_map,
            tile_h=th, ntx=self._ntx(), slot_w=SLOT_W,
            out_capacity=self._folded_cap)
        self._folded_cap = raw.shape[1]
        return {"raw_events": raw, "valid": valid, "band_offsets": offsets}

    def _fused_ingest_duration(self, ts_start: float, per_us: float,
                               t_dim: int) -> Optional[Dict[str, np.ndarray]]:
        """Fixed-duration windows through the fused ingest: the T + 1
        window boundaries resolved to event indices, the covered columns
        read once. None when a boundary lies outside the recording's index
        (the caller then takes the per-window slicer chain)."""
        bounds = []
        for i in range(t_dim + 1):
            idx = self.slicer.index_of_time(int(ts_start + i * per_us))
            if idx is None:
                return None
            bounds.append(idx)
        lo = bounds[0]
        ev = self.slicer.get_events_fixed_num_recurrent(
            lo, max(bounds[-1], lo + 1))
        starts = np.asarray(bounds[:-1], np.int64) - lo
        ends = np.asarray(bounds[1:], np.int64) - lo
        return self._ingest(ev, starts, ends)

    def _fused_ingest(self, ev: dict, t_dim: int) -> Dict[str, np.ndarray]:
        """Fixed-count windows through the fused ingest: ``ev`` split into
        ``t_dim`` equal chunks."""
        per = len(ev["t"]) // t_dim
        starts = np.arange(t_dim, dtype=np.int64) * per
        return self._ingest(ev, starts, starts + per)


class DSECEvents:
    """Concatenation of the fixed train or val sequence lists."""

    def __init__(self, dataset_path: str, mode: str = "train", **seq_kw):
        sub = "train" if mode == "train" else "test"
        names = TRAIN_SEQUENCES if mode == "train" else VAL_SEQUENCES
        base = os.path.join(dataset_path, sub)
        self.sequences: List[DSECSequence] = []
        for child in sorted(os.listdir(base)):
            if any(k in child for k in names):
                self.sequences.append(
                    DSECSequence(os.path.join(base, child), mode=mode,
                                 **seq_kw))
        if not self.sequences:
            raise FileNotFoundError(f"no DSEC sequences found under {base}")
        self._offsets = np.cumsum([0] + [len(s) for s in self.sequences])

    @property
    def rectify_map(self) -> np.ndarray:
        return self.sequences[0].rectify_map

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        seq_i = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        sample = self.sequences[seq_i][idx - int(self._offsets[seq_i])]
        sample["sequence"] = np.int32(seq_i)
        return sample


class SequenceRecurrent:
    """A whole sequence as consecutive non-overlapping fixed-count windows,
    one per item (T=1), for streaming eval with carried state.
    ``is_first`` marks the sequence start, where the consumer resets its
    state. Labels:

    - free-running (default): a label attaches to the window that contains
      its timestamp's event index (the prediction may see up to one window
      of events past the label);
    - ``align_labels=True``: the window grid is cut at each label's event
      index, so a scored window ends exactly at its label's time; such a
      window may be shorter than ``nr_events_window`` (capacity-padded)
      and the stream still tiles the sequence without gaps.
    """

    def __init__(self, seq: DSECSequence, nr_events_window: int = 100000,
                 align_labels: bool = False):
        self.seq = seq
        self.nr_events_window = nr_events_window
        self.align_labels = align_labels
        n_events = len(seq.store)
        label_at = []  # (event index, label index), ascending
        for li in range(len(seq.timestamps)):
            idx = seq.slicer.index_of_time(int(seq.timestamps[li]))
            if idx is not None:
                label_at.append((int(idx), li))
        label_at.sort()
        self.label_idx: Dict[int, int] = {}
        if align_labels:
            self.bounds = [0]
            pos = 0
            while self.bounds[-1] + nr_events_window <= n_events:
                cur = self.bounds[-1]
                end = cur + nr_events_window
                while pos < len(label_at) and label_at[pos][0] <= cur:
                    pos += 1  # at or before the cut: not scoreable
                if pos < len(label_at) and label_at[pos][0] <= end:
                    end, li = label_at[pos]
                    self.label_idx[len(self.bounds) - 1] = li
                    pos += 1
                self.bounds.append(end)
            self.n_windows = len(self.bounds) - 1
        else:
            self.n_windows = n_events // nr_events_window
            self.bounds = None
            for idx, li in label_at:
                self.label_idx[idx // nr_events_window] = li

    def __len__(self) -> int:
        return self.n_windows

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if not 0 <= i < self.n_windows:
            raise IndexError(i)  # iter() over this object must end
        if self.bounds is not None:
            lo, hi = self.bounds[i], self.bounds[i + 1]
        else:
            lo, hi = i * self.nr_events_window, (i + 1) * self.nr_events_window
        ev = self.seq.slicer.get_events_fixed_num_recurrent(lo, hi)
        out = {"is_first": np.bool_(i == 0)}
        if self.seq.tile_bin:
            out.update(self.seq._fused_ingest(ev, 1))
        else:
            events = self.seq._rectify(events_dict_to_xytp(ev))
            raw, valid = pad_windows([events], self.nr_events_window)
            out.update(raw_events=raw, valid=valid)
        li = self.label_idx.get(i)
        out["has_label"] = np.bool_(li is not None)
        if li is not None:
            out["label"] = self.seq.read_label(li)
        return out
