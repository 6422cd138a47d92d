"""DDD17 event dataset (host ingest).

Counterpart of ``ess_tpu/data/ddd17.py``: the 260x346 DAVIS sensor, one
memmap event store per recording directory (``slicer.DDD17EventStore``),
``segmentation_masks/*.png`` labels (already train ids), the fixed
train/valid/test directory split, windows of the last ``nr_events_data *
nr_events_window`` events before each label (equal-count chunks, or
searchsorted boundaries over uniform time steps in fixed-duration mode),
gathered and padded straight from the memmaps by the native library
(``native.pad_windows_ddd17``), and the optional paired grayscale frame of
the validation split.

Samples carry raw fixed-capacity windows, binned on the host for the device
voxelizers (``binning``): ``'folded'`` integer-coordinate records grouped by
(band, 128-column x-slot) with ``band_offsets`` (no ghosts: integer
coordinates never cross a band), or ``'tile'`` events sorted by halo tile
with ``tile_offsets``. The device pipeline (``train.builder.make_pipeline``)
normalizes, crops the 60 bottom rows, resizes the width to 352 and augments.

The label is squeezed from 260 to 200 rows by a nearest resize while the
event grids are bottom-cropped from 260 to 200 rows: the reference's own
geometry, kept on purpose (the JAX module says why). Masks are read and
resized by :mod:`ess_tpu_torch.data.png` (what ``cv2.imread(path, 0)`` and
its nearest resize give) and a paired grayscale frame by ``png`` and
:func:`ess_tpu_torch.data.imgproc.resize_linear`, so the loader needs no
``cv2``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from ess_tpu_torch.data import imgproc, native, png
from ess_tpu_torch.data.slicer import DDD17EventStore
from ess_tpu_torch.ops import voxel_folded, voxel_tiled

SENSOR_SHAPE = (260, 346)
RESIZED_SHAPE = (200, 352)  # after the 60-row crop and the width resize
BINNINGS = ("folded", "tile")


def get_split_dirs(dirs: List[str], split: str) -> List[str]:
    """The fixed directory split of the reference loader."""
    table = {"train": [0, 2, 3, 5, 6], "valid": [1], "test": [4]}
    return [dirs[i] for i in table[split]]


def chunk_bounds(store: DDD17EventStore, img_idx: int, *, nr_events_data: int,
                 nr_events_window: int, fixed_duration: bool):
    """Global [start, end) event-index bounds of the ``nr_events_data``
    windows before image ``img_idx``: equal counts of the last
    ``nr_events_data * nr_events_window`` events, or, in fixed-duration
    mode, the events from the index's ``event_idx_before`` split at
    uniform time steps (searchsorted)."""
    row = store.img_index[img_idx]
    end = int(row[1])
    t_dim = nr_events_data
    if fixed_duration:
        start = max(int(row[2]), 0)
        t_slice = np.asarray(store.t[start:end], np.int64)
        if len(t_slice) == 0:
            starts = ends = np.full(t_dim, start, np.int64)
            return starts, ends
        delta = (t_slice[-1] - t_slice[0]) / t_dim
        queries = (t_slice[0] + delta * np.arange(1, t_dim + 1)).astype(
            np.int64)
        bounds = np.concatenate(
            [[0], np.searchsorted(t_slice, queries, side="left")])
        bounds = np.minimum(bounds, len(t_slice))
        return start + bounds[:-1], start + bounds[1:]
    start = max(end - t_dim * nr_events_window, 0)
    per = (end - start) // t_dim
    starts = start + per * np.arange(t_dim, dtype=np.int64)
    ends = np.minimum(starts + per, end)
    return starts, ends


def events_for_image(store: DDD17EventStore, img_idx: int, *,
                     nr_events_data: int = 20, nr_events_window: int = 32000,
                     fixed_duration: bool = False,
                     binning: Optional[str] = "folded",
                     bins: int = 5) -> Dict[str, np.ndarray]:
    """The event windows before image ``img_idx``: ``raw_events`` (T, N, 4)
    f32 (x, y, t re-zeroed per window, p in {0, 1}) and ``valid`` (T, N);
    with a ``binning``, sorted for the device voxelizer and with its
    offsets (``band_offsets`` or ``tile_offsets``). ``bins`` is the
    voxelizer's channel count (twice the bins with ``separate_pol``)."""
    if binning not in BINNINGS + (None,):
        raise ValueError(f"unknown binning {binning!r}; expected one of "
                         f"{BINNINGS} or None")
    starts, ends = chunk_bounds(store, img_idx,
                                nr_events_data=nr_events_data,
                                nr_events_window=nr_events_window,
                                fixed_duration=fixed_duration)
    raw, valid = native.pad_windows_ddd17(store.t, store.xyp, starts, ends,
                                          nr_events_window)
    geo = dict(height=SENSOR_SHAPE[0], width=SENSOR_SHAPE[1], bins=bins)
    if binning == "folded":
        raw, valid, offsets = voxel_folded.host_band_bin_folded(
            raw, valid, trilinear=False, x_slots=True, **geo)
        return {"raw_events": raw, "valid": valid, "band_offsets": offsets}
    if binning == "tile":
        raw, valid, offsets = voxel_tiled.host_tile_bin(raw, valid, **geo)
        return {"raw_events": raw, "valid": valid, "tile_offsets": offsets}
    return {"raw_events": raw, "valid": valid}


class DDD17Events:
    """Map-style dataset of raw event windows and labels.

    Sample dict: ``raw_events`` (T, N, 4) f32, ``valid`` (T, N) bool,
    ``label`` (200, 352) uint8 train ids (ignore 255), the binning's
    offsets; on the validation split with ``require_paired_data`` also
    ``image`` (200, 352, 1) f32 in [0, 1] where the frame exists and
    ``label_original`` (260, 346) uint8."""

    def __init__(self, root: str, split: str = "train",
                 nr_events_data: int = 20, nr_events_window: int = 32000,
                 fixed_duration: bool = False, delta_t_per_data: int = 50,
                 require_paired_data: bool = False, tile_bin: bool = True,
                 tile_bins: int = 5, binning: str = "folded"):
        data_dirs = sorted(glob.glob(os.path.join(root, "dir*")))
        if not data_dirs:
            raise ValueError(f"no DDD17 'dir*' folders under {root}")
        if split not in ("train", "valid", "test"):
            raise ValueError(f"unknown split {split!r}")
        if binning not in BINNINGS:
            raise ValueError(f"unknown binning {binning!r}; expected one of "
                             f"{BINNINGS}")
        self.split = split
        self.nr_events_data = nr_events_data
        self.nr_events_window = nr_events_window
        self.fixed_duration = fixed_duration
        self.require_paired_data = require_paired_data
        self.tile_bin = tile_bin
        self.tile_bins = tile_bins   # the voxelizer's channel count
        self.binning = binning
        t_interval = (nr_events_data * delta_t_per_data if fixed_duration
                      else 50)
        self.dirs = get_split_dirs(data_dirs, split)
        self.stores: Dict[str, DDD17EventStore] = {
            d: DDD17EventStore.open(d, t_interval) for d in self.dirs}
        self.files: List[str] = []
        for d in self.dirs:
            self.files += sorted(glob.glob(
                os.path.join(d, "segmentation_masks", "*.png")))
        if not self.files:
            raise ValueError("no segmentation masks found")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        mask_file = self.files[idx]
        directory = os.path.dirname(os.path.dirname(mask_file))
        img_idx = int(os.path.basename(mask_file).split("_")[-1]
                      .split(".")[0]) - 1
        label_original = png.read_gray8(mask_file)
        # squeezed to 200 rows while the events are bottom-cropped: the
        # reference's geometry, kept on purpose (module docstring)
        label = png.resize_nearest(label_original, *RESIZED_SHAPE)
        out = events_for_image(
            self.stores[directory], img_idx,
            nr_events_data=self.nr_events_data,
            nr_events_window=self.nr_events_window,
            fixed_duration=self.fixed_duration,
            binning=self.binning if self.tile_bin else None,
            bins=self.tile_bins)
        out["label"] = label.astype(np.uint8)
        if self.split == "valid" and self.require_paired_data:
            img = self._paired_frame(mask_file)
            if img is not None:
                out["image"] = img
            out["label_original"] = label_original.astype(np.uint8)
        return out

    def _paired_frame(self, mask_file: str) -> Optional[np.ndarray]:
        """The grayscale frame of a validation mask, resized to 352 wide
        and bottom-cropped to 200 rows."""
        parts = mask_file.split(os.sep)
        fid = parts[-1].split("_")[-1]
        for name in (f"img_{fid}", fid.zfill(14)):
            candidate = os.sep.join(parts[:-2] + ["imgs", name])
            if os.path.exists(candidate):
                img = imgproc.resize_linear(png.imread_gray(candidate),
                                            SENSOR_SHAPE[0], RESIZED_SHAPE[1])
                img = img[:-60]
                return (img.astype(np.float32) / 255.0)[..., None]
        return None
