"""Benchmark: event windows per second of the DSEC supervised train step and
of DSEC streaming eval on one NVIDIA GPU.

The port's counterpart of the repository's ``bench.py``, at its shape and
with its synthetic recipe: B=8 x T=20 windows x 100k events, a 480x640
sensor cropped to 440x640, 5 bins, 11 classes, bf16, seeded weights,
host-folded (band, x-slot) binning. The step voxelizes (kernel B1), rolls
the frozen E2VID out on the int8 ConvLSTM kernel (``lstm_impl_train=
'pallas_int8'``), runs the segmentation head forward and backward, the
dice + CE loss and an RAdam update of the head.

Streaming eval (``bench_extra.py::bench_streaming_eval``'s shape): one
carried-state window at a time at B=1 and at B=8 streams side by side, 19
encoder-only windows and one scored window (decoder, head, confusion
matrix) per 20, on the tile wire: host tile-sorted events through the
halo-tiled voxelizer (kernel B3) and the exact ConvLSTM kernel (B2).

ESS UDA (``bench_extra.py::bench_uda_dsec``'s shape): the same B=8 x T=20
event batch with 440x640 grayscale sensor-A images and labels, the train
rollout on the int8 cell with its decoder, the ResNet18 image front twice
(forward and backward), the head three times, the cycle losses and both
RAdams (``dsec_uda_train_event_windows_per_sec_per_chip``; a reading, not
a claim).

DDD17 (``bench_extra.py``'s two DDD17 shapes): B=16 x T=20 windows of 32k
integer-coordinate events on the 260x346 DAVIS sensor, 6 classes, the train
rollout on the int8 cell (where the size rule lets it run: every level of
the 200x352 supervised rollout, level 0 of the 120x216 UDA crop). The
supervised step (``ddd17_supervised_train_event_windows_per_sec_per_chip``)
crops 60 rows and resizes the width to 352, no augmentation; the UDA step
(``ddd17_uda_train_event_windows_per_sec_per_chip``) runs
``make_pipeline``'s augmentation (the bottom-anchored 120x216 crop at a
random x and the flip) with 120x216 N(0, 1) sensor-A images and uniform
labels. Readings, not claims.

Run from the repository root::

    python -m ess_tpu_torch.bench [--iters N] [--profile DIR]

It prints JSON lines under ``bench.py``'s and ``bench_extra.py``'s metric
names: the two streaming readings, the eval step, the exact-bf16 train
companion (``lstm_impl_train=None``, the exact kernel), the UDA train
step, the two DDD17 train steps, and the train headline last; each names the card and its power
limit. Every rollout runs
in block space with the block convs (head, first encoder) on the library
conv, the builder's form; beside each reading stands the same one with the
block convs on the fused conv kernel (``block_conv_impl='pallas'``, the
train rollout ``'pallas_int8'`` beside its int8 ConvLSTM cell), its metric
name extended by ``_block_conv_pallas``. ``--profile DIR`` traces 20
streaming windows at each batch size, one eval step and one headline train
step (each in ``build_modules``' form), one train step with the block
convs on the int8 fused conv kernel, one UDA train step and one step of
each DDD17 train step, with
``torch.profiler`` and prints device time by kernel and the device's idle
share for each, with the traces in ``DIR``. It needs a CUDA device and
raises without one; there is no fallback configuration.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ess_tpu_torch.core.config import (
    Config, DatasetConfig, EventDatasetConfig, ImageDatasetConfig,
    ModelConfig, OptimConfig, TaskConfig)
from ess_tpu_torch.data.pipeline import EventPipeline
from ess_tpu_torch.ops import voxel_folded, voxel_tiled
from ess_tpu_torch.train import uda
from ess_tpu_torch.train import builder
from ess_tpu_torch.train.builder import (
    ESSModules, build_modules, init_params, init_state, with_block_conv_impl)
from ess_tpu_torch.train.streaming import make_streaming_steps
from ess_tpu_torch.train.supervised import make_eval_step, make_train_step

BASELINE_WINDOWS_PER_SEC = 160.0   # bench.py's estimate for the reference
UDA_BASELINE_WINDOWS_PER_SEC = 126.0   # bench_extra.py's, for ESS UDA
BATCH = 8
WINDOWS = 20
SENSOR_H, SENSOR_W, CROP = 480, 640, 40
EVENTS_PER_WINDOW = 100_000
BINS = 5
NUM_CLASSES = 11
METRIC = "dsec_supervised_train_event_windows_per_sec_per_chip"
EVAL_METRIC = "dsec_supervised_eval_event_windows_per_sec_per_chip"
UDA_METRIC = "dsec_uda_train_event_windows_per_sec_per_chip"
PALLAS_SUFFIX = "_block_conv_pallas"
FORMS = ("standard", "block_xla", "block_pallas")
STREAM_METRIC = "dsec_streaming_eval{}_windows_per_sec_per_chip"
DDD17_BATCH, DDD17_EVENTS, DDD17_CLASSES = 16, 32_000, 6
DDD17_SENSOR, DDD17_RESIZED, DDD17_CROP = (260, 346), (200, 352), (120, 216)
DDD17_BASELINE_WINDOWS_PER_SEC = 625.0   # bench_extra.py's, both steps
DDD17_METRIC = "ddd17_{}_train_event_windows_per_sec_per_chip"
WINDOWS_PER_SCORE = 20             # one labeled window in 20


def make_cfg(batch: int = BATCH,
             lstm_impl_train: Optional[str] = "pallas_int8") -> Config:
    """``bench.py::make_cfg`` at ``batch``: the train rollout on the int8
    cell, eval on the exact one."""
    return Config(
        dataset=DatasetConfig(
            sensor_a=ImageDatasetConfig(shape=(SENSOR_H - CROP, SENSOR_W)),
            sensor_b=EventDatasetConfig(
                name="DSEC_events", shape=(SENSOR_H - CROP, SENSOR_W),
                nr_events_data=WINDOWS, nr_temporal_bins=BINS,
                nr_events_window=EVENTS_PER_WINDOW)),
        model=ModelConfig(model_name="ess_supervised",
                          compute_dtype="bfloat16",
                          lstm_impl_train=lstm_impl_train),
        task=TaskConfig(semseg_num_classes=NUM_CLASSES),
        optim=OptimConfig(batch_size_b=batch))


def make_uda_cfg(batch: int = BATCH,
                 lstm_impl_train: Optional[str] = "pallas_int8") -> Config:
    """``bench_extra.py::make_uda_dsec_cfg`` at ``batch``: ESS UDA, 440x640
    grayscale sensor A, no augmentation, the train rollout on the int8
    cell."""
    cfg = make_cfg(batch, lstm_impl_train)
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset, sensor_a=ImageDatasetConfig(
                shape=(SENSOR_H - CROP, SENSOR_W), random_crop=False)),
        model=dataclasses.replace(cfg.model, model_name="ess",
                                  data_augmentation_train=False),
        optim=dataclasses.replace(cfg.optim, batch_size_a=batch))


def make_ddd17_cfg(model_name: str, batch: int = DDD17_BATCH,
                   lstm_impl_train: Optional[str] = "pallas_int8"
                   ) -> Config:
    """``bench_extra.py``'s DDD17 configs at ``batch``: the 200x346 sensor
    B (the rollouts at 200x352, ESS UDA's train rollout at the 120x216
    crop), 5 bins, 6 classes, bf16, the train rollout on
    ``lstm_impl_train``; ``model_name`` 'ess_supervised' or 'ess' (then
    augmentation on and 120x216 sensor-A images)."""
    uda_ = model_name == "ess"
    return Config(
        dataset=DatasetConfig(
            sensor_a=ImageDatasetConfig(
                shape=DDD17_CROP if uda_ else DDD17_RESIZED),
            sensor_b=EventDatasetConfig(
                name="DDD17_events", shape=(200, 346),
                nr_events_data=WINDOWS, nr_temporal_bins=BINS,
                nr_events_window=DDD17_EVENTS)),
        model=ModelConfig(model_name=model_name, compute_dtype="bfloat16",
                          data_augmentation_train=uda_,
                          lstm_impl_train=lstm_impl_train),
        task=TaskConfig(semseg_num_classes=DDD17_CLASSES),
        optim=OptimConfig(batch_size_a=batch, batch_size_b=batch))


def make_ddd17_batch(seed: int, batch: int, device, *, uda_: bool = False,
                     pile: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``bench_extra.py::make_event_batch`` with integer coordinates:
    uniform integer events on 260x346, sorted times, random polarity,
    binned on the host into integer band records (``host_band_bin_folded(
    trilinear=False)``, x-slots). The supervised batch has uniform labels
    at 200x352; the UDA batch none, and N(0, 1) sensor-A images (B, 1,
    120, 216) with uniform labels instead. Sample ``pile``'s events are
    partly piled on the middle pixel (:func:`pile_events`), inside every
    UDA crop."""
    rng = np.random.default_rng(seed)
    h, w = DDD17_SENSOR
    shape = (batch, WINDOWS, DDD17_EVENTS)
    raw = np.zeros(shape + (4,), np.float32)
    raw[..., 0] = rng.integers(0, w, shape)
    raw[..., 1] = rng.integers(0, h, shape)
    raw[..., 2] = np.sort(rng.uniform(0, 5e4, shape), axis=-1)
    raw[..., 3] = rng.integers(0, 2, shape)
    pile_events(raw, pile, w // 2, h // 2)
    valid = np.ones(shape, bool)
    recs, vals, offs = zip(*(voxel_folded.host_band_bin_folded(
        raw[i], valid[i], height=h, width=w, bins=BINS, trilinear=False)
        for i in range(batch)))
    host = {"ev_x": np.stack(recs)[..., 0], "ev_y": np.stack(recs)[..., 1],
            "ev_t": np.stack(recs)[..., 2], "ev_p": np.stack(recs)[..., 3],
            "ev_valid": np.stack(vals), "ev_band_offsets": np.stack(offs)}
    if uda_:
        host["image_a"] = rng.normal(
            size=(batch, 1) + DDD17_CROP).astype(np.float32)
        host["label_a"] = rng.integers(0, DDD17_CLASSES,
                                       (batch,) + DDD17_CROP)
    else:
        host["label"] = rng.integers(0, DDD17_CLASSES,
                                     (batch,) + DDD17_RESIZED)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def build_ddd17(model_name: str, device, seed: int = 0,
                batch: int = DDD17_BATCH,
                lstm_impl_train: Optional[str] = "pallas_int8"):
    """Seeded modules, train state and train step of a DDD17 config."""
    cfg = make_ddd17_cfg(model_name, batch, lstm_impl_train)
    mods = build_modules(cfg, device=device)
    init_params(mods, torch.Generator().manual_seed(seed))
    make = uda.make_train_step if model_name == "ess" else make_train_step
    return mods, init_state(mods), make(mods, builder.make_pipeline(cfg))


def make_pipeline() -> EventPipeline:
    """DSEC: 480x640 rectified float coordinates, per-window normalization,
    40 bottom rows cropped; no flip (``bench.py::make_pipeline``, which is
    ``make_pipeline`` of the DSEC config without training's flip)."""
    return builder.make_pipeline(make_cfg(), train=False)


def make_raw(rng: np.random.Generator, batch: int, windows: int = WINDOWS):
    """Synthetic DSEC windows (``bench.py::make_batch``): uniform rectified
    coordinates, sorted timestamps, random polarity."""
    shape = (batch, windows, EVENTS_PER_WINDOW)
    raw = np.zeros(shape + (4,), np.float32)
    raw[..., 0] = rng.uniform(0, SENSOR_W - 1, shape)
    raw[..., 1] = rng.uniform(0, SENSOR_H - 1, shape)
    raw[..., 2] = np.sort(rng.uniform(0, 5e4, shape), axis=-1)
    raw[..., 3] = rng.integers(0, 2, shape)
    return raw, np.ones(shape, bool)


def pile_events(raw: np.ndarray, sample: Optional[int], x: float,
                y: float) -> None:
    """Move 15 % of each window's events of ``sample`` onto the pixel
    ``(x, y)`` in place (nothing where ``sample`` is None): that sample's
    voxels, and the int8 cells' x, then dwarf the others' in |x|."""
    if sample is not None:
        k = int(0.15 * raw.shape[2])
        raw[sample, :, :k, 0], raw[sample, :, :k, 1] = x, y


def _stack_padded(arrays) -> np.ndarray:
    """Stack per-sample (T, cap_i, ...) arrays along a new first axis,
    zero-padded to the largest capacity."""
    cap = max(a.shape[1] for a in arrays)
    return np.stack([np.pad(a, [(0, 0), (0, cap - a.shape[1])]
                            + [(0, 0)] * (a.ndim - 2)) for a in arrays])


def make_batch(seed: int, batch: int, device, ignore_rows: int = 0,
               pile: Optional[int] = None, wire: str = "band"
               ) -> Dict[str, torch.Tensor]:
    """Host-binned batch on ``device`` with labels at 440x640 (the bottom
    ``ignore_rows`` rows set to the ignore label; sample ``pile``'s events
    partly piled on one pixel, :func:`pile_events`): ghost-folded x-slot
    band records (``wire='band'``, ``ev_band_offsets``) or tile-sorted
    events (``'tile'``, ``ev_tile_offsets``), the same events either
    way."""
    rng = np.random.default_rng(seed)
    raw, valid = make_raw(rng, batch)
    pile_events(raw, pile, SENSOR_W / 2, SENSOR_H / 2)
    bin_fn = (voxel_folded.host_band_bin_folded if wire == "band"
              else voxel_tiled.host_tile_bin)
    recs, vals, offs = zip(*(bin_fn(
        raw[i], valid[i], height=SENSOR_H, width=SENSOR_W, bins=BINS)
        for i in range(batch)))
    recs, vals = _stack_padded(recs), _stack_padded(vals)
    label = rng.integers(0, NUM_CLASSES, (batch, SENSOR_H - CROP, SENSOR_W))
    if ignore_rows:
        label[:, -ignore_rows:] = 255
    host = {"ev_x": recs[..., 0], "ev_y": recs[..., 1], "ev_t": recs[..., 2],
            "ev_p": recs[..., 3], "ev_valid": vals,
            f"ev_{wire}_offsets": np.stack(offs), "label": label}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def make_uda_batch(seed: int, batch: int, device,
                   ignore_rows: int = 0) -> Dict[str, torch.Tensor]:
    """:func:`make_batch`'s events (without event labels) and
    ``bench_extra.py::make_uda_dsec_inputs``'s sensor-A images, N(0, 1) of
    shape (B, 1, 440, 640), with uniform labels (the bottom
    ``ignore_rows`` rows ignored)."""
    out = make_batch(seed, batch, device)
    del out["label"]
    rng = np.random.default_rng(seed + 1)
    shape = (batch, SENSOR_H - CROP, SENSOR_W)
    label = rng.integers(0, NUM_CLASSES, shape)
    if ignore_rows:
        label[:, -ignore_rows:] = 255
    out["image_a"] = torch.from_numpy(
        rng.normal(size=(batch, 1) + shape[1:]).astype(np.float32)).to(device)
    out["label_a"] = torch.from_numpy(label).to(device)
    return out


def make_stream(seed: int, batch: int, device, wire: str = "tile",
                windows: int = WINDOWS_PER_SCORE,
                resets=((0, 1.0),)) -> list:
    """``windows`` consecutive window batches of ``batch`` streams on
    ``device``, one dict per window in the form the streaming steps take:
    (B, N) event columns, ``is_first`` (each ``(w, share)`` of ``resets``
    restarts the first ``share`` of the streams at window ``w``), a label on
    every 20th window, and the wire's offsets: ``'tile'`` host tile-sorted
    events with ``ev_tile_offsets``, ``'band'`` host-folded records with
    ``ev_band_offsets``, ``'raw'`` unsorted events with no offsets. The
    same seed gives the same events on every wire."""
    rng = np.random.default_rng(seed)
    resets = dict(resets)
    raw, valid = make_raw(rng, batch, windows)
    labels = rng.integers(0, NUM_CLASSES,
                          (windows, batch, SENSOR_H - CROP, SENSOR_W))
    key = None
    if wire != "raw":
        bin_fn = (voxel_tiled.host_tile_bin if wire == "tile"
                  else voxel_folded.host_band_bin_folded)
        recs, vals, offs = zip(*(bin_fn(raw[i], valid[i], height=SENSOR_H,
                                        width=SENSOR_W, bins=BINS)
                                 for i in range(batch)))
        raw, valid = _stack_padded(recs), _stack_padded(vals)
        offs, key = np.stack(offs), f"ev_{wire}_offsets"
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = []
    for w in range(windows):
        first = np.arange(batch) < resets.get(w, 0.0) * batch
        b = {"ev_x": raw[:, w, :, 0], "ev_y": raw[:, w, :, 1],
             "ev_t": raw[:, w, :, 2], "ev_p": raw[:, w, :, 3],
             "ev_valid": valid[:, w], "is_first": first}
        if key:
            b[key] = offs[:, w]
        if w % WINDOWS_PER_SCORE == WINDOWS_PER_SCORE - 1:
            b["label"] = labels[w]
        out.append({k: to_dev(v) for k, v in b.items()})
    return out


def run_stream(steps, recon_state, windows: list):
    """Drive ``windows`` through (encode_step, score_step): a window with a
    label is scored. Returns the final state and the summed confusion
    matrix, both on the device (no host synchronization)."""
    encode_step, score_step = steps
    cm = 0
    for batch in windows:
        if "label" in batch:
            recon_state, cm_w = score_step(recon_state, batch)
            cm = cm + cm_w
        else:
            recon_state = encode_step(recon_state, batch)
    return recon_state, cm


def apply_form(mods: ESSModules, form: Optional[str]) -> ESSModules:
    """``mods`` with both rollouts in one of :data:`FORMS`: ``'standard'``
    the 5x5 head and encoder convs on the full-resolution window,
    ``'block_xla'`` the block-space rollout on the library conv,
    ``'block_pallas'`` the block-space rollout on the fused conv kernel
    (exact for eval and streaming, int8 for the train rollout). None leaves
    the builder's form."""
    if form is None:
        return mods
    if form not in FORMS:
        raise ValueError(f"unknown rollout form {form!r}; expected one of "
                         f"{FORMS}")
    if form == "standard":
        return dataclasses.replace(mods, **{
            name: dataclasses.replace(getattr(mods, name), block_space=False,
                                      block_conv_impl=None)
            for name in ("recon_train", "recon_val")})
    if form == "block_xla":
        return with_block_conv_impl(mods, "xla")
    return with_block_conv_impl(mods, "pallas", "pallas_int8")


def build_eval(batch: int, device, seed: int = 0,
               form: Optional[str] = None):
    """Seeded modules and the eval step at ``batch`` samples."""
    mods = build_modules(make_cfg(batch, None), device=device)
    init_params(mods, torch.Generator().manual_seed(seed))
    mods = apply_form(mods, form)
    return mods, make_eval_step(mods, make_pipeline())


def build_stream(batch: int, device, seed: int = 0,
                 form: Optional[str] = None):
    """Seeded modules and the streaming steps at ``batch`` streams."""
    mods = build_modules(make_cfg(batch, None), device=device)
    init_params(mods, torch.Generator().manual_seed(seed))
    mods = apply_form(mods, form)
    return mods, make_streaming_steps(mods, make_pipeline())


def stream_windows_per_sec(mods, steps, windows: list, rounds: int) -> float:
    """Sustained rate over ``rounds`` passes through ``windows`` after one
    warm-up pass: the windows are enqueued back to back with the state
    carried, and the host waits once, on the last confusion matrix."""
    n_streams = windows[0]["ev_x"].shape[0]
    state = mods.recon_val.init_state(n_streams, windows[0]["ev_x"].device)
    state, cm = run_stream(steps, state, windows)
    float(cm.sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, cm = run_stream(steps, state, windows)
    float(cm.sum())
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (rounds * len(windows))
    return n_streams / dt


def build_train(cfg: Config, device, seed: int = 0,
                form: Optional[str] = None):
    """Seeded modules, train state and train step of ``cfg``."""
    mods = build_modules(cfg, device=device)
    init_params(mods, torch.Generator().manual_seed(seed))
    mods = apply_form(mods, form)
    return mods, init_state(mods), make_train_step(mods, make_pipeline())


def build_uda(cfg: Config, device, seed: int = 0):
    """Seeded modules, train state and UDA train step of ``cfg``."""
    mods = build_modules(cfg, device=device)
    init_params(mods, torch.Generator().manual_seed(seed))
    return mods, init_state(mods), uda.make_train_step(mods, make_pipeline())


def windows_per_sec(step: Callable, state, batch: Dict[str, torch.Tensor],
                    iters: int) -> float:
    """Sustained rate over ``iters`` steps after one warm-up step: the
    steps are enqueued back to back and the host waits once, on the last
    loss (as ``bench.py`` fetches one final scalar). ``state`` None: an
    eval step, ``step(batch)``."""
    args = (batch,) if state is None else (state, batch)
    float(step(*args)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*args)
    float(out["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    return batch["ev_x"].shape[0] * batch["ev_x"].shape[1] / dt


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def profile_call(fn: Callable[[], object], out_dir: str, name: str,
                 top: int = 14) -> dict:
    """Trace one call of ``fn`` (after two warm-up calls) with
    ``torch.profiler``; returns wall time and :func:`trace_summary` of the
    Chrome trace, which goes to ``out_dir/<name>_trace.json``. The second
    warm-up call runs under the profiler as its warm-up step: right after
    the tracer starts, the card's first kernels can go unrecorded (seen
    for kernels launched through the port's own library, and in a process
    that had profiled before, for library kernels too)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}_trace.json")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    return {"wall_ms": 1e3 * wall, **trace_summary(path, top)}


def trace_summary(path: str, top: int = 14) -> dict:
    """Device busy time (the union of kernel, copy and set intervals) of a
    ``torch.profiler`` Chrome trace, their span, the idle share of the span
    and the top kernels by device time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"]][0] += float(e["dur"])
        by_name[e["name"]][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span, "trace": path,
            "top": [{"name": n[:120], "ms": t / 1e3, "calls": c,
                     "share": t / busy} for n, (t, c) in ranked]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="trace one headline step into DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the port's train step runs "
                         "its kernels on the GPU only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = card()
    for b in (1, BATCH):
        windows = make_stream(0, b, dev)
        for form, suffix in (("block_pallas", PALLAS_SUFFIX), (None, "")):
            mods, steps = build_stream(b, dev, form=form)
            wps = stream_windows_per_sec(mods, steps, windows, args.iters)
            print(json.dumps({
                "metric": STREAM_METRIC.format("" if b == 1 else f"_b{b}")
                + suffix,
                "value": round(wps, 2), "unit": "windows/s",
                "ms_per_window": round(1e3 * b / wps, 3), "device": name}),
                flush=True)
        if args.profile:
            state = [mods.recon_val.init_state(b, dev)]

            def twenty_windows():
                state[0], cm = run_stream(steps, state[0], windows)
                float(cm.sum())

            print(json.dumps({"profile": profile_call(
                twenty_windows, args.profile, f"stream_b{b}"),
                "windows": len(windows), "device": name}), flush=True)
        del mods, steps, windows
    batch = make_batch(0, BATCH, dev)
    for form, suffix in (("block_pallas", PALLAS_SUFFIX), (None, "")):
        mods, step = build_eval(BATCH, dev, form=form)
        wps = windows_per_sec(step, None, batch, args.iters)
        print(json.dumps({"metric": EVAL_METRIC + suffix,
                          "value": round(wps, 2), "unit": "windows/s",
                          "device": name}), flush=True)
    if args.profile:
        print(json.dumps({"profile": profile_call(
            lambda: float(step(batch)["loss"]), args.profile, "eval_step"),
            "device": name}), flush=True)
    del mods, step
    lines = []
    for impl, form, metric in (
            (None, None, METRIC + "_exact_bf16"),
            ("pallas_int8", "block_pallas", METRIC + PALLAS_SUFFIX),
            ("pallas_int8", None, METRIC)):
        mods, state, step = build_train(make_cfg(BATCH, impl), dev, form=form)
        wps = windows_per_sec(step, state, batch, args.iters)
        lines.append({"metric": metric, "value": round(wps, 2),
                      "unit": "windows/s",
                      "vs_baseline": round(wps / BASELINE_WINDOWS_PER_SEC, 3),
                      "device": name})
        if args.profile and form == "block_pallas":
            print(json.dumps({"profile": profile_call(
                lambda: float(step(state, batch)["loss"]), args.profile,
                "train_step" + PALLAS_SUFFIX), "device": name}), flush=True)
        del mods
    for line in lines[:-1]:
        print(json.dumps(line), flush=True)
    if args.profile:
        print(json.dumps({"profile": profile_call(
            lambda: float(step(state, batch)["loss"]), args.profile,
            "train_step"), "device": name}), flush=True)
    del state, step
    uda_batch = make_uda_batch(0, BATCH, dev)
    mods, uda_state, uda_step = build_uda(make_uda_cfg(BATCH), dev)
    wps = windows_per_sec(uda_step, uda_state, uda_batch, args.iters)
    print(json.dumps({
        "metric": UDA_METRIC, "value": round(wps, 2), "unit": "windows/s",
        "vs_baseline": round(wps / UDA_BASELINE_WINDOWS_PER_SEC, 3),
        "device": name}), flush=True)
    if args.profile:
        print(json.dumps({"profile": profile_call(
            lambda: float(uda_step(uda_state, uda_batch)["loss"]),
            args.profile, "uda_train_step"), "device": name}), flush=True)
    del mods, uda_state, uda_step, uda_batch
    for model_name, kind in (("ess_supervised", "supervised"),
                             ("ess", "uda")):
        ddd_batch = make_ddd17_batch(0, DDD17_BATCH, dev,
                                     uda_=model_name == "ess")
        mods, ddd_state, ddd_step = build_ddd17(model_name, dev)
        wps = windows_per_sec(ddd_step, ddd_state, ddd_batch, args.iters)
        print(json.dumps({
            "metric": DDD17_METRIC.format(kind), "value": round(wps, 2),
            "unit": "windows/s",
            "vs_baseline": round(wps / DDD17_BASELINE_WINDOWS_PER_SEC, 3),
            "device": name}), flush=True)
        if args.profile:
            print(json.dumps({"profile": profile_call(
                lambda: float(ddd_step(ddd_state, ddd_batch)["loss"]),
                args.profile, f"ddd17_{kind}_train_step"), "device": name}),
                flush=True)
        del mods, ddd_state, ddd_step, ddd_batch
    print(json.dumps(lines[-1]), flush=True)


if __name__ == "__main__":
    main()
