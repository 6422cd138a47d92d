"""Benchmark: event windows per second of the DSEC supervised train step on
one NVIDIA GPU.

The port's counterpart of the repository's ``bench.py``, at its shape and
with its synthetic recipe: B=8 x T=20 windows x 100k events, a 480x640
sensor cropped to 440x640, 5 bins, 11 classes, bf16, seeded weights,
host-folded (band, x-slot) binning. The step voxelizes (kernel B1), rolls
the frozen E2VID out on the int8 ConvLSTM kernel (``lstm_impl_train=
'pallas_int8'``), runs the segmentation head forward and backward, the
dice + CE loss and an RAdam update of the head.

Run from the repository root::

    python -m ess_tpu_torch.bench [--iters N] [--profile DIR]

It prints JSON lines under ``bench.py``'s metric names: the exact-bf16
companion (``lstm_impl_train=None``, the exact kernel) first, the headline
last; each names the card and its power limit. ``--profile DIR`` traces one
headline step with ``torch.profiler`` and prints, between the two, device
time by kernel and the device's idle share, with the trace in ``DIR``. It
needs a CUDA device and raises without one; there is no fallback
configuration.
"""

from __future__ import annotations

import argparse
import collections
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
from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
from ess_tpu_torch.ops import voxel_folded
from ess_tpu_torch.train.builder import build_modules, init_params, init_state
from ess_tpu_torch.train.supervised import make_train_step

BASELINE_WINDOWS_PER_SEC = 160.0   # bench.py's estimate for the reference
BATCH = 8
WINDOWS = 20
SENSOR_H, SENSOR_W, CROP = 480, 640, 40
EVENTS_PER_WINDOW = 100_000
BINS = 5
NUM_CLASSES = 11
METRIC = "dsec_supervised_train_event_windows_per_sec_per_chip"


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


def make_pipeline() -> EventPipeline:
    """DSEC: 480x640 rectified float coordinates, per-window normalization,
    40 bottom rows cropped; no flip (``bench.py::make_pipeline``)."""
    return EventPipeline(PipelineConfig(
        sensor_height=SENSOR_H, sensor_width=SENSOR_W, num_bins=BINS,
        normalize=True, crop_bottom=CROP))


def make_raw(rng: np.random.Generator, batch: int):
    """Synthetic DSEC windows (``bench.py::make_batch``): uniform rectified
    coordinates, sorted timestamps, random polarity."""
    shape = (batch, WINDOWS, EVENTS_PER_WINDOW)
    raw = np.zeros(shape + (4,), np.float32)
    raw[..., 0] = rng.uniform(0, SENSOR_W - 1, shape)
    raw[..., 1] = rng.uniform(0, SENSOR_H - 1, shape)
    raw[..., 2] = np.sort(rng.uniform(0, 5e4, shape), axis=-1)
    raw[..., 3] = rng.integers(0, 2, shape)
    return raw, np.ones(shape, bool)


def make_batch(seed: int, batch: int, device,
               ignore_rows: int = 0) -> Dict[str, torch.Tensor]:
    """Host-folded batch on ``device`` with labels at 440x640 (the bottom
    ``ignore_rows`` rows set to the ignore label)."""
    rng = np.random.default_rng(seed)
    raw, valid = make_raw(rng, batch)
    recs, vals, offs = zip(*(voxel_folded.host_band_bin_folded(
        raw[i], valid[i], height=SENSOR_H, width=SENSOR_W, bins=BINS)
        for i in range(batch)))
    cap = max(r.shape[1] for r in recs)
    pad = lambda a: np.pad(a, [(0, 0), (0, cap - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2))
    recs = np.stack([pad(r) for r in recs])
    vals = np.stack([pad(v) for v in vals])
    label = rng.integers(0, NUM_CLASSES, (batch, SENSOR_H - CROP, SENSOR_W))
    if ignore_rows:
        label[:, -ignore_rows:] = 255
    host = {"ev_x": recs[..., 0], "ev_y": recs[..., 1], "ev_t": recs[..., 2],
            "ev_p": recs[..., 3], "ev_valid": vals,
            "ev_band_offsets": np.stack(offs), "label": label}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def build_train(cfg: Config, device, seed: int = 0):
    """Seeded modules, train state and train step of ``cfg``."""
    mods = build_modules(cfg, device=device)
    init_params(mods, torch.Generator().manual_seed(seed))
    return mods, init_state(mods), make_train_step(mods, make_pipeline())


def windows_per_sec(step: Callable, state, batch: Dict[str, torch.Tensor],
                    iters: int) -> float:
    """Sustained rate over ``iters`` steps after one warm-up step: the
    steps are enqueued back to back and the host waits once, on the last
    loss (as ``bench.py`` fetches one final scalar)."""
    float(step(state, batch)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(state, batch)
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


def profile_step(step: Callable, state, batch: Dict[str, torch.Tensor],
                 out_dir: str, top: int = 14) -> dict:
    """Trace one step (after two warm-up steps) with ``torch.profiler``;
    returns wall time, device busy time (the union of kernel, copy and set
    intervals), their span, the idle share of the span and the top kernels
    by device time. The Chrome trace goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(state, batch)["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_step_trace.json")
    prof.export_chrome_trace(path)
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
    return {"wall_ms": 1e3 * wall, "busy_ms": busy / 1e3,
            "span_ms": span / 1e3, "idle_share": 1.0 - busy / span,
            "trace": path,
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
    batch = make_batch(0, BATCH, dev)
    lines = []
    for impl, metric in ((None, METRIC + "_exact_bf16"),
                         ("pallas_int8", METRIC)):
        mods, state, step = build_train(make_cfg(BATCH, impl), dev)
        wps = windows_per_sec(step, state, batch, args.iters)
        lines.append({"metric": metric, "value": round(wps, 2),
                      "unit": "windows/s",
                      "vs_baseline": round(wps / BASELINE_WINDOWS_PER_SEC, 3),
                      "device": name})
        del mods
    print(json.dumps(lines[0]), flush=True)
    if args.profile:
        print(json.dumps({"profile": profile_step(step, state, batch,
                                                  args.profile),
                          "device": name}), flush=True)
    print(json.dumps(lines[1]), flush=True)

if __name__ == "__main__":
    main()
