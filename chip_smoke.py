"""Drive the PyTorch + CUDA port's DSEC eval, train, UDA train and
streaming-eval paths, its DDD17 supervised and UDA steps, its train and
evaluate CLIs (ESS UDA from Cityscapes images on disk included) and its
E2VID reconstruction program once on one NVIDIA GPU, in the rollout form of
``build_modules`` and with the block convs on the fused conv kernel, then
its three kernel tools, then the host event path from an in-memory
recording to the eval and streaming steps.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, the CUDA toolkit (``nvcc``) and ``g++``; it never
imports JAX or the JAX package. Phases, in order (any failure raises and
exits non-zero, with no result line):

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for the f32 plain versions;
2. build: compile the CUDA kernels of ``ess_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel), the host binning library and the image host
   library (``csrc/image_host.cpp``) from the checkout's sources;
3. kernels: each kernel (B1 fold-free voxelizer, B2 exact ConvLSTM cell,
   B2-int8 ConvLSTM cell, B3 halo-tiled voxelizer, B4 fused 3x3 conv, B4-int8
   fused 3x3 conv, B5 fused encoder level, T2 the cell kernels' attribution
   variants, B3-legacy the fold-free voxelizer's full-width band wire, T1
   the C-major head conv with its normalize fused) against its plain
   PyTorch version on the card at the DSEC shapes of the paths, with
   kernel and plain times (CUDA events) and the kernel's bound on this card
   (the larger of bytes over memory rate and operations over peak rate);
   B1 over one step's 160 windows (its row's times) and over 40, also at a
   128-wide sensor (one x-slot); B3 at the streaming B=8 (its row's times)
   and B=1, also with device-side binning, at 10 bins with integer
   coordinates, and on border and tile-edge events; both with the scatter
   core's plan and what ``ptxas -v`` said of it; B4 and B4-int8 at the head and
   first-encoder block shapes (B=2) and at an odd one, with and without
   ReLU and bias, both also at the main path's B=8, where their rows' times
   are taken (B4-int8 with its two prep launches, TOP/s and launches per
   conv), beside the library's conv + bias + ReLU (for B4-int8 not the
   same function), with the plans and what ``ptxas -v`` said of the
   halo-tile kernels; B2 and B2-int8 at the three encoder cells
   at B=2 and at the main path's B=8, where their rows' times are taken
   (TFLOP/s or TOP/s, share of bound, the int8 prep's launches per cell,
   and the library's gate conv alone, which is not the same function),
   with their plan and what ``ptxas -v``
   said of them; B5 (three kernels: the group absmax of u, the conv and
   the gates on the halo-tile core) at the three encoder levels at the
   tools' B=8, in the input form each uses, and from a full-resolution
   input at a small shape with three row tiles (the conv's x and the group
   scales identical, h' and c' within one bf16 ulp, the same bits through
   ``encoder_level_int8``), with its plan and what ``ptxas -v`` said of
   its kernels; T2's four compared modes on both cell bodies at the tools'
   B=8; B3-legacy (the scatter core's band items) at B=8 x T=20 windows of
   100k events on 480x640, also against the x-slot wire (B1) on the same
   events, with its plan and ``ptxas -v``; T1 in both
   output layouts at the tool's B=8, beside the library's conv + bias + ReLU
   on the same normalized window;
4. eval slice: the supervised eval step at full width (E2VID base 32,
   480x640 sensor cropped to 440x640, T=20 windows of 100k events, 5 bins,
   11 classes, bf16, seeded weights, synthetic events) -- checks on its
   output and kernel launch counts at B=2, agreement with the same step on
   the plain versions, and eval-step throughput at B=8 with kernels and with
   plain versions;
5. train slice: the supervised train step at the same width with the train
   rollout on the int8 cell (``bench.py``'s configuration) -- launch counts,
   a finite loss, an updated head and an untouched E2VID over 3 steps at
   B=2, agreement of the first step with the plain versions, and train-step
   throughput at B=8 with int8 kernels, with exact-bf16 kernels and with
   plain versions, and its peak device memory;
5b. UDA slice: the ESS UDA train step at the same width (``bench.py``'s
   DSEC UDA configuration: 440x640 grayscale sensor-A images through the
   ResNet18 front, the train rollout on the int8 cell with its decoder,
   cycle losses, two RAdams) -- launch counts, finite losses, updated
   front, head and batch-norm statistics and an untouched E2VID over 3
   steps at B=2, agreement of the first step with the plain versions, the
   two UDA eval steps once (eval B on the exact cell), and UDA train-step
   throughput at B=8 with int8 kernels and with plain versions, alternated,
   and its peak device memory;
5c. DDD17 slice (``bench_extra.py``'s DDD17 shapes: B=16, T=20 windows of
   32k integer-coordinate events on the 260x346 sensor, 6 classes): B1 over
   a step's 320 windows of integer band records (the padded 264x384 grid's
   pad empty, the stats those of the sensor grid) and B2 and B2-int8 at
   the cells of a 200x352 and a 120x216 window, each against its plain
   version with times and bounds; the supervised train step (int8 cells on
   all levels) and eval step at 200x352, the UDA train step at the
   bottom-anchored 120x216 crop (by JAX's size rule B2-int8 on level 0
   only, B2 on levels 1 and 2) and its eval B step at 200x352 -- launch
   counts, agreement with the plain path (first-step losses, the eval
   slice's bounds), windows/s alternated with the plain path and peak
   memory; then a DDD17 store written to a temporary directory ->
   ``pad_windows_ddd17`` -> integer band binning -> the eval step, with
   the host ingest per window;
5d. the trainer and its CLIs: a DDD17 tree written to a temporary
   directory (seven ``dir*`` folders, event stores with 20 x 32k events
   before each image, 8-bit PNG masks), ``configs/settings_DDD17_
   supervised.yaml`` with only the dataset path, the log directory, two
   epochs and no paired frames changed; ``ess_tpu_torch.cli.train.main``
   in-process (launches a train step and a validation batch, checkpoints,
   ``train/loss`` lines, finite losses, the printed mIoU, the first step
   against the plain versions), a resume from the run (epoch, step, head
   bit for bit, one more epoch with a profiled step) and
   ``cli.evaluate.main`` on the run's checkpoints (within 0.5 mIoU of the
   run's last validation) -- ms a step in the Trainer and through the
   loader, windows/s, the idle share, peak memory, the host ingest and the
   loader alone;
5e. ESS UDA from disk: a Cityscapes tree written to the same directory
   (2048x1024 RGB frames, rows filtered by a mix of Sub, Up, Average and
   Paeth, gray ``labelIds`` masks) and grayscale frames beside phase 5d's
   validation masks; ``configs/settings_DDD17.yaml`` with only its two
   dataset paths, the log directory and two epochs changed, through
   ``ess_tpu_torch.cli.train.main`` in-process (sensor A the
   ``Cityscapes_gray`` image set read with the port's PNG decoder and cv2-free
   augmentation): launches a train step, an event validation batch and an
   image one, finite losses, the three printed mIoUs, checkpoints, the
   first step against the plain versions; one more epoch with a profiled
   step -- ms a step in the Trainer and through the loaders, the idle
   share, peak memory, the decode of a frame on one thread (and its
   parts) and the image loader's samples/s on 1 and 8 threads at the
   200x352 crop and the 440x640 full frame;
5f. the reconstruction program: ``ess_tpu_torch.cli.reconstruct.main``
   in-process on the DAVIS346 sensor (260x346, padded to 264x352) with a
   seeded E2VID-lightweight checkpoint in the upstream ``.pth.tar`` layout
   (f32, base 32), on written ``t x y p`` streams at ~1M events/s: ``-N
   10000`` over 60 windows, ``-T 50`` over 20 and ``--color -N 20000`` over
   30 (read from a zip), each on the kernel path and on B3's plain version
   -- one B3 launch a window and no other kernel, the frames (one PNG a
   window, 260x346 gray or 260x346x3) held kernel against plain; B3's grid
   on every ``-N`` and ``-T`` window against its plain version on the CPU;
   ``python -m ess_tpu_torch.cli.reconstruct -N 10000`` once in its own
   process, its frames against the in-process run's; windows/s, peak
   memory, a window's text parse, host-to-device copy, voxelizer, rollout
   step and PNG write each alone, and the idle share of a profiled 10-window
   run of the program (set-up included) and of windows 10-19 through the
   program's per-window body with the model built (steady state);
6. streaming slice: the streaming eval steps at the same width, at B=1 and
   at B=8 streams: 40 carried-state windows with a state reset at window 0
   and, for half of the streams, at window 20, a scored window every 20th,
   on the tile wire (host tile offsets), the raw wire (no offsets) and the
   band wire -- launch counts per wire, agreement of the confusion matrix
   and the final latent with the plain versions and between the wires, and
   windows/s, ms per window and the profiler's device idle share;
7. block-conv slice: the eval step (B=8), the train step (B=8, int8 cell and
   int8 block convs) and streaming (B=8 and B=1, 40 windows, tile wire) with
   the head and first-encoder convs on the fused conv kernel
   (``block_conv_impl='pallas'``, train rollout ``'pallas_int8'``) --
   launch counts (two per window), agreement with the plain versions and
   with the standard 5x5 form, and each rate beside the block-space form on
   the library conv and the standard 5x5 form, alternated in one run;
8. kernel tools: ``ess_tpu_torch.tools.bench_level`` (the fused level
   beside the split path: library stride-2 conv, then the int8 cell) and
   ``ess_tpu_torch.tools.bench_lstm_breakdown`` (the cell variants, both
   bodies) through their ``main`` at B=8 and the three encoder levels of a
   440x640 window, 20-step carried chains -- their lines, launch counts,
   the level's and the split path's error against the f32 chain beside the
   JAX test's bounds (enforced at a small shape, reported at the DSEC
   shapes), and a 20-step fused chain against the plain chain at the same
   B=8 shapes, through ``encoder_level_int8``; ``ess_tpu_torch.tools.
   bench_head`` (T1 in both layouts beside the relayout + library conv) at
   its B=8, with its launch counts and the variants' agreement;
9. host event path: an in-memory DSEC-shaped recording (20M events on
   480x640, a rectify map with sub-pixel offsets, labels every ~0.3 s)
   through ``DSECSequence.from_store`` (slicer, then the fused native
   rectify + band binning on both band wires: 5 x-slots and full-width
   bands) -> ``BatchLoader`` (pinned collate ring) -> ``prefetch_to_device``
   -> the eval step at B=8, T=20 windows of 100k events, with the two
   wires' outputs held against each other, and through ``SequenceRecurrent``
   -> ``run_streaming_eval`` at B=1 on both wires -- host ingest ms per
   window, launch counts, windows/s and the device idle share.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ess_tpu_torch import bench, kernels  # noqa: E402
from ess_tpu_torch.bench import (  # noqa: E402
    BINS, CROP, SENSOR_H, SENSOR_W, make_batch, make_raw)
from ess_tpu_torch.data import ddd17, dsec, loader, native, png  # noqa: E402
from ess_tpu_torch.data.pipeline import AugmentParams, to_soa  # noqa: E402
from ess_tpu_torch.data.slicer import (  # noqa: E402
    ArrayEventStore, DDD17EventStore)
from ess_tpu_torch.models import layers  # noqa: E402
from ess_tpu_torch.ops import (  # noqa: E402
    batch_voxel, conv3x3, conv_halo, conv_lstm, head_cmajor, level,
    voxel_folded, voxel_scatter, voxel_tiled)
from ess_tpu_torch.ops.voxel import (  # noqa: E402
    masked_time_norm, normalize_from_stats, normalize_nonzero)
from ess_tpu_torch.tools import (  # noqa: E402
    REPEATS as CHAIN_REPEATS, STEPS as CHAIN_STEPS, bench_head, bench_level,
    bench_lstm_breakdown)
from ess_tpu_torch.train import builder, uda  # noqa: E402
from ess_tpu_torch.train.builder import build_modules, init_params  # noqa: E402
from ess_tpu_torch.train.streaming import run_streaming_eval  # noqa: E402
from ess_tpu_torch.train.supervised import make_eval_step  # noqa: E402

WINDOWS, EVENTS, CLASSES = bench.WINDOWS, bench.EVENTS_PER_WINDOW, bench.NUM_CLASSES
CELL_SHAPES = [(2, 64, 220, 320), (2, 128, 110, 160), (2, 256, 55, 80)]
# block convs (name, B, C_in, C_out, H, W): the E2VID head conv and the first
# encoder's conv over 2x2 space-to-depth blocks of a 440x640 window, and an
# odd shape (other tile widths, a ragged last pixel tile)
CONV_SHAPES = [("head", 2, 20, 128, 220, 320),
               ("encoder 0", 2, 128, 64, 220, 320),
               ("odd", 2, 24, 16, 13, 40)]
KERNEL_NAMES = ("B1", "B2", "B2-int8", "B3", "B4", "B4-int8", "B5", "T2",
                "B3-legacy", "T1")
# fused encoder level (u shape, hidden channels, u_s2d): the three encoder
# levels of a 440x640 window at the tools' B=8, the shapes phase 8 drives, in
# the input form each uses, and level 0 from a full-resolution input at a
# small shape with three row tiles of 13
LEVEL_SHAPES = list(bench_level.LAYERS)
LEVEL_ODD = ((1, 32, 78, 40), 64, False)
# the attribution tools at a shape close to the JAX level test's (16 output
# rows, one row tile; channel counts the kernels take)
LEVEL_SMALL = [((2, 8, 32, 32), 32, False), ((2, 32, 16, 16), 32, True)]

# tolerances, stated before any run on the card
VOXEL_ATOL = 1e-4      # normalized grid: same f32 weights, atomic order
LSTM_H_ATOL = 2e-2     # bf16 state, f32 accumulation in another order
LSTM_C_ATOL = 3e-2
# Slice, kernel path vs plain path. The logits are bf16 and the seeded
# head's logits have many near ties (std ~0.7 over 11 classes), so an argmax
# flips wherever the top-2 gap is within the bf16 noise of 20 recurrent
# windows; agreement is bounded on all pixels and, tighter, on pixels whose
# top-2 gap in the plain path exceeds SLICE_GAP.
SLICE_LATENT_REL = 0.05    # latent8 relative max |d|
SLICE_PRED_AGREE = 90.0    # % of all pixels with the same argmax
SLICE_GAP = 0.1            # logit units
SLICE_PRED_AGREE_CLEAR = 99.5
# B2-int8 vs the plain int8 cell: both accumulate the same integers exactly
# and round every f32 operation of the epilogue alike, so h' and c' can
# differ only where the kernel's expf/tanhf and torch's round differently
# before the bf16 store: at most one bf16 ulp (+1e-6 for values next to 0).
INT8_ULP_SLACK = 1e-6
# Against the exact plain cell, the JAX package's int8 bounds
# (tests/test_conv_lstm_pallas.py, measured there on a 2x12x20x16 cell) are
# reported beside the DSEC-shape numbers, not enforced: the x scale is the
# absmax over the whole tensor, which grows with its size.
JAX_INT8_DH_MAX, JAX_INT8_DH_MEAN, JAX_INT8_DC_MAX = 0.05, 6e-3, 0.08
# B4 vs the plain conv: both accumulate bf16 products in f32 (in other
# orders) and round once, so they differ by at most one bf16 ulp except where
# a sum lies next to a rounding boundary of a neighbouring binade.
CONV_ULP_SHARE = 0.999     # share of values within one bf16 ulp
CONV_MAX_REL = 2.0 ** -7   # max |d| over the plain output's absmax
# B4-int8 vs the plain int8 conv: bit-identical (exact integer accumulators,
# the same f32 operations in the same order). Against the exact plain conv,
# the JAX package's bounds (tests/test_conv3x3_pallas.py, max and mean error
# over the output's absmax, measured there with the ReLU on) are enforced at
# the odd shape, which is close to that test's, with the ReLU on, and
# reported elsewhere: without the ReLU the absmax-relative mean error is
# larger, and the x scale grows with the size of the tensor.
JAX_CONV_INT8_MAX, JAX_CONV_INT8_MEAN = 0.02, 2e-3
# B5 vs its plain version: the group scales are maxima of the same values and
# x is the same f32 operations on exact integers, so amax_u and amax_x are
# identical; h' and c' within one bf16 ulp as B2-int8 (INT8_ULP_SLACK). After
# a 20-step carried chain, each on its own state, a state value one ulp off
# can move an int8 code of h at the next step:
CHAIN_ULP_SHARE = 0.999    # share of values within one bf16 ulp
CHAIN_MAX_ABS = 0.05
# Against the f32 reference chain, the JAX test's bounds
# (tests/test_level_pallas.py:28-37, measured there on a 2x8x16x8 level) are
# enforced at LEVEL_SMALL and reported at the DSEC shapes: a group's absmax
# grows with the size of the group.
JAX_LEVEL_DH_MAX, JAX_LEVEL_DC_MAX, JAX_LEVEL_DH_MEAN = 0.06, 0.12, 5e-3
# T2 vs the plain variants. Int8 body: within one bf16 ulp for ptw_mul and
# no_ptw (the same f32 operations on exact integers), on VARIANT_ULP_SHARE of
# the values for ptw_bf16 (a tanhf that rounds to the other bf16 neighbour
# moves the result by an ulp or two; all within VARIANT_BF16_INT8_MAX). bf16
# body: f32 accumulation in another order, then one bf16 rounding of values
# of any size: max |d| within VARIANT_REL of the plain output's absmax,
# ptw_bf16 (values below 2) within VARIANT_BF16_MAX.
VARIANT_ULP_SHARE = 0.999
VARIANT_BF16_INT8_MAX = 2.0 ** -5
VARIANT_REL = 2.0 ** -6
VARIANT_BF16_MAX = 2.0 ** -4
# Train slice, int8-kernel path vs plain path on the first step.
TRAIN_LATENT_REL = 0.05    # latent8 relative max |d|
TRAIN_LOSS_REL = 0.02      # loss relative difference
# UDA slice (phase 5b): keys of the train step's losses on DSEC without
# event labels.
UDA_LOSS_KEYS = sorted(
    ["semseg_sensor_a_loss", "loss"]
    + [f"cycle_latent_{s}x_sensor_b_to_sensor_a_loss" for s in (2, 4, 8)]
    + [f"cycle_pred_{s}x_sensor_b_to_sensor_a_loss" for s in (1, 2, 4)])
# Streaming slice: kernel path vs plain path and wire vs wire, per batch
# size, on the final latent and on the last scored window's argmax, under
# the eval slice's bounds (SLICE_*): 40 carried windows reorder as many sums
# as the eval step's 20.
STREAM_WINDOWS = 40
# Host event path (phase 9): an in-memory recording of DATA_EVENTS events at
# ~2M events/s, DATA_SAMPLES labeled samples (two B=8 eval batches per band
# wire) and DATA_STREAM windows streamed at B=1 per wire; both band wires
# (DSECSequence binnings: 5 x-slots per band, B1; full-width bands,
# B3-legacy) are held against each other under the slice bounds (SLICE_*).
DATA_EVENTS = 20_000_000
DATA_SAMPLES = 16
DATA_STREAM = 60
DATA_WIRES = ("folded", "folded_bands")

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of ``nbytes``
    over the memory rate and ``ops`` over the peak rate of ``kind``, and
    which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def voxel_bound(live_events: int, n_offsets: int, out_floats: int,
                corners: int = 8):
    """Bound of a voxelizer call: 16 B per event read (x, y, ts, pol), the
    offsets, the outputs written once; ``corners`` x 4 f32 operations
    (three multiplies and an add) per event: 8 corners of the trilinear
    tent, 2 of an integer record's (its x and y fractions are 0)."""
    return bound(16.0 * live_events + 4.0 * n_offsets + 4.0 * out_floats,
                 4.0 * corners * live_events, "f32")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


SPIN_CYCLES = 50_000_000   # ~25 ms of a spin kernel at the H100's clocks


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events). A spin
    kernel holds the stream while the host enqueues the calls, so that a
    call whose host work outlasts its device work is still timed on the
    device alone."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_cell(x, h, c, w, b, *, impl="pallas", prepared=None):
    """The plain version of the cell ``impl`` names at x's shape (the int8
    size rule's route)."""
    fn = (conv_lstm.conv_lstm_int8_ref
          if conv_lstm.int8_route(impl, x.shape) == "pallas_int8"
          else conv_lstm.conv_lstm_ref)
    return fn(x, h, c, w, b)


def plain_conv(x, w, b, *, relu=True, impl="xla", prepared=None):
    """The plain version of the fused conv ``impl`` names at x's shape (the
    int8 size rule's route)."""
    fn = (conv3x3.conv3x3_int8_ref
          if conv_lstm.int8_route(impl, x.shape) == "pallas_int8"
          else conv3x3.conv3x3_ref)
    return fn(x, w, b, relu=relu)


@contextlib.contextmanager
def plain_versions():
    """Route the eval and train paths through the kernels' plain PyTorch
    versions (on the same device tensors) for the comparison runs."""
    saved = (batch_voxel.voxelize_folded, batch_voxel.voxelize_tiled,
             layers.conv_lstm_cell, layers.conv3x3_fused)
    batch_voxel.voxelize_folded = voxel_folded.voxelize_folded_ref
    batch_voxel.voxelize_tiled = voxel_tiled.voxelize_tiled_ref
    layers.conv_lstm_cell = plain_cell
    layers.conv3x3_fused = plain_conv
    try:
        yield
    finally:
        (batch_voxel.voxelize_folded, batch_voxel.voxelize_tiled,
         layers.conv_lstm_cell, layers.conv3x3_fused) = saved


def reset_counts() -> None:
    voxel_folded.launches = 0
    conv_lstm.launches = 0
    conv_lstm.launches_int8 = 0
    conv_lstm.launches_int8_prep = 0
    voxel_tiled.launches = 0
    conv3x3.launches = 0
    conv3x3.launches_int8 = 0
    conv3x3.launches_int8_prep = 0
    level.launches = 0
    conv_lstm.launches_variant = 0
    voxel_folded.launches_legacy = 0
    head_cmajor.launches = 0


def read_counts(sync: bool = True) -> tuple:
    """Launches of the kernels (KERNEL_NAMES order) since
    :func:`reset_counts` (the wrappers count on the host as they launch;
    ``sync`` also waits for the device)."""
    if sync:
        torch.cuda.synchronize()
    return (voxel_folded.launches, conv_lstm.launches,
            conv_lstm.launches_int8, voxel_tiled.launches,
            conv3x3.launches, conv3x3.launches_int8, level.launches,
            conv_lstm.launches_variant, voxel_folded.launches_legacy,
            head_cmajor.launches)


def show_counts(counts) -> str:
    return ", ".join(f"{k} {n}" for k, n in zip(KERNEL_NAMES, counts))


def all_counts(want) -> tuple:
    """``want`` names the first kernels' counts; the rest are 0."""
    return tuple(want) + (0,) * (len(KERNEL_NAMES) - len(want))


def need_counts(counts, want) -> None:
    want = all_counts(want)
    if tuple(counts) != want:
        raise AssertionError(f"launch counts {show_counts(counts)}; want "
                             f"{show_counts(want)}")


def add_launches(kern_rows, path: str, counts) -> None:
    """Book one path's launch counts on the kernel rows (KERNEL_NAMES
    order)."""
    for row, n in zip(kern_rows, counts):
        by_path = row.setdefault("launches_by_path", {})
        by_path[path] = by_path.get(path, 0) + n
        row["launches"] = sum(by_path.values())


def int8_cells(b: int, hh: int, ww: int, base: int = 32) -> tuple:
    """(exact, int8) cells of a window at batch ``b`` and rollout size
    ``hh`` x ``ww`` for ``'pallas_int8'``: the JAX package's size rule
    (``conv_lstm.int8_size_rule``) on each encoder cell's input."""
    int8 = sum(conv_lstm.int8_size_rule(
        (b, base * 2 ** (i + 1), hh >> (i + 1), ww >> (i + 1)))
        for i in range(3))
    return 3 - int8, int8


def bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at max(|a|, |b|): 2^(e - 8) for values in [2^(e-1), 2^e)."""
    _, e = torch.frexp(torch.maximum(a.float().abs(), b.float().abs()))
    return torch.ldexp(torch.ones_like(a, dtype=torch.float32), e - 8)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); the port runs its kernels on the GPU only")
    print(bench.card(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return dev


def phase_build():
    t0 = time.perf_counter()
    kernels.get_lib()
    log(f"built CUDA kernels in {kernels.build_seconds:.1f} s "
        f"({kernels.BUILD_DIR})")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or line.endswith(".cu:"):
            log(f"  {line.strip()}")
    native.get_lib()
    png.get_lib()
    log(f"built host binning and the image host library in "
        f"{time.perf_counter() - t0:.1f} s total")


def log_scatter_plan(what: str, plan) -> None:
    """The scatter core's plan of a launch (``ptxas -v`` reports static
    shared memory only)."""
    log(f"  plan {what}: {plan.n_items} items ({plan.n_windows} windows x "
        f"{plan.n_tiles} tiles of {plan.tile_h}x128), {plan.bufs} "
        f"accumulator(s) of {plan.acc_bytes} B a block, {plan.threads} "
        f"threads, {plan.blocks_per_sm} blocks an SM, grid {plan.grid} "
        f"persistent blocks ({plan.order}; records a {plan.mode}, "
        f"{plan.n_groups} groups a window)")


def check_voxelizer(dev):
    """B1 against its plain version over one step's B x T = 160 windows,
    where its row's times are taken, and timed over 40 windows too."""
    n_win = 8 * WINDOWS
    rng = np.random.default_rng(1)
    raw, valid = make_raw(rng, 8)
    raw, valid = raw.reshape(n_win, EVENTS, 4), valid.reshape(n_win, EVENTS)
    r, v, o = voxel_folded.host_band_bin_folded(
        raw, valid, height=SENSOR_H, width=SENSOR_W, bins=BINS)
    log(f"B1: {n_win} windows x {EVENTS} events -> {int(o[:, -1].mean())} "
        f"folded records per window (capacity {r.shape[1]})")
    x, y, t, p = (torch.from_numpy(np.ascontiguousarray(r[..., i])).to(dev)
                  for i in range(4))
    vd = torch.from_numpy(v).to(dev)
    offs = torch.from_numpy(o).to(dev)
    ts = masked_time_norm(t, vd, BINS).contiguous()
    pol = torch.where(vd, p, torch.zeros_like(p)).contiguous()
    th = voxel_folded.tile_h_for_bins(BINS)
    kw = dict(bins=BINS, height=-(-SENSOR_H // th) * th, width=SENSOR_W)
    n0 = voxel_folded.launches
    grid_k, stats_k = voxel_folded.voxelize_folded(x, y, ts, pol, offs, **kw)
    torch.cuda.synchronize()
    if voxel_folded.launches != n0 + 1:
        raise AssertionError("voxelize_folded did not launch B1 once")
    grid_p, stats_p = voxel_folded.voxelize_folded_ref(x, y, ts, pol, offs,
                                                       **kw)
    err_raw = (grid_k - grid_p).abs().max().item()
    err = (normalize_from_stats(grid_k, stats_k)
           - normalize_from_stats(grid_p, stats_p)).abs().max().item()
    log(f"B1 voxel_folded ({n_win} windows): max|d| raw grid "
        f"{err_raw:.3e}, normalized grid {err:.3e} (bound {VOXEL_ATOL})")
    if not err <= VOXEL_ATOL:
        raise AssertionError(f"B1 disagrees with its plain version: {err}")
    del grid_p
    log_ptxas("B1", "scatter_kernelILi0E")
    row = None
    for n in (n_win, 2 * WINDOWS):
        cols = [a[:n] for a in (x, y, ts, pol, offs)]
        log_scatter_plan(f"B1 at {n} windows", voxel_scatter.scatter_plan(
            BINS, kw["height"], kw["width"], n,
            conv_halo.sm_count(x.device)))
        ms = cuda_ms(lambda: voxel_folded.voxelize_folded(*cols, **kw), 20)
        plain_ms = cuda_ms(lambda: voxel_folded.voxelize_folded_ref(
            *cols, **kw), 3)
        bound_ms, bound_by = voxel_bound(int(o[:n, -1].sum()), o[:n].size,
                                         grid_k[:n].numel() + 3 * n)
        log(f"B1 time for {n} windows: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), share "
            f"of bound {100.0 * bound_ms / ms:.1f}%")
        row = row or (ms, plain_ms, bound_ms, bound_by)
    del grid_k, x, y, t, p, vd, ts, pol
    torch.cuda.empty_cache()
    err = max(err, check_voxelizer_one_slot(dev))
    ms, plain_ms, bound_ms, bound_by = row
    return {"name": "voxel_folded", "route": "cuda",
            "source": "ess_tpu_torch/csrc/voxel_folded.cu",
            "replaces": "ess_tpu/ops/voxel_pallas.py:334",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def edge_events(rng, n_win: int, n: int, h: int, w: int, th: int):
    """(n_win, n, 4) raw windows with, on each axis, 3 events in 16 in the
    (-1, 0) border zone, just below a tile-row or tile-column boundary or on
    the last row or column (more would pile thousands of events on a few
    cells, where f32 sums differ by more than the bound), plus validity
    (the last tenth is padding)."""
    raw = np.zeros((n_win, n, 4), np.float32)
    frac = rng.uniform(0.02, 0.98, (2, n_win, n)).astype(np.float32)
    kind = rng.integers(0, 16, (2, n_win, n))
    for axis, (dim, step) in enumerate(((w, 128), (h, th))):
        edge = rng.integers(1, dim // step + 1, (n_win, n)) * step - 1
        raw[..., axis] = np.select(
            [kind[axis] == 0, kind[axis] == 1, kind[axis] == 2],
            [-frac[axis], np.minimum(edge + frac[axis], dim - 0.01),
             dim - 1 + frac[axis] * 0.99],
            rng.uniform(0, dim - 1, (n_win, n)))
    raw[..., 2] = np.sort(rng.uniform(0, 5e4, (n_win, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (n_win, n))
    valid = np.ones((n_win, n), bool)
    valid[:, n - n // 10:] = False
    return raw, valid


def check_voxelizer_one_slot(dev) -> float:
    """B1 at a 128-wide sensor: one x-slot per band, the case the TPU
    package serves with its halo kernel body in pre-folded mode."""
    h, w, n_win, n = 120, 128, 8, 20000
    rng = np.random.default_rng(6)
    raw, valid = edge_events(rng, n_win, n, h, w,
                             voxel_folded.tile_h_for_bins(BINS))
    r, v, o = voxel_folded.host_band_bin_folded(raw, valid, height=h,
                                                width=w, bins=BINS)
    if o.shape[1] != h // voxel_folded.tile_h_for_bins(BINS) + 1:
        raise AssertionError("expected one x-slot per band, offsets "
                             f"{o.shape}")
    cols = [torch.from_numpy(np.ascontiguousarray(r[..., i])).to(dev)
            for i in range(4)] + [torch.from_numpy(v).to(dev)]
    offs = torch.from_numpy(o).to(dev)
    kw = dict(num_bins=BINS, height=h, width=w, normalize=True)
    got = batch_voxel.voxelize_band(*cols, offs, **kw)
    with plain_versions():
        want = batch_voxel.voxelize_band(*cols, offs, **kw)
    err = (got - want).abs().max().item()
    log(f"B1 at a {h}x{w} sensor (one x-slot, {n_win} windows x {n} border "
        f"and edge events): normalized grid max|d| {err:.3e} (bound "
        f"{VOXEL_ATOL})")
    if not err <= VOXEL_ATOL:
        raise AssertionError(f"B1 (one slot) disagrees with its plain "
                             f"version: {err}")
    return err


def check_voxel_tiled(dev):
    """B3 against its plain version at the DSEC shape with host offsets and
    with device-side binning, at 10 bins / tile height 10 with integer
    coordinates, and on border and tile-edge events."""
    n_win = 8
    rng = np.random.default_rng(8)
    raw, valid = make_raw(rng, n_win, 1)
    raw, valid = raw[:, 0], valid[:, 0]
    valid[:, EVENTS - EVENTS // 50:] = False             # some padding
    th = voxel_tiled.tile_h_for_bins(BINS)
    kw = dict(bins=BINS, height=-(-SENSOR_H // th) * th, width=SENSOR_W)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def kernel_inputs(raw_, valid_):
        x, y, t, p = (to_dev(raw_[..., i]) for i in range(4))
        vd = to_dev(valid_)
        ok = vd & (x > -1) & (x < SENSOR_W) & (y > -1) & (y < SENSOR_H)
        ts = masked_time_norm(t, vd, BINS).contiguous()
        pol = torch.where(ok, torch.where(p > 0, 1.0, -1.0), 0.0)
        return x, y, ts, pol.contiguous(), ok

    def compare(what, args):
        got = voxel_tiled.voxelize_tiled(*args, **kw)
        want = voxel_tiled.voxelize_tiled_ref(*args, **kw)
        torch.cuda.synchronize()
        e_raw = (got - want).abs().max().item()
        e = (normalize_nonzero(got) - normalize_nonzero(want)).abs().max() \
            .item()
        log(f"B3 voxel_tiled, {what}: max|d| raw grid {e_raw:.3e}, "
            f"normalized grid {e:.3e} (bound {VOXEL_ATOL})")
        if not e <= VOXEL_ATOL:
            raise AssertionError(f"B3 ({what}) disagrees with its plain "
                                 f"version: {e}")
        return got, e

    # host offsets
    r, v, o = voxel_tiled.host_tile_bin(raw, valid, height=SENSOR_H,
                                        width=SENSOR_W, bins=BINS)
    x, y, ts, pol, _ = kernel_inputs(r, v)
    host_args = (x, y, ts, pol, to_dev(o))
    grid_host, err = compare(f"{n_win} windows x {EVENTS} events, host "
                             "offsets", host_args)
    # device-side binning of the unsorted events
    x, y, ts, pol, ok = kernel_inputs(raw, valid)
    dev_args = voxel_tiled.bin_events_device(x, y, ts, pol, ok, **kw)
    if not torch.equal(dev_args[4], host_args[4]):
        raise AssertionError("bin_events_device and host_tile_bin disagree "
                             "on the tile offsets")
    grid_dev, e = compare("the same events through bin_events_device",
                          dev_args)
    err = max(err, e)
    e = (normalize_nonzero(grid_dev) - normalize_nonzero(grid_host)).abs() \
        .max().item()
    log(f"B3 host binning vs device binning: normalized grid max|d| {e:.3e}")
    if not e <= VOXEL_ATOL:
        raise AssertionError(f"B3 host and device binning disagree: {e}")

    def through_voxelize_tile(what, raw_, valid_, **opts):
        """The wrapper above the kernel (voxelize_tile), kernel vs plain."""
        cols = [to_dev(raw_[..., i]) for i in range(4)] + [to_dev(valid_)]
        okw = dict(num_bins=BINS, height=SENSOR_H, width=SENSOR_W,
                   normalize=True, **opts)
        n0 = voxel_tiled.launches
        got = batch_voxel.voxelize_tile(*cols, **okw)
        if voxel_tiled.launches != n0 + 1:
            raise AssertionError("voxelize_tile did not launch B3")
        with plain_versions():
            want = batch_voxel.voxelize_tile(*cols, **okw)
        e = (got - want).abs().max().item()
        log(f"B3 through voxelize_tile, {what}: grid {tuple(got.shape)}, "
            f"normalized max|d| {e:.3e} (bound {VOXEL_ATOL})")
        if not e <= VOXEL_ATOL:
            raise AssertionError(f"B3 ({what}) disagrees with its plain "
                                 f"version: {e}")
        return e

    err = max(err, through_voxelize_tile(
        "10 bins / tile height 10, integer coordinates (separate_pol)",
        np.concatenate([np.floor(raw[..., :2]), raw[..., 2:]], -1), valid,
        separate_pol=True, trilinear=False))
    edge_raw, edge_valid = edge_events(rng, n_win, EVENTS, SENSOR_H,
                                       SENSOR_W, th)
    err = max(err, through_voxelize_tile(
        "events in (-1, 0), on tile edges and on the last row and column",
        edge_raw, edge_valid, trilinear=True))

    log_ptxas("B3", "scatter_kernelILi1E")
    sort_ms = cuda_ms(lambda: voxel_tiled.bin_events_device(
        x, y, ts, pol, ok, **kw), 10)
    log(f"B3: bin_events_device (torch.sort + searchsorted, outside the "
        f"kernel) {sort_ms:.3f} ms for {n_win} windows")
    row = None
    for n in (n_win, 1):               # streaming at B=8 and at B=1
        cols = [a[:n] for a in host_args]
        log_scatter_plan(f"B3 at {n} windows", voxel_scatter.scatter_plan(
            BINS, kw["height"], kw["width"], n,
            conv_halo.sm_count(x.device)))
        ms = cuda_ms(lambda: voxel_tiled.voxelize_tiled(*cols, **kw), 20)
        plain_ms = cuda_ms(lambda: voxel_tiled.voxelize_tiled_ref(
            *cols, **kw), 5)
        bound_ms, bound_by = voxel_bound(int(o[:n, -1].sum()), o[:n].size,
                                         grid_host[:n].numel())
        log(f"B3 time for {n} windows: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"share of bound {100.0 * bound_ms / ms:.1f}%")
        row = row or (ms, plain_ms, bound_ms, bound_by)
    ms, plain_ms, bound_ms, bound_by = row
    return {"name": "voxel_tiled", "route": "cuda",
            "source": "ess_tpu_torch/csrc/voxel_tiled.cu",
            "replaces": "ess_tpu/ops/voxel_pallas.py:205",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def cell_inputs(g, dev, b, ch, hh, ww, *, int8: bool):
    """Seeded operands of one encoder cell (CX = CH = ch) on the card: x
    (post-ReLU for the int8 cell, as the encoder's conv output is), h, c,
    the gate weight at fan-in scale and the bias."""
    cl_ = torch.channels_last
    mk = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale
    x = mk(b, ch, hh, ww)
    x = torch.relu(x) * 2 if int8 else x
    x = x.to(dev, torch.bfloat16).contiguous(memory_format=cl_)
    h = torch.tanh(mk(b, ch, hh, ww)).to(dev, torch.bfloat16).contiguous(
        memory_format=cl_)
    c = mk(b, ch, hh, ww).to(dev, torch.bfloat16).contiguous(memory_format=cl_)
    w = mk(4 * ch, 2 * ch, 3, 3, scale=(18 * ch) ** -0.5).to(dev)
    bias = mk(4 * ch, scale=0.05 if int8 else 0.1).to(dev)
    return x, h, c, w, bias


def cell_bound(x, w, bias, kind: str):
    """Bound of one cell call: x, h, c read and h', c' written in bf16, f32
    weights and bias; 2 operations per multiply-add of the gate conv."""
    b, ch, hh, ww = x.shape
    ops = 2.0 * b * hh * ww * 9 * 2 * ch * 4 * ch
    return ops, bound(2.0 * 5 * x.numel() + 4.0 * (w.numel() + bias.numel()),
                      ops, kind)


def library_gate_conv(x, h, w, bias):
    """The library's gate conv alone (``F.conv2d`` with bias on the
    channels-last bf16 concat(x, h), built outside the timing): a yardstick
    for the product, not the same function (no pointwise)."""
    xh = torch.cat([x, h], 1).contiguous(memory_format=torch.channels_last)
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bl = bias.to(torch.bfloat16)
    return lambda: torch.nn.functional.conv2d(xh, wl, bl, padding=1)


def check_cells(dev, *, int8: bool):
    """B2 (exact) or B2-int8 against its plain version at CELL_SHAPES (B=2,
    logged) and at the main path's B=8 (the three encoder cells of one
    window), where the row's times are taken, beside the library's gate
    conv alone; the int8 cell's prep launches per cell."""
    # the int8 cell at every shape: level 2 at B=2 is below the size rule
    name, impl = (("B2-int8", "pallas_int8_interpret") if int8
                  else ("B2", "pallas"))
    kind, unit = ("int8", "TOP/s") if int8 else ("bf16", "TFLOP/s")
    plain = conv_lstm.conv_lstm_int8_ref if int8 else conv_lstm.conv_lstm_ref
    g = torch.Generator().manual_seed(5 if int8 else 2)
    err = ms = plain_ms = bound_ms = lib_ms = 0.0
    bound_by = set()
    for b8 in (False, True):
        for b, ch, hh, ww in CELL_SHAPES:
            b = 8 if b8 else b
            x, h, c, w, bias = cell_inputs(g, dev, b, ch, hh, ww, int8=int8)
            prep = conv_lstm.prepare_cell_weights(w, impl)
            h_p, c_p = plain(x, h, c, w, bias)
            n0, p0 = read_counts(), conv_lstm.launches_int8_prep
            h_k, c_k = conv_lstm.conv_lstm_cell(x, h, c.clone(), w, bias,
                                                impl=impl, prepared=prep)
            moved = [a - b_ for a, b_ in zip(read_counts(), n0)]
            slot = KERNEL_NAMES.index(name)
            if moved != [int(i == slot) for i in range(len(moved))]:
                raise AssertionError(f"{name}: launch counts moved by "
                                     f"{show_counts(moved)}")
            n_prep = conv_lstm.launches_int8_prep - p0
            if n_prep != (2 if int8 else 0):
                raise AssertionError(f"{name}: {n_prep} prep launches")
            if int8:
                bad, unequal, e = 0, 0, 0.0
                for got, want in ((h_k, h_p), (c_k, c_p)):
                    d = (got.float() - want.float()).abs()
                    bad += int((d > bf16_ulp(got, want)
                                + INT8_ULP_SLACK).sum())
                    unequal += int((got != want).sum())
                    e = max(e, d.max().item())
                h_e, c_e = conv_lstm.conv_lstm_ref(x, h, c, w, bias)
                dh = (h_k.float() - h_e.float()).abs()
                dc = (c_k.float() - c_e.float()).abs()
                what = (f"vs plain int8 max|d| {e:.3e}, {unequal} of "
                        f"{2 * h_k.numel()} values not bit-identical, {bad} "
                        f"beyond one bf16 ulp (bound 0); vs exact plain "
                        f"max|dh| {dh.max().item():.3e} mean|dh| "
                        f"{dh.mean().item():.3e} max|dc| "
                        f"{dc.max().item():.3e} (JAX int8 bounds on its test "
                        f"cell: {JAX_INT8_DH_MAX}, {JAX_INT8_DH_MEAN}, "
                        f"{JAX_INT8_DC_MAX}); prep launches per cell "
                        f"{n_prep} (bound 3)")
                ok = bad == 0
                del h_e, c_e, dh, dc
            else:
                eh = (h_k.float() - h_p.float()).abs().max().item()
                ec = (c_k.float() - c_p.float()).abs().max().item()
                e = max(eh, ec)
                what = (f"max|dh| {eh:.3e} (bound {LSTM_H_ATOL}), max|dc| "
                        f"{ec:.3e} (bound {LSTM_C_ATOL})")
                ok = eh <= LSTM_H_ATOL and ec <= LSTM_C_ATOL
            err = max(err, e)
            del h_p, c_p, h_k, c_k
            cw = c.clone()
            t_k = cuda_ms(lambda: conv_lstm.conv_lstm_cell(
                x, h, cw, w, bias, impl=impl, prepared=prep), 20)
            ops, (t_b, by) = cell_bound(x, w, bias, kind)
            line = (f"{name} B={b} C={ch} {hh}x{ww}: {what}; kernel "
                    f"{t_k:.3f} ms ({ops / t_k / 1e9:.1f} {unit}"
                    f"{', prep included' if int8 else ''}), bound "
                    f"{t_b:.4f} ms ({by}), share of bound "
                    f"{100.0 * t_b / t_k:.1f}%")
            if b8:
                t_p = cuda_ms(lambda: plain(x, h, c, w, bias), 3)
                t_l = cuda_ms(library_gate_conv(x, h, w, bias), 20)
                line += (f"; plain {t_p:.3f} ms; library gate conv alone "
                         f"{t_l:.3f} ms ({ops / t_l / 1e9:.1f} TFLOP/s; "
                         "F.conv2d with bias on the bf16 concat: "
                         "not the same function, no pointwise)")
                ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
                bound_ms += t_b
                bound_by.add(by)
            log(line)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at B={b} C={ch}")
            if b8 and ch == CELL_SHAPES[0][1]:
                log_cell_plan(name, conv_halo.cell_plan(
                    b, hh, ww, ch, ch, int8=int8,
                    sm_count=conv_halo.sm_count(dev)))
            del x, h, c, cw
    log(f"{name} time for the three encoder cells (one window, B=8): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({'/'.join(sorted(bound_by))}), share of bound "
        f"{100.0 * bound_ms / ms:.1f}%; library gate convs alone "
        f"{lib_ms:.3f} ms (not the same function)")
    log_ptxas(name, "cell_kernelILb1ELi0E" if int8 else "cell_kernelILb0ELi0E")
    src = "conv_lstm_int8.cu" if int8 else "conv_lstm.cu"
    return {"name": "conv_lstm_int8" if int8 else "conv_lstm",
            "route": "cuda", "source": f"ess_tpu_torch/csrc/{src}",
            "replaces": ("ess_tpu/ops/conv_lstm_pallas.py:137" if int8
                         else "ess_tpu/ops/conv_lstm_pallas.py:132"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in bound_by else "bytes",
            "library_ms": None}


def log_cell_plan(what: str, plan) -> None:
    """The cell kernels' plan of a launch."""
    log(f"  plan {what}: {plan.th}x{plan.tw} pixels x {plan.bn} gate "
        f"columns a block, {plan.chunks} chunks of {plan.kc} channels "
        f"({plan.chunks_x} from x), ring of {conv_halo.CELL_STAGES} stages, "
        f"{plan.smem} B dynamic shared memory, {plan.grid} persistent "
        f"blocks over {plan.n_tiles} pixel tiles x {plan.n_tiles_n} N "
        "tiles")


def conv_inputs(g, dev, b, cin, cout, hh, ww):
    """Post-ReLU activations (as the head conv's output is), a weight at
    fan-in scale and a bias, on the card."""
    x = (torch.relu(torch.randn(b, cin, hh, ww, generator=g)) * 2).to(
        dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = (torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5).to(dev)
    bias = (torch.randn(cout, generator=g) * 0.1).to(dev)
    return x, w, bias


def conv_bound(x, w, bias, kind: str):
    """Bound of one fused conv call: x read and the output written once in
    bf16, f32 weights and bias; 2 operations per multiply-add of the
    unpadded product."""
    b, cin, hh, ww = x.shape
    cout = w.shape[0]
    out_numel = b * cout * hh * ww
    return bound(2.0 * (x.numel() + out_numel)
                 + 4.0 * (w.numel() + bias.numel()),
                 2.0 * b * hh * ww * 9 * cin * cout, kind)


def library_conv_fn(x, w, bias):
    """The library's conv + bias + ReLU on bf16 channels-last operands:
    one ATen call (``torch.cudnn_convolution_relu``) where this build has
    it and takes the shape, else ``F.conv2d`` with bias and ``relu_`` (two
    calls). Returns (callable, description). Timed as a yardstick only."""
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bl = bias.to(torch.bfloat16)
    if hasattr(torch, "cudnn_convolution_relu"):
        fused = lambda: torch.cudnn_convolution_relu(
            x, wl, bl, [1, 1], [1, 1], [1, 1], 1)
        try:
            fused()
            torch.cuda.synchronize()
            return fused, "torch.cudnn_convolution_relu (one call)"
        except RuntimeError as e:
            log(f"  torch.cudnn_convolution_relu refused the shape: "
                f"{str(e).splitlines()[0][:120]}")
    two = lambda: torch.nn.functional.conv2d(x, wl, bl, padding=1).relu_()
    return two, "F.conv2d with bias, then relu_ (two calls)"


CONV_CASES = ((True, True), (False, True), (True, False))   # (relu, bias)


def log_ptxas(what: str, entry: str) -> None:
    """Print what ``ptxas -v`` said (registers, shared memory, spills) about
    the kernels whose mangled entry name contains ``entry``."""
    lines, cur = [], None
    for line in kernels.build_log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if "'" in line else line
        elif cur and entry in cur and ("registers" in line or "spill" in line
                                       or "smem" in line):
            lines.append(f"{cur[:60]}: {line.split(':', 1)[-1].strip()}")
    if not lines and not kernels.build_log:
        lines = ["library loaded from an earlier build: no ptxas report"]
    for line in lines:
        log(f"  ptxas {what}: {line}")


def log_plan(what: str, plan) -> None:
    """The halo-tile core's plan of a launch: patch, N tile, dynamic shared
    memory (``ptxas -v`` reports static shared memory only), grid and, for
    B4-int8, its s8 halo tiles (2: the producer kernel)."""
    log(f"  plan {what}: {plan.th}x{plan.tw} pixels x {plan.bn} channels a "
        f"block, {plan.smem} B dynamic shared memory, weights "
        f"{'resident' if plan.resident else 'streamed'} ({plan.chunks} "
        f"chunks), grid {plan.grid_x} x {plan.n_tiles_n} persistent blocks "
        f"over {plan.n_tiles} pixel tiles"
        + (f", {plan.q_stages} s8 halo tiles" if plan.q_stages else ""))


def check_conv3x3(dev):
    """B4 against its plain version at CONV_SHAPES (B=2) and at the main
    path's B=8 for the head and encoder-0 block convs; the row's times,
    bound and library time are those of the two B=8 convs, the B=2 ones are
    logged beside them."""
    g = torch.Generator().manual_seed(9)
    err = ms = plain_ms = bound_ms = lib_ms = 0.0
    bound_by = set()

    def compare(what, got, want):
        d = (got.float() - want).abs()
        share = (d <= bf16_ulp(got, want)).float().mean().item()
        e = d.max().item()
        rel = e / want.abs().max().item()
        log(f"B4 conv3x3 {what}: {100.0 * share:.4f}% within one bf16 ulp "
            f"(bound >= {100.0 * CONV_ULP_SHARE}%), max|d| {e:.3e} = "
            f"{rel:.3e} of absmax (bound {CONV_MAX_REL:.3e})")
        if not (share >= CONV_ULP_SHARE and rel <= CONV_MAX_REL):
            raise AssertionError(f"B4 ({what}) disagrees with its plain "
                                 f"version: {share}, {rel}")
        return e

    for name, b, cin, cout, hh, ww in CONV_SHAPES:
        x, w, bias = conv_inputs(g, dev, b, cin, cout, hh, ww)
        prep = conv3x3.prepare_conv_weights(w)
        for relu, use_bias in CONV_CASES:
            bb = bias if use_bias else None
            want = conv3x3.conv3x3_ref(x, w, bb, relu=relu).float()
            n0 = conv3x3.launches
            got = conv3x3.conv3x3_fused(x, w, bb, relu=relu, impl="pallas",
                                        prepared=prep)
            torch.cuda.synchronize()
            if conv3x3.launches != n0 + 1:
                raise AssertionError("conv3x3_fused did not launch B4")
            err = max(err, compare(
                f"{name} B={b} {cin}->{cout} {hh}x{ww} relu={relu} "
                f"bias={use_bias}", got, want))
        if name == "odd":
            continue
        flop = 2.0 * b * hh * ww * 9 * cin * cout
        lib_fn, lib_what = library_conv_fn(x, w, bias)
        t_k = cuda_ms(lambda: conv3x3.conv3x3_fused(
            x, w, bias, relu=True, impl="pallas", prepared=prep), 20)
        t_l = cuda_ms(lib_fn, 20)
        t_b, by = conv_bound(x, w, bias, "bf16")
        log(f"B4 conv3x3 {name} B={b}: kernel {t_k:.3f} ms "
            f"({flop / t_k / 1e9:.1f} TFLOP/s), library {t_l:.3f} ms "
            f"[{lib_what}], bound {t_b:.4f} ms ({by}), share of bound "
            f"{100.0 * t_b / t_k:.1f}%")
        del x, lib_fn
        # the main path's B=8 (eval and train steps, streaming at B=8)
        x8, w, bias = conv_inputs(g, dev, 8, cin, cout, hh, ww)
        prep = conv3x3.prepare_conv_weights(w)
        want = conv3x3.conv3x3_ref(x8, w, bias, relu=True).float()
        got = conv3x3.conv3x3_fused(x8, w, bias, relu=True, impl="pallas",
                                    prepared=prep)
        err = max(err, compare(f"{name} B=8 {cin}->{cout} {hh}x{ww} "
                               "relu=True bias=True", got, want))
        lib8, lib_what = library_conv_fn(x8, w, bias)
        lib_err = (lib8().float() - want).abs().max().item()
        del got, want
        t_k8 = cuda_ms(lambda: conv3x3.conv3x3_fused(
            x8, w, bias, relu=True, impl="pallas", prepared=prep), 20)
        t_p8 = cuda_ms(lambda: conv3x3.conv3x3_ref(x8, w, bias, relu=True), 3)
        t_l8 = cuda_ms(lib8, 20)
        t_b8, by8 = conv_bound(x8, w, bias, "bf16")
        flop8 = 4.0 * flop
        log(f"B4 conv3x3 {name} B=8 {cin}->{cout} {hh}x{ww}: kernel "
            f"{t_k8:.3f} ms ({flop8 / t_k8 / 1e9:.1f} TFLOP/s), plain "
            f"{t_p8:.3f} ms, library {t_l8:.3f} ms ({flop8 / t_l8 / 1e9:.1f} "
            f"TFLOP/s) [{lib_what}; max|d| vs plain {lib_err:.3e}], bound "
            f"{t_b8:.4f} ms ({by8}), share of bound "
            f"{100.0 * t_b8 / t_k8:.1f}%, kernel / library "
            f"{t_k8 / t_l8:.3f} ({'beats' if t_k8 < t_l8 else 'loses to'} "
            "the library)")
        log_plan("B4", conv_halo.conv_plan(8, hh, ww, cin, cout,
                                           sm_count=conv_halo.sm_count(dev)))
        ms, plain_ms, lib_ms = ms + t_k8, plain_ms + t_p8, lib_ms + t_l8
        bound_ms += t_b8
        bound_by.add(by8)
        del x8, lib8
    log(f"B4 time for the head and encoder-0 block convs (one window, B=8): "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"{lib_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({'/'.join(sorted(bound_by))}), share of bound "
        f"{100.0 * bound_ms / ms:.1f}%")
    log_ptxas("B4", "conv3x3_halo_kernelILb0E")
    return {"name": "conv3x3", "route": "cuda",
            "source": "ess_tpu_torch/csrc/conv3x3.cu + conv_halo.cuh",
            "replaces": "ess_tpu/ops/conv3x3_pallas.py:53",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in bound_by else "bytes",
            "library_ms": lib_ms}


def check_conv3x3_int8(dev):
    """B4-int8 against its plain version at CONV_SHAPES (B=2), bit for bit,
    and at the main path's B=8 for the head and encoder-0 block convs, where
    the row's times and bound are taken: the two prep launches included,
    TOP/s, share of bound, launches per conv, the plan and what ``ptxas
    -v`` said; cuDNN's bf16 conv + bias + ReLU on the same shapes beside it
    (not the same function: ``library_ms`` stays None)."""
    g = torch.Generator().manual_seed(10)
    err = ms = plain_ms = bound_ms = 0.0
    bound_by = set()

    def compare(what, got, want, exact=None, enforced=False):
        unequal = int((got != want).sum())
        e = (got.float() - want.float()).abs().max().item()
        line = (f"B4-int8 conv3x3_int8 {what}: vs plain int8 {unequal} of "
                f"{got.numel()} values not bit-identical (bound 0), max|d| "
                f"{e:.3e}")
        if exact is not None:
            de = (got.float() - exact).abs()
            scale = exact.abs().max().item()
            e_max, e_mean = de.max().item() / scale, de.mean().item() / scale
            line += (f"; vs exact plain max error {e_max:.3e} and mean error "
                     f"{e_mean:.3e} of absmax (JAX bounds {JAX_CONV_INT8_MAX}"
                     f", {JAX_CONV_INT8_MEAN}: "
                     f"{'enforced' if enforced else 'reported'})")
            if enforced and not (e_max < JAX_CONV_INT8_MAX
                                 and e_mean < JAX_CONV_INT8_MEAN):
                raise AssertionError(f"B4-int8 ({what}) is beyond the int8 "
                                     f"bounds: {e_max}, {e_mean}")
        log(line)
        if unequal:
            raise AssertionError(f"B4-int8 ({what}) disagrees with its plain "
                                 f"version at {unequal} values")
        return e

    def launch(x, w, bb, relu, prep):
        n0, p0 = conv3x3.launches_int8, conv3x3.launches_int8_prep
        got = conv3x3.conv3x3_fused(x, w, bb, relu=relu,
                                    impl="pallas_int8_interpret",
                                    prepared=prep)
        torch.cuda.synchronize()
        if (conv3x3.launches_int8, conv3x3.launches_int8_prep) != (
                n0 + 1, p0 + 2):
            raise AssertionError("conv3x3_fused did not launch B4-int8 and "
                                 "its two prep kernels once")
        return got

    for name, b, cin, cout, hh, ww in CONV_SHAPES:
        x, w, bias = conv_inputs(g, dev, b, cin, cout, hh, ww)
        prep = conv3x3.prepare_conv_weights(w, int8=True)
        for relu, use_bias in CONV_CASES:
            bb = bias if use_bias else None
            got = launch(x, w, bb, relu, prep)
            err = max(err, compare(
                f"{name} B={b} {cin}->{cout} {hh}x{ww} relu={relu} "
                f"bias={use_bias}", got,
                conv3x3.conv3x3_int8_ref(x, w, bb, relu=relu),
                conv3x3.conv3x3_ref(x, w, bb, relu=relu).float(),
                enforced=name == "odd" and relu))
        if name == "odd":
            continue
        del x
        # the main path's B=8 (the train rollout's block convs)
        x8, w, bias = conv_inputs(g, dev, 8, cin, cout, hh, ww)
        prep = conv3x3.prepare_conv_weights(w, int8=True)
        err = max(err, compare(
            f"{name} B=8 {cin}->{cout} {hh}x{ww} relu=True bias=True",
            launch(x8, w, bias, True, prep),
            conv3x3.conv3x3_int8_ref(x8, w, bias, relu=True)))
        lib8, lib_what = library_conv_fn(x8, w, bias)
        t_k8 = cuda_ms(lambda: conv3x3.conv3x3_fused(
            x8, w, bias, relu=True, impl="pallas_int8_interpret",
            prepared=prep), 20)
        t_prep = cuda_ms(lambda: conv3x3.int8_prep(x8, prep), 20)
        t_p8 = cuda_ms(lambda: conv3x3.conv3x3_int8_ref(x8, w, bias,
                                                        relu=True), 3)
        t_l8 = cuda_ms(lib8, 20)
        t_b8, by8 = conv_bound(x8, w, bias, "int8")
        ops8 = 2.0 * 8 * hh * ww * 9 * cin * cout
        log(f"B4-int8 conv3x3_int8 {name} B=8 {cin}->{cout} {hh}x{ww}: "
            f"kernels {t_k8:.3f} ms, 3 launches (prep alone {t_prep:.3f} "
            f"ms; {ops8 / t_k8 / 1e9:.1f} TOP/s), plain {t_p8:.3f} ms, "
            f"bound {t_b8:.4f} ms ({by8}), share of bound "
            f"{100.0 * t_b8 / t_k8:.1f}%; cuDNN bf16 conv + bias + ReLU "
            f"{t_l8:.3f} ms [{lib_what}; not the same function]")
        log_plan("B4-int8", conv_halo.conv_plan(
            8, hh, ww, cin, cout, int8=True,
            sm_count=conv_halo.sm_count(dev)))
        ms, plain_ms, bound_ms = ms + t_k8, plain_ms + t_p8, bound_ms + t_b8
        bound_by.add(by8)
        del x8, lib8
    log(f"B4-int8 time for the head and encoder-0 block convs (one window, "
        f"B=8, prep included): kernels {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({'/'.join(sorted(bound_by))}), share of "
        f"bound {100.0 * bound_ms / ms:.1f}%")
    log_ptxas("B4-int8", "conv3x3_halo_kernelILb1E")
    log_ptxas("B4-int8 producer kernel", "conv3x3_int8_ws_kernel")
    log_ptxas("B4-int8 prep", "weight_prep_kernel")
    log_ptxas("int8 prep absmax", "absmax_kernel")
    return {"name": "conv3x3_int8", "route": "cuda",
            "source": "ess_tpu_torch/csrc/conv3x3_int8.cu + conv_halo.cuh",
            "replaces": "ess_tpu/ops/conv3x3_pallas.py:55",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in bound_by else "bytes",
            "library_ms": None}


def level_bound(ushape, ch: int, u_s2d: bool):
    """Bound of one fused-level call on an input of ``ushape``: u, h and c
    read and h', c' written once in bf16, the f32 parameters read once; 2
    operations per multiply-add of the 5x5 stride-2 conv (25 taps: the
    space-to-depth product's zero taps are not work the function needs) and
    of the gate conv, all int8. Returns (ms, bound by, operations)."""
    b, _, ho, wo = bench_level.state_shape(ushape, ch, u_s2d)
    cin = ushape[1] // 4 if u_s2d else ushape[1]
    state = b * ch * ho * wo
    params = 25 * cin * ch + ch + 9 * 2 * ch * 4 * ch + 4 * ch
    nbytes = 2.0 * (int(np.prod(ushape)) + 4 * state) + 4.0 * params
    ops = 2.0 * b * ho * wo * (25 * cin * ch + 9 * 2 * ch * 4 * ch)
    return (*bound(nbytes, ops, "int8"), ops)


def ulp_report(got, want):
    """(values beyond one bf16 ulp, values not bit-identical, max |d|)."""
    d = (got.float() - want.float()).abs()
    return (int((d > bf16_ulp(got, want) + INT8_ULP_SLACK).sum()),
            int((got != want).sum()), d.max().item())


def check_level(dev):
    """B5 against its plain version: the three encoder levels at the
    tool's B=8 and a full-resolution level 0 with three row tiles; times at
    the three. The kernels are called directly, for the group scales, and
    through ``encoder_level_int8``, the entry the tool drives, which must
    give the same bits."""
    err = ms = plain_ms = bound_ms = 0.0
    bound_by = set()
    for li, (ushape, ch, u_s2d) in enumerate(LEVEL_SHAPES + [LEVEL_ODD]):
        odd = li == len(LEVEL_SHAPES)
        u, h0, c0, ek, eb, gk, _ = bench_level.make_inputs(
            20 + li, ushape, ch, u_s2d, dev)
        gb = torch.randn(4 * ch, generator=torch.Generator().manual_seed(li)
                         ).to(dev) * 0.05
        prep = level.prepare_level_weights(ek, eb, gk, gb)
        th = conv_lstm.pick_row_tile(h0.shape[2])
        kw = dict(u_s2d=u_s2d, th=th)
        h_p, c_p, au_p, ax_p = level.level_int8_ref(u, h0, c0, prep, **kw)
        x_p = level.level_x_ref(u, prep, **kw)[0].permute(0, 2, 3, 1)
        x_k = torch.full_like(x_p, float("nan")).contiguous()
        n0 = level.launches
        h_k, c_k, au_k, ax_k = level.level_int8_cuda(
            u, h0, c0.clone(memory_format=torch.channels_last), prep, **kw,
            x_out=x_k)
        torch.cuda.synchronize()
        x_equal = torch.equal(x_k, x_p)
        del x_k, x_p
        h_e, (_, c_e) = level.encoder_level_int8(
            u, (h0, c0.clone(memory_format=torch.channels_last)), ek, eb, gk,
            gb, u_s2d=u_s2d, prepared=prep)
        torch.cuda.synchronize()
        if level.launches != n0 + 2:
            raise AssertionError("the level did not count its launches")
        if not (torch.equal(h_e, h_k) and torch.equal(c_e, c_k)):
            raise AssertionError(f"B5 ({tuple(ushape)}): encoder_level_int8 "
                                 "and level_int8_cuda give different bits")
        scales_equal = x_equal and all(
            torch.equal(k.clamp(min=level.AMAX_FLOOR), p)
            for k, p in ((au_k, au_p), (ax_k, ax_p)))
        bad = unequal = 0
        e = 0.0
        for got, want in ((h_k, h_p), (c_k, c_p)):
            b_, u_, e_ = ulp_report(got, want)
            bad, unequal, e = bad + b_, unequal + u_, max(e, e_)
        err = max(err, e)
        form = "space-to-depth" if u_s2d else "full-resolution"
        log(f"B5 level_int8 {'odd' if odd else f'L{li}'} u "
            f"{tuple(ushape)} ({form}) -> CH {ch} at "
            f"{h0.shape[2]}x{h0.shape[3]}, th={th}, {au_k.numel()} groups: "
            f"x and the group scales identical {scales_equal} (bound: "
            f"identical; the quantized operands follow from them); "
            f"encoder_level_int8 gives the same bits; "
            f"{unequal} of {2 * h_k.numel()} values of h', c' not "
            f"bit-identical, {bad} beyond one bf16 ulp (bound 0), max|d| "
            f"{e:.3e}")
        if bad or not scales_equal:
            raise AssertionError(f"B5 ({tuple(ushape)}) disagrees with its "
                                 f"plain version: {bad} values, x and "
                                 f"scales identical {scales_equal}")
        b_, cu_ = h0.shape[0], u.shape[1] * (1 if u_s2d else 4)
        lp = conv_halo.level_plan(b_, h0.shape[2], h0.shape[3], cu_, ch, th,
                                  sm_count=conv_halo.sm_count(dev))
        log(f"  plan B5: {lp.groups} groups of {th} rows, amax_u "
            f"{lp.amax_blocks} blocks a group; gates {lp.gates.th}x"
            f"{lp.gates.tw} pixels x {lp.gates.bn} gate columns a block, "
            f"{lp.gates.chunks} chunks ({lp.gates.chunks_x} of x), "
            f"{lp.gates.smem} B dynamic shared memory, grid {lp.gates.grid} "
            f"over {lp.gates.n_tiles} x {lp.gates.n_tiles_n} items")
        log_plan("B5 conv", lp.conv)
        if odd:
            continue
        del h_p, c_p, h_k, c_k, h_e, c_e
        cw = c0.clone(memory_format=torch.channels_last)
        t_k = cuda_ms(lambda: level.level_int8_cuda(u, h0, cw, prep, **kw),
                      20)
        t_p = cuda_ms(lambda: level.level_int8_ref(u, h0, c0, prep, **kw), 2)
        t_b, by, ops = level_bound(ushape, ch, u_s2d)
        ms, plain_ms, bound_ms = ms + t_k, plain_ms + t_p, bound_ms + t_b
        bound_by.add(by)
        log(f"B5 level_int8 L{li}: kernels {t_k:.3f} ms "
            f"({ops / t_k / 1e9:.1f} TOP/s), plain {t_p:.3f} ms, bound "
            f"{t_b:.4f} ms ({by}), share of bound {100.0 * t_b / t_k:.1f}%")
    log_ptxas("B5 amax_u", "amax_u_kernel")
    log_ptxas("B5 conv", "level_conv_kernel")
    log_ptxas("B5 gates", "level_cell_kernel")
    log(f"B5 time for the three encoder levels (one window, B=8): kernels "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({'/'.join(sorted(bound_by))}), share of bound "
        f"{100.0 * bound_ms / ms:.1f}%")
    return {"name": "level_int8", "route": "cuda",
            "source": "ess_tpu_torch/csrc/level_int8.cu + conv_halo.cuh",
            "replaces": "ess_tpu/ops/level_pallas.py:68",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in bound_by else "bytes",
            "library_ms": None}


def check_cell_variants(dev):
    """T2: the compared modes of both cell bodies against their plain
    versions at the three encoder cells at the tool's B=8, the shapes phase
    8 drives; the row's times are those of the three modes other than
    ``full`` (which is B2 / B2-int8), both bodies."""
    err = ms = plain_ms = bound_ms = 0.0
    bound_by = set()
    for li, shape in enumerate(bench_lstm_breakdown.SHAPES):
        x, h0, c0, w, bias = bench_lstm_breakdown.make_inputs(30 + li, shape,
                                                              dev)
        b, ch, hh, ww = shape
        ops = 2.0 * b * hh * ww * 9 * 2 * ch * 4 * ch
        nbytes = 2.0 * 5 * x.numel() + 4.0 * (w.numel() + bias.numel())
        for int8 in (False, True):
            body = "int8" if int8 else "bf16"
            prep = conv_lstm.prepare_cell_weights(
                w, "pallas_int8" if int8 else "pallas")
            t_b, by = bound(nbytes, ops, body)
            times = []
            for mode in bench_lstm_breakdown.COMPARED:
                kw = dict(mode=mode, int8=int8)
                h_p, c_p = bench_lstm_breakdown.cell_variant_ref(
                    x, h0, c0, w, bias, **kw)
                before = read_counts()
                h_k, c_k = bench_lstm_breakdown.cell_variant(
                    x, h0, c0.clone(memory_format=torch.channels_last), w,
                    bias, prepared=prep, **kw)
                moved = [a - b_ for a, b_ in zip(read_counts(), before)]
                slot = KERNEL_NAMES.index(
                    "T2" if mode != "full" else
                    "B2-int8" if int8 else "B2")
                if moved != [int(i == slot) for i in range(len(moved))]:
                    raise AssertionError(f"T2 {body} {mode}: launch counts "
                                         f"moved by {show_counts(moved)}")
                ok, what, e = True, [], 0.0
                for name, got, want in (("h'", h_k, h_p), ("c'", c_k, c_p)):
                    bad, _, d = ulp_report(got, want)
                    e = max(e, d)
                    if int8 and mode != "ptw_bf16":
                        ok &= bad == 0
                        what.append(f"{name} {bad} beyond one bf16 ulp "
                                    "(bound 0)")
                    elif int8:
                        ok &= (bad <= (1 - VARIANT_ULP_SHARE) * got.numel()
                               and d <= VARIANT_BF16_INT8_MAX)
                        what.append(
                            f"{name} {bad} beyond one bf16 ulp (bound "
                            f"{(1 - VARIANT_ULP_SHARE) * got.numel():.0f}), "
                            f"max|d| {d:.3e} (bound "
                            f"{VARIANT_BF16_INT8_MAX:.3e})")
                    elif mode == "ptw_bf16":
                        ok &= d <= VARIANT_BF16_MAX
                        what.append(f"{name} max|d| {d:.3e} (bound "
                                    f"{VARIANT_BF16_MAX:.3e})")
                    else:
                        rel = d / want.float().abs().max().item()
                        ok &= rel <= VARIANT_REL
                        what.append(f"{name} max|d| {rel:.3e} of absmax "
                                    f"(bound {VARIANT_REL:.3e})")
                err = max(err, e)
                cw = c0.clone(memory_format=torch.channels_last)
                t_k = cuda_ms(lambda: bench_lstm_breakdown.cell_variant(
                    x, h0, cw, w, bias, prepared=prep, **kw), 20)
                times.append(f"{mode} {t_k:.3f}")
                if mode != "full":
                    t_p = cuda_ms(
                        lambda: bench_lstm_breakdown.cell_variant_ref(
                            x, h0, c0, w, bias, **kw), 2)
                    ms, plain_ms = ms + t_k, plain_ms + t_p
                    bound_ms += t_b
                    bound_by.add(by)
                log(f"T2 {body} body, {mode}, B={b} C={ch} {hh}x{ww}: "
                    + "; ".join(what))
                if not ok:
                    raise AssertionError(f"T2 {body} {mode} disagrees with "
                                         "its plain version")
                del h_p, c_p, h_k, c_k
            log(f"T2 {body} body B={b} C={ch} {hh}x{ww}: kernel ms "
                f"{', '.join(times)}; bound {t_b:.4f} ms ({by}) each")
    log(f"T2 time for ptw_bf16, ptw_mul and no_ptw on both bodies at the "
        f"three encoder cells (B=8, 18 calls): kernels {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({'/'.join(sorted(bound_by))}), share of bound "
        f"{100.0 * bound_ms / ms:.1f}%")
    return {"name": "conv_lstm_variants", "route": "cuda",
            "source": "ess_tpu_torch/csrc/conv_lstm.cu",
            "sources": ["ess_tpu_torch/csrc/conv_lstm.cu",
                        "ess_tpu_torch/csrc/conv_lstm_int8.cu",
                        "ess_tpu_torch/csrc/mma_common.cuh"],
            "replaces": "tools/bench_lstm_breakdown.py:47",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in bound_by else "bytes",
            "library_ms": None}


def check_voxel_folded_legacy(dev):
    """B3-legacy, the full-width band wire, against its plain version at the
    DSEC shape its path runs (B=8 x T=20 windows of 100k events on 480x640,
    records of ``host_band_bin_folded(x_slots=False)``), and the normalized
    grid against the x-slot wire's (B1) on the same events."""
    n_win = 8 * WINDOWS
    rng = np.random.default_rng(2)
    raw, valid = make_raw(rng, 8)
    raw, valid = raw.reshape(n_win, EVENTS, 4), valid.reshape(n_win, EVENTS)
    wires = {}
    for x_slots in (False, True):
        t0 = time.perf_counter()
        r, v, o = voxel_folded.host_band_bin_folded(
            raw, valid, height=SENSOR_H, width=SENSOR_W, bins=BINS,
            x_slots=x_slots)
        host_ms = 1e3 * (time.perf_counter() - t0) / n_win
        cols = [torch.from_numpy(np.ascontiguousarray(r[..., i])).to(dev)
                for i in range(4)] + [torch.from_numpy(v).to(dev)]
        wires[x_slots] = (cols, torch.from_numpy(o).to(dev), o)
        log(f"B3-legacy: host binning with x_slots={x_slots}: {host_ms:.3f} "
            f"ms per window of {EVENTS} events (one thread), "
            f"{int(o[:, -1].mean())} folded records per window, offsets "
            f"{o.shape}")
    (x, y, t, p, vd), offs, o = wires[False]
    th = voxel_folded.tile_h_for_bins(BINS)
    hp = -(-SENSOR_H // th) * th
    if offs.shape[1] != hp // th + 1:
        raise AssertionError(f"full-width band offsets {tuple(offs.shape)}")
    ts = masked_time_norm(t, vd, BINS).contiguous()
    pol = torch.where(vd, p, torch.zeros_like(p)).contiguous()
    kw = dict(bins=BINS, height=hp, width=SENSOR_W)
    n0 = voxel_folded.launches_legacy
    grid_k, stats_k = voxel_folded.voxelize_folded(x, y, ts, pol, offs, **kw)
    torch.cuda.synchronize()
    if voxel_folded.launches_legacy != n0 + 1:
        raise AssertionError("voxelize_folded did not launch B3-legacy")
    grid_p, stats_p = voxel_folded.voxelize_folded_ref(x, y, ts, pol, offs,
                                                       **kw)
    err_raw = (grid_k - grid_p).abs().max().item()
    err = (normalize_from_stats(grid_k, stats_k)
           - normalize_from_stats(grid_p, stats_p)).abs().max().item()
    del grid_p
    kwb = dict(num_bins=BINS, height=SENSOR_H, width=SENSOR_W, normalize=True)
    got = batch_voxel.voxelize_band(x, y, t, p, vd, offs, **kwb)
    scols, soffs, _ = wires[True]
    err_wire = (got - batch_voxel.voxelize_band(*scols, soffs, **kwb)
                ).abs().max().item()
    log(f"B3-legacy voxel_folded_band ({n_win} windows): max|d| raw grid "
        f"{err_raw:.3e}, normalized grid {err:.3e} (bound {VOXEL_ATOL}); "
        f"normalized grid vs the x-slot wire (B1) on the same events "
        f"{err_wire:.3e} (bound {VOXEL_ATOL})")
    if not (err <= VOXEL_ATOL and err_wire <= VOXEL_ATOL):
        raise AssertionError(f"B3-legacy disagrees: {err}, {err_wire}")
    sx, sy, st, sp, svd = scols
    sts = masked_time_norm(st, svd, BINS).contiguous()
    spol = torch.where(svd, sp, torch.zeros_like(sp)).contiguous()
    slot_ms = cuda_ms(lambda: voxel_folded.voxelize_folded(
        sx, sy, sts, spol, soffs, **kw), 20)
    del got, scols, soffs, wires, sx, sy, st, sp, svd, sts, spol
    ms = cuda_ms(lambda: voxel_folded.voxelize_folded(x, y, ts, pol, offs,
                                                      **kw), 20)
    plain_ms = cuda_ms(lambda: voxel_folded.voxelize_folded_ref(
        x, y, ts, pol, offs, **kw), 3)
    bound_ms, bound_by = voxel_bound(int(o[:, -1].sum()), o.size,
                                     grid_k.numel() + stats_k.numel())
    log_scatter_plan(f"B3-legacy at {n_win} windows",
                     voxel_scatter.scatter_plan(
                         BINS, hp, SENSOR_W, n_win,
                         conv_halo.sm_count(x.device), mode="band"))
    log_ptxas("B3-legacy", "scatter_kernelILi2E")
    log(f"B3-legacy time for {n_win} windows ({hp // th} bands x "
        f"{SENSOR_W // 128} tiles, each walking its band): kernel "
        f"{ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), share of "
        f"bound {100.0 * bound_ms / ms:.1f}%; the x-slot wire (B1) on the "
        f"same events {slot_ms:.3f} ms")
    del grid_k, x, y, t, p, vd, ts, pol
    torch.cuda.empty_cache()
    return {"name": "voxel_folded_legacy", "route": "cuda",
            "source": "ess_tpu_torch/csrc/voxel_folded.cu + voxel_scatter.cuh",
            "replaces": "ess_tpu/ops/voxel_pallas.py:1177",
            "max_abs_err": max(err, err_wire), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def check_head_cmajor(dev):
    """T1 against its plain version in both output layouts at the tool's
    B=8 (20 -> 128 channels on a 220x320 C-major window), with its time,
    rate, bound, and the library's conv + bias + ReLU on the same
    normalized window in channels-last layout."""
    b, cin, hh, ww, cout = bench_head.SHAPE
    x, w, bias = bench_head.make_inputs(13, bench_head.SHAPE, dev)
    prep = conv3x3.prepare_conv_weights(w)
    kw = dict(shift=bench_head.SHIFT, scale=bench_head.SCALE)
    flop = 2.0 * b * hh * ww * 9 * cin * cout
    t_b, by = bound(2.0 * (x.numel() + b * cout * hh * ww)
                    + 4.0 * (w.numel() + bias.numel()), flop, "bf16")
    err, times = 0.0, {}
    for nchw_out in (False, True):
        layout = "NCHW" if nchw_out else "NHWC"
        want = head_cmajor.head_cmajor_ref(x, w, bias, nchw_out=nchw_out,
                                           **kw).float()
        n0 = head_cmajor.launches
        got = head_cmajor.head_cmajor(x, w, bias, nchw_out=nchw_out,
                                      prepared=prep, **kw)
        torch.cuda.synchronize()
        if head_cmajor.launches != n0 + 1:
            raise AssertionError("head_cmajor did not launch T1")
        d = (got.float() - want).abs()
        share = (d <= bf16_ulp(got, want)).float().mean().item()
        e = d.max().item()
        rel = e / want.abs().max().item()
        err = max(err, e)
        log(f"T1 head_cmajor {layout} out, B={b} {cin}->{cout} {hh}x{ww}: "
            f"{100.0 * share:.4f}% within one bf16 ulp (bound >= "
            f"{100.0 * CONV_ULP_SHARE}%), max|d| {e:.3e} = {rel:.3e} of "
            f"absmax (bound {CONV_MAX_REL:.3e})")
        if not (share >= CONV_ULP_SHARE and rel <= CONV_MAX_REL):
            raise AssertionError(f"T1 ({layout}) disagrees with its plain "
                                 f"version: {share}, {rel}")
        del got, want, d
        times[nchw_out] = cuda_ms(lambda: head_cmajor.head_cmajor(
            x, w, bias, nchw_out=nchw_out, prepared=prep, **kw), 20)
    plain_ms = cuda_ms(lambda: head_cmajor.head_cmajor_ref(
        x, w, bias, nchw_out=False, **kw), 3)
    xn = head_cmajor.normalize_apply(x, kw["shift"], kw["scale"]).contiguous(
        memory_format=torch.channels_last)
    lib_fn, lib_what = library_conv_fn(xn, w, bias)
    lib_err = (lib_fn().float() - head_cmajor.head_cmajor_ref(
        x, w, bias, nchw_out=True, **kw).float()).abs().max().item()
    lib_ms = cuda_ms(lib_fn, 20)
    for nchw_out, t_k in times.items():
        log(f"T1 head_cmajor {'NCHW' if nchw_out else 'NHWC'} out: kernel "
            f"{t_k:.3f} ms ({flop / t_k / 1e9:.1f} TFLOP/s), bound "
            f"{t_b:.4f} ms ({by}), share of bound {100.0 * t_b / t_k:.1f}%, "
            f"kernel / library {t_k / lib_ms:.3f} "
            f"({'beats' if t_k < lib_ms else 'loses to'} the library)")
    log(f"T1 plain {plain_ms:.3f} ms; library {lib_ms:.3f} ms "
        f"({flop / lib_ms / 1e9:.1f} TFLOP/s) [{lib_what} on the normalized "
        f"window, channels-last; max|d| vs plain {lib_err:.3e}]")
    for nchw_out in (False, True):
        log_plan(f"T1 {'NCHW' if nchw_out else 'NHWC'}", conv_halo.head_plan(
            b, hh, ww, cin, cout, nchw_out=nchw_out, aligned=ww % 8 == 0,
            sm_count=conv_halo.sm_count(dev)))
    log_ptxas("T1", "head_halo_kernel")
    return {"name": "head_cmajor", "route": "cuda",
            "source": "ess_tpu_torch/csrc/head_cmajor.cu",
            "replaces": "tools/bench_head.py:66",
            "max_abs_err": err, "ms": times[False], "ms_nchw": times[True],
            "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
            "library_ms": lib_ms}


def phase_tools(dev, kern_rows):
    """The two attribution tools through their ``main``: at a small shape
    with the JAX level test's bounds enforced, then at B=8 and the three
    encoder levels with the counts read around each; then, at the same
    shapes and through the entry the tool drives, a 20-step fused chain
    against the plain chain."""
    chains = 1 + CHAIN_REPEATS                  # warm-up + timed chains
    res = bench_level.main(["--layers=0,1"], layers=LEVEL_SMALL)
    for li, paths in res.items():
        r = paths["fused"]
        log(f"bench_level, small level {li}: fused max|dh| {r['dh_max']:.3e} "
            f"(bound {JAX_LEVEL_DH_MAX}), max|dc| {r['dc_max']:.3e} (bound "
            f"{JAX_LEVEL_DC_MAX}), mean|dh| {r['dh_mean']:.3e} (bound "
            f"{JAX_LEVEL_DH_MEAN})")
        if not (r["dh_max"] < JAX_LEVEL_DH_MAX and r["dc_max"]
                < JAX_LEVEL_DC_MAX and r["dh_mean"] < JAX_LEVEL_DH_MEAN):
            raise AssertionError("the fused level is beyond the int8 bounds")

    n_levels = len(bench_level.LAYERS)
    reset_counts()
    res = bench_level.main([])
    counts = read_counts()
    per_path = n_levels * (1 + chains * CHAIN_STEPS)
    log(f"bench_level at B=8: launches {show_counts(counts)}")
    need_counts(counts, (0, 0, per_path, 0, 0, 0, per_path, 0))
    add_launches(kern_rows, "bench_level", counts)
    for li, paths in res.items():
        f, s_ = paths["fused"], paths["split"]
        t_b, by, ops = level_bound(*bench_level.LAYERS[li])
        log(f"bench_level L{li} (B=8): fused {f['ms_per_step']:.3f} ms/step "
            f"({ops / f['ms_per_step'] / 1e9:.1f} TOP/s; bound {t_b:.4f} ms, "
            f"{by}, share {100.0 * t_b / f['ms_per_step']:.1f}%), "
            f"split {s_['ms_per_step']:.3f} ms/step (fused / split "
            f"{f['ms_per_step'] / s_['ms_per_step']:.3f}); vs the f32 chain "
            f"fused max|dh| {f['dh_max']:.3e} mean|dh| {f['dh_mean']:.3e} "
            f"max|dc| {f['dc_max']:.3e}, split {s_['dh_max']:.3e} "
            f"{s_['dh_mean']:.3e} {s_['dc_max']:.3e} (JAX bounds on its test "
            f"level, reported here: {JAX_LEVEL_DH_MAX}, {JAX_LEVEL_DH_MEAN}, "
            f"{JAX_LEVEL_DC_MAX})")
        if not all(np.isfinite(v) for p in paths.values()
                   for v in p.values()):
            raise AssertionError("bench_level returned a non-finite value")

    reset_counts()
    bench_lstm_breakdown.main(["--int8=0"])
    bench_lstm_breakdown.main(["--int8=1"])
    counts = read_counts()
    per_mode = n_levels * chains * CHAIN_STEPS
    n_other = len(bench_lstm_breakdown.MODES) - 1
    log(f"bench_lstm_breakdown at B=8, both bodies: launches "
        f"{show_counts(counts)}")
    need_counts(counts, (0, per_mode, per_mode, 0, 0, 0, 0,
                         2 * n_other * per_mode))
    add_launches(kern_rows, "bench_lstm_breakdown", counts)

    reset_counts()
    res = bench_head.main([])
    counts = read_counts()
    per_variant = 1 + chains * CHAIN_STEPS
    log(f"bench_head at B={bench_head.SHAPE[0]}: launches "
        f"{show_counts(counts)}")
    need_counts(counts, (0,) * (len(KERNEL_NAMES) - 1) + (2 * per_variant,))
    add_launches(kern_rows, "bench_head", counts)
    for name, r in res.items():
        if not (r["max_abs_diff_vs_xla"] <= CONV_MAX_REL * r["absmax"]
                and np.isfinite(r["ms_per_call"])):
            raise AssertionError(f"bench_head {name}: {r}")

    for li, (ushape, ch, u_s2d) in enumerate(LEVEL_SHAPES):
        u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(
            40 + li, ushape, ch, u_s2d, dev)
        kw = dict(u_s2d=u_s2d,
                  prepared=level.prepare_level_weights(ek, eb, gk, gb))
        hk, ck = h0, c0.clone(memory_format=torch.channels_last)
        hp, cp = h0, c0
        for _ in range(CHAIN_STEPS):
            hk, ck = level.encoder_level_int8(u, (hk, ck), ek, eb, gk, gb,
                                              **kw)[1]
            hp, cp = level.encoder_level_int8_ref(u, hp, cp, ek, eb, gk, gb,
                                                  **kw)
        bad_h, ne_h, e_h = ulp_report(hk, hp)
        bad_c, ne_c, e_c = ulp_report(ck, cp)
        n = hk.numel()
        log(f"B5 {CHAIN_STEPS}-step chain L{li} (B={ushape[0]}), kernels vs "
            f"plain, "
            f"each on its own state: h' {ne_h} of {n} not bit-identical, "
            f"{bad_h} beyond one bf16 ulp, max|d| {e_h:.3e}; c' {ne_c}, "
            f"{bad_c}, {e_c:.3e} (bounds: <= "
            f"{(1 - CHAIN_ULP_SHARE) * n:.0f} beyond one ulp, max|d| <= "
            f"{CHAIN_MAX_ABS})")
        if (max(bad_h, bad_c) > (1 - CHAIN_ULP_SHARE) * n
                or max(e_h, e_c) > CHAIN_MAX_ABS
                or not torch.isfinite(hk.float()).all()):
            raise AssertionError(f"B5 chain L{li} drifts from its plain "
                                 "version")


def phase_slice(dev, kern_rows):
    cfg = bench.make_cfg(2, None)
    mods = build_modules(cfg, device=dev)
    init_params(mods, torch.Generator().manual_seed(0))
    pipe = bench.make_pipeline()
    step = make_eval_step(mods, pipe)
    batch = make_batch(3, 2, dev, ignore_rows=20)
    n_valid = int((batch["label"] != 255).sum())

    steps = 3
    reset_counts()
    outs = [step(batch) for _ in range(steps)]
    counts = read_counts()
    log(f"eval slice B=2 T={WINDOWS} {SENSOR_H}x{SENSOR_W} -> "
        f"{SENSOR_H - CROP}x{SENSOR_W}, "
        f"{EVENTS} events/window, {CLASSES} classes: {steps} eval steps, "
        f"launches {show_counts(counts)}")
    need_counts(counts, (steps, steps * 3 * WINDOWS, 0, 0, 0, 0))
    add_launches(kern_rows, "eval", counts)
    out = outs[-1]
    loss = float(out["loss"])
    cm_sum = float(out["cm"].sum())
    log(f"loss {loss:.6f}, cm.sum {cm_sum:.0f} (valid label pixels "
        f"{n_valid}), img_fake {tuple(out['img_fake'].shape)}, latent8 "
        f"{tuple(out['latent8'].shape)}")
    if not np.isfinite(loss) or cm_sum != n_valid:
        raise AssertionError(f"bad eval output: loss {loss}, cm {cm_sum}")
    if out["pred"].shape != (2, SENSOR_H - CROP, SENSOR_W) or not (
            torch.isfinite(out["img_fake"]).all()
            and torch.isfinite(out["latent8"]).all()):
        raise AssertionError("eval outputs have the wrong shape or are "
                             "not finite")
    with plain_versions():
        ref = step(batch)
        # the plain path's logits, for the top-2 gap of each pixel
        with torch.inference_mode():
            windows, _ = pipe.build_all(batch, out_dtype=mods.e2vid.dtype)
            _, _, latent = mods.recon_val.rollout(windows)
            top2 = mods.head(latent)[1].float().topk(2, dim=1).values
    torch.cuda.synchronize()
    rel = ((out["latent8"] - ref["latent8"]).abs().max()
           / ref["latent8"].abs().max()).item()
    same = out["pred"] == ref["pred"]
    clear = top2[:, 0] - top2[:, 1] > SLICE_GAP
    agree = 100.0 * same.float().mean().item()
    agree_clear = 100.0 * same[clear].float().mean().item()
    log(f"kernel path vs plain path: latent8 rel max|d| {rel:.3e} (bound "
        f"{SLICE_LATENT_REL}); pred agreement {agree:.3f}% of all pixels "
        f"(bound >= {SLICE_PRED_AGREE}%), {agree_clear:.3f}% of the "
        f"{100.0 * clear.float().mean().item():.1f}% whose top-2 logit gap "
        f"exceeds {SLICE_GAP} (bound >= {SLICE_PRED_AGREE_CLEAR}%); loss "
        f"{loss:.6f} vs {float(ref['loss']):.6f}")
    if not (rel <= SLICE_LATENT_REL and agree >= SLICE_PRED_AGREE
            and agree_clear >= SLICE_PRED_AGREE_CLEAR):
        raise AssertionError("kernel path disagrees with the plain path")
    del outs, out, ref, batch, windows, latent

    mods8 = build_modules(bench.make_cfg(8, None), device=dev)
    init_params(mods8, torch.Generator().manual_seed(0))
    step8 = make_eval_step(mods8, pipe)
    batch8 = make_batch(4, 8, dev, ignore_rows=20)
    torch.cuda.reset_peak_memory_stats()

    def timed(plain: bool, reps: int = 2) -> list[float]:
        ctx = plain_versions() if plain else contextlib.nullcontext()
        times = []
        with ctx:
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = step8(batch8)
                float(o["loss"])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        return times

    timed(False, 1)
    timed(True, 1)
    runs = {"kernel": [], "plain": []}
    for plain in (True, False, False, True):
        runs["plain" if plain else "kernel"] += timed(plain)
    for name, ts in runs.items():
        med = statistics.median(ts)
        log(f"eval step B=8 T={WINDOWS} ({name} versions): "
            f"{8 * WINDOWS / med:.2f} windows/s, median {1e3 * med:.1f} ms "
            f"over {len(ts)} steps {[round(1e3 * t, 1) for t in ts]}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")


def timed_steps(runs: dict, order, batch) -> dict:
    """Wall seconds of train steps, one run after another in ``order``
    ((name, reps) pairs; name ``'plain versions'`` runs under
    :func:`plain_versions`), each synchronized and ended by fetching the
    loss: {name: [seconds, ...]}."""
    samples = {name: [] for name in runs}
    for name, reps in order:
        state, step = runs[name]
        ctx = (plain_versions() if name == "plain versions"
               else contextlib.nullcontext())
        with ctx:
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(step(state, batch)["loss"])
                torch.cuda.synchronize()
                samples[name].append(time.perf_counter() - t0)
    return samples


def phase_train(dev, kern_rows):
    steps, b = 3, 2
    mods, state, step = bench.build_train(bench.make_cfg(b), dev)
    batch = make_batch(3, b, dev, ignore_rows=20)
    head0 = {k: v.clone() for k, v in mods.head.state_dict().items()}
    e2vid0 = {k: v.clone() for k, v in mods.e2vid.state_dict().items()}

    reset_counts()
    losses = [step(state, batch)["loss"] for _ in range(steps)]
    counts = read_counts()
    losses = [float(v) for v in losses]
    n_exact, n_int8 = int8_cells(b, SENSOR_H - CROP, SENSOR_W)
    log(f"train slice B={b} T={WINDOWS}, {steps} train steps (train rollout "
        f"on the int8 cell; by the size rule {n_int8} cells a window int8, "
        f"{n_exact} exact): launches {show_counts(counts)}; "
        f"losses {[round(v, 6) for v in losses]}")
    need_counts(counts, (steps, steps * n_exact * WINDOWS,
                         steps * n_int8 * WINDOWS, 0, 0, 0))
    prep = conv_lstm.launches_int8_prep / counts[2]
    log(f"int8 cell prep kernel launches per cell: {prep:g} (bound 3); int8 "
        f"conv prep launches {conv3x3.launches_int8_prep} (no int8 conv on "
        "this form)")
    if prep > 3 or conv3x3.launches_int8_prep:
        raise AssertionError(f"{prep} int8 prep launches per cell, "
                             f"{conv3x3.launches_int8_prep} conv prep")
    add_launches(kern_rows, "train", counts)
    changed = sum(not torch.equal(v, head0[k])
                  for k, v in mods.head.state_dict().items())
    frozen = all(torch.equal(v, e2vid0[k])
                 for k, v in mods.e2vid.state_dict().items())
    log(f"head tensors changed {changed} of {len(head0)}; E2VID unchanged "
        f"{frozen}; RAdam steps {mods.opt_back.step_count}")
    if not (all(np.isfinite(losses)) and changed and frozen
            and state.step == steps):
        raise AssertionError("bad train step: loss, head update or frozen "
                             "E2VID")

    # first step, kernel path vs plain path, from the same seeded state
    mods_p, state_p, step_p = bench.build_train(bench.make_cfg(b), dev)
    with plain_versions():
        loss_p = float(step_p(state_p, batch)["loss"])
    pipe = bench.make_pipeline()
    with torch.no_grad():
        windows, _ = pipe.build_all(batch, aug=AugmentParams(),
                                    out_dtype=mods_p.e2vid.dtype)
        lat_k = mods_p.recon_train.rollout(windows, decode=False)[2][8]
        with plain_versions():
            lat_p = mods_p.recon_train.rollout(windows, decode=False)[2][8]
    rel = ((lat_k.float() - lat_p.float()).abs().max()
           / lat_p.float().abs().max()).item()
    loss_rel = abs(losses[0] - loss_p) / abs(loss_p)
    log(f"train step 1, kernel path vs plain path: loss {losses[0]:.6f} vs "
        f"{loss_p:.6f} (relative difference {loss_rel:.3e}, bound "
        f"{TRAIN_LOSS_REL}); latent8 rel max|d| {rel:.3e} (bound "
        f"{TRAIN_LATENT_REL})")
    if not (loss_rel <= TRAIN_LOSS_REL and rel <= TRAIN_LATENT_REL):
        raise AssertionError("train kernel path disagrees with the plain path")
    del mods, mods_p, state, state_p, step, step_p, windows, lat_k, lat_p
    torch.cuda.empty_cache()

    batch8 = make_batch(4, 8, dev, ignore_rows=20)
    runs = {}
    for name, impl in (("int8 kernels", "pallas_int8"),
                       ("exact-bf16 kernels", None),
                       ("plain versions", "pallas_int8")):
        runs[name] = bench.build_train(bench.make_cfg(8, impl), dev)[1:]

    torch.cuda.reset_peak_memory_stats()
    timed_steps(runs, (("int8 kernels", 1),), batch8)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed_steps(runs, (("exact-bf16 kernels", 1), ("plain versions", 1)),
                batch8)
    samples = timed_steps(runs, (
        ("plain versions", 1), ("int8 kernels", 2), ("exact-bf16 kernels", 2),
        ("exact-bf16 kernels", 2), ("int8 kernels", 2),
        ("plain versions", 1)), batch8)
    for name, ts in samples.items():
        med = statistics.median(ts)
        log(f"train step B=8 T={WINDOWS} ({name}): "
            f"{8 * WINDOWS / med:.2f} windows/s, median {1e3 * med:.1f} ms "
            f"over {len(ts)} steps {[round(1e3 * t, 1) for t in ts]}")
    log(f"peak device memory of the int8-kernel train step at B=8: "
        f"{peak:.2f} GiB")


def phase_uda(dev, kern_rows):
    steps, b = 3, 2
    cfg = bench.make_uda_cfg(b)
    mods, state, step = bench.build_uda(cfg, dev)
    batch = bench.make_uda_batch(3, b, dev, ignore_rows=20)
    front0 = {k: v.clone() for k, v in mods.front_a.state_dict().items()}
    head0 = {k: v.clone() for k, v in mods.head.state_dict().items()}
    e2vid0 = {k: v.clone() for k, v in mods.e2vid.state_dict().items()}

    reset_counts()
    outs = [step(state, batch) for _ in range(steps)]
    counts = read_counts()
    outs = [{k: float(v) for k, v in o.items()} for o in outs]
    n_exact, n_int8 = int8_cells(b, SENSOR_H - CROP, SENSOR_W)
    log(f"UDA slice B={b} T={WINDOWS}, sensor A {SENSOR_H - CROP}x{SENSOR_W}"
        f", {steps} UDA train steps (train rollout on the int8 cell, "
        f"decoded; by the size rule {n_int8} cells a window int8, {n_exact} "
        f"exact): launches {show_counts(counts)}; total losses "
        f"{[round(o['loss'], 6) for o in outs]}")
    need_counts(counts, (steps, steps * n_exact * WINDOWS,
                         steps * n_int8 * WINDOWS, 0, 0, 0))
    prep = conv_lstm.launches_int8_prep / counts[2]
    log(f"int8 cell prep kernel launches per cell: {prep:g} (bound 3)")
    if prep > 3:
        raise AssertionError(f"{prep} int8 prep launches per cell")
    add_launches(kern_rows, "uda_train", counts)
    log("step 1 losses: " + ", ".join(f"{k} {v:.6f}"
                                      for k, v in sorted(outs[0].items())))
    front = mods.front_a.state_dict()
    front_changed = sum(not torch.equal(front[k], front0[k])
                        for k in front0 if "running" not in k
                        and not k.endswith("num_batches_tracked"))
    stats_changed = sum(not torch.equal(front[k], front0[k])
                        for k in front0 if "running" in k)
    n_front = sum(1 for k in front0 if "running" not in k
                  and not k.endswith("num_batches_tracked"))
    n_stats = sum(1 for k in front0 if "running" in k)
    head_changed = sum(not torch.equal(v, head0[k])
                       for k, v in mods.head.state_dict().items())
    frozen = all(torch.equal(v, e2vid0[k])
                 for k, v in mods.e2vid.state_dict().items())
    log(f"front tensors changed {front_changed} of {n_front}, batch-norm "
        f"statistics changed {stats_changed} of {n_stats}, head tensors "
        f"changed {head_changed} of {len(head0)}; E2VID unchanged {frozen}; "
        f"RAdam steps front {mods.opt_front.step_count}, head "
        f"{mods.opt_back.step_count}")
    if not (all(sorted(o) == UDA_LOSS_KEYS for o in outs)
            and all(np.isfinite(v) for o in outs for v in o.values())
            and front_changed and stats_changed == n_stats and head_changed
            and frozen and state.step == steps):
        raise AssertionError("bad UDA train step: losses, front, statistics,"
                             " head or frozen E2VID")

    # first step, kernel path vs plain path, from the same seeded state
    _, state_p, step_p = bench.build_uda(cfg, dev)
    with plain_versions():
        out_p = {k: float(v) for k, v in step_p(state_p, batch).items()}
    rels = {k: abs(outs[0][k] - v) / max(abs(v), 1e-12)
            for k, v in out_p.items()}
    log("UDA step 1, kernel path vs plain path, relative difference: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rels.items()))
        + f" (bound on loss {TRAIN_LOSS_REL})")
    if not rels["loss"] <= TRAIN_LOSS_REL:
        raise AssertionError("UDA kernel path disagrees with the plain path")
    del state_p, step_p

    # the two UDA eval steps once, on the trained state
    label_px = b * (SENSOR_H - CROP) * SENSOR_W
    reset_counts()
    out_a = uda.make_eval_step_a(mods)(
        {"image": batch["image_a"], "label": batch["label_a"]})
    counts_a = read_counts()
    need_counts(counts_a, ())
    batch_b = make_batch(5, b, dev, ignore_rows=20)
    reset_counts()
    out_b = uda.make_eval_step_b(mods, bench.make_pipeline())(batch_b)
    counts = read_counts()
    log(f"UDA eval A (front + head) launches {show_counts(counts_a)}"
        f"; eval B (rollout on the exact cell, cycle branch) launches "
        f"{show_counts(counts)}")
    need_counts(counts, (1, 3 * WINDOWS, 0, 0, 0, 0))
    add_launches(kern_rows, "uda_eval_b", counts)
    valid_a = int((batch["label_a"] != 255).sum())
    valid_b = int((batch_b["label"] != 255).sum())
    scal = {k: float(v) for o in (out_a, out_b) for k, v in o.items()
            if k.endswith("_loss")}
    log("UDA eval losses: " + ", ".join(f"{k} {v:.6f}"
                                        for k, v in sorted(scal.items()))
        + f"; cm_a.sum {float(out_a['cm_a'].sum()):.0f} (valid "
        f"{valid_a}), cm_b.sum {float(out_b['cm_b'].sum()):.0f}, "
        f"cm_cycle.sum {float(out_b['cm_cycle'].sum()):.0f} (valid "
        f"{valid_b} of {label_px}), img_fake {tuple(out_b['img_fake'].shape)}")
    if not (all(np.isfinite(v) for v in scal.values()) and len(scal) == 9
            and float(out_a["cm_a"].sum()) == valid_a
            and float(out_b["cm_b"].sum()) == valid_b
            and float(out_b["cm_cycle"].sum()) == valid_b
            and out_b["img_fake"].shape == (b, 1, SENSOR_H - CROP, SENSOR_W)
            and bool(torch.isfinite(out_b["img_fake"]).all())):
        raise AssertionError("bad UDA eval outputs")
    del mods, state, step, outs, out_a, out_b, batch, batch_b
    torch.cuda.empty_cache()

    batch8 = bench.make_uda_batch(4, 8, dev)
    runs = {name: bench.build_uda(bench.make_uda_cfg(8), dev)[1:]
            for name in ("int8 kernels", "plain versions")}
    torch.cuda.reset_peak_memory_stats()
    timed_steps(runs, (("int8 kernels", 1),), batch8)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed_steps(runs, (("plain versions", 1),), batch8)
    samples = timed_steps(runs, (
        ("plain versions", 1), ("int8 kernels", 3), ("int8 kernels", 3),
        ("plain versions", 1)), batch8)
    for name, ts in samples.items():
        med = statistics.median(ts)
        log(f"UDA train step B=8 T={WINDOWS} ({name}): "
            f"{8 * WINDOWS / med:.2f} windows/s, median {1e3 * med:.1f} ms "
            f"over {len(ts)} steps {[round(1e3 * t, 1) for t in ts]}")
    log(f"peak device memory of the int8-kernel UDA train step at B=8: "
        f"{peak:.2f} GiB")


def phase_stream(dev, kern_rows):
    label_px = (SENSOR_H - CROP) * SENSOR_W
    scored = STREAM_WINDOWS // bench.WINDOWS_PER_SCORE
    for b in (1, 8):
        mods, steps = bench.build_stream(b, dev)
        logits = [None]     # the head's logits of the last scored window

        def keep_logits(mod, args, out):
            logits[0] = out[1].float()

        hook = mods.head.register_forward_hook(keep_logits)
        finals = {}
        for wire in ("tile", "raw", "band"):
            windows = bench.make_stream(
                7, b, dev, wire, windows=STREAM_WINDOWS,
                resets=((0, 1.0), (STREAM_WINDOWS // 2, 0.5)))
            reset_counts()
            state, cm = bench.run_stream(
                steps, mods.recon_val.init_state(b, dev), windows)
            counts = read_counts()
            want = ((STREAM_WINDOWS, 3 * STREAM_WINDOWS, 0, 0, 0, 0)
                    if wire == "band"
                    else (0, 3 * STREAM_WINDOWS, 0, STREAM_WINDOWS, 0, 0))
            log(f"stream slice B={b}, {wire} wire, {STREAM_WINDOWS} windows "
                f"({scored} scored): launches {show_counts(counts)}")
            need_counts(counts, want)
            add_launches(kern_rows, "stream", counts)
            latent = state[-1][0].float()
            pred = logits[0].argmax(dim=1)
            cm_sum = float(cm.sum())
            if (cm_sum != scored * b * label_px
                    or tuple(latent.shape) != (b, 256, 55, 80)
                    or not torch.isfinite(latent).all()):
                raise AssertionError(f"bad stream output: cm.sum {cm_sum}, "
                                     f"latent {tuple(latent.shape)}")
            with plain_versions():
                state_p, cm_p = bench.run_stream(
                    steps, mods.recon_val.init_state(b, dev), windows)
            if read_counts() != all_counts(want):
                raise AssertionError("the plain path launched a kernel")
            top2 = logits[0].topk(2, dim=1).values
            clear = top2[:, 0] - top2[:, 1] > SLICE_GAP
            same = pred == logits[0].argmax(dim=1)
            latent_p = state_p[-1][0].float()
            rel = ((latent - latent_p).abs().max()
                   / latent_p.abs().max()).item()
            agree = 100.0 * same.float().mean().item()
            agree_clear = 100.0 * same[clear].float().mean().item()
            cm_moved = 100.0 * float((cm - cm_p).abs().sum()) / (2 * cm_sum)
            log(f"  kernel path vs plain path: final latent rel max|d| "
                f"{rel:.3e} (bound {SLICE_LATENT_REL}); last scored window "
                f"pred agreement {agree:.3f}% (bound >= {SLICE_PRED_AGREE}%),"
                f" {agree_clear:.3f}% where the top-2 gap exceeds {SLICE_GAP}"
                f" (bound >= {SLICE_PRED_AGREE_CLEAR}%); confusion matrix "
                f"{cm_moved:.3f}% of the pixels moved (bound <= "
                f"{100.0 - SLICE_PRED_AGREE}%)")
            if not (rel <= SLICE_LATENT_REL and agree >= SLICE_PRED_AGREE
                    and agree_clear >= SLICE_PRED_AGREE_CLEAR
                    and cm_moved <= 100.0 - SLICE_PRED_AGREE):
                raise AssertionError(f"stream kernel path ({wire}) disagrees "
                                     "with the plain path")
            finals[wire] = (latent, pred, cm)
            if wire == "tile":
                timed = windows[:bench.WINDOWS_PER_SCORE]
        for wire in ("raw", "band"):
            lat0, pred0, cm0 = finals["tile"]
            lat, pred, cm = finals[wire]
            rel = ((lat - lat0).abs().max() / lat0.abs().max()).item()
            agree = 100.0 * (pred == pred0).float().mean().item()
            cm_moved = 100.0 * float((cm - cm0).abs().sum()) / (
                2 * float(cm0.sum()))
            log(f"stream slice B={b}, {wire} wire vs tile wire: final latent "
                f"rel max|d| {rel:.3e} (bound {SLICE_LATENT_REL}), pred "
                f"agreement {agree:.3f}% (bound >= {SLICE_PRED_AGREE}%), "
                f"confusion matrix {cm_moved:.3f}% moved")
            if not (rel <= SLICE_LATENT_REL and agree >= SLICE_PRED_AGREE):
                raise AssertionError(f"the {wire} wire disagrees with the "
                                     "tile wire")
        hook.remove()
        del finals, windows, state, state_p

        rounds = 5 if b == 1 else 3
        rates = {"plain": [], "kernel": []}
        for plain in (True, False, False, True):
            with plain_versions() if plain else contextlib.nullcontext():
                rates["plain" if plain else "kernel"].append(
                    bench.stream_windows_per_sec(mods, steps, timed, rounds))
        for name, r in rates.items():
            med = statistics.median(r)
            log(f"streaming eval B={b}, tile wire, 19 encode + 1 score per 20 "
                f"windows ({name} versions): {med:.2f} windows/s, "
                f"{1e3 * b / med:.3f} ms per window (runs "
                f"{[round(v, 1) for v in r]})")
        state = [mods.recon_val.init_state(b, dev)]

        def twenty_windows():
            state[0], cm_ = bench.run_stream(steps, state[0], timed)
            float(cm_.sum())

        with tempfile.TemporaryDirectory() as tmp:
            prof = bench.profile_call(twenty_windows, tmp, f"stream_b{b}",
                                      top=8)
        log(f"streaming eval B={b} profile over 20 windows: wall "
            f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms "
            f"over a {prof['span_ms']:.1f} ms span, device idle share "
            f"{100.0 * prof['idle_share']:.1f}%")
        for k in prof["top"]:
            log(f"  {k['ms']:.2f} ms {100.0 * k['share']:.1f}% x{k['calls']} "
                f"{k['name'][:90]}")
        del mods, steps, timed, state
        torch.cuda.empty_cache()


def make_recording(seed: int):
    """A DSEC-shaped recording held in memory: DATA_EVENTS raw events on the
    480x640 sensor (u16 pixel columns, int64 microseconds at ~2M events/s,
    u8 polarity), a rectify map with sub-pixel offsets that vary over the
    frame, and label timestamps and (440, 640) labels: the 6 that the
    dataset drops, then two per sample, each sample's label with at least
    T x 100k events before it. Returns ``DSECSequence.from_store``'s
    arguments."""
    rng = np.random.default_rng(seed)
    n = DATA_EVENTS
    x = rng.integers(0, SENSOR_W, n, dtype=np.uint16)
    y = rng.integers(0, SENSOR_H, n, dtype=np.uint16)
    t = np.cumsum(rng.integers(0, 2, n, dtype=np.int64))
    p = rng.integers(0, 2, n, dtype=np.uint8)
    yy, xx = np.mgrid[0:SENSOR_H, 0:SENSOR_W].astype(np.float32)
    rmap = np.stack([
        np.clip(xx + 0.3 + 0.2 * np.sin(yy / 37.0), 0, SENSOR_W - 1),
        np.clip(yy + 0.4 + 0.3 * np.cos(xx / 53.0), 0, SENSOR_H - 1)],
        -1).astype(np.float32)
    span = WINDOWS * EVENTS + 1000
    step = (n - span) // DATA_SAMPLES
    ends = span + step * np.arange(DATA_SAMPLES)
    idx = np.concatenate([np.arange(6) * 1000,
                          (ends[:, None] + [0, step // 2]).ravel()])
    labels = rng.integers(0, CLASSES, (len(idx), SENSOR_H - CROP, SENSOR_W),
                          dtype=np.uint8)
    return ArrayEventStore(x, y, t, p), rmap, t[idx], labels


def phase_data(dev, kern_rows):
    """Phase 9: the host event path on both band wires, from an in-memory
    recording through the dataset, the loader and the device prefetch to
    the eval step (B=8), and through ``SequenceRecurrent`` to
    ``run_streaming_eval`` (B=1)."""
    t0 = time.perf_counter()
    rec = make_recording(5)
    log(f"data: in-memory recording of {DATA_EVENTS} events "
        f"({(int(rec[0].t[-1]) + 1) / 1e6:.2f} s), {len(rec[3])} labels, "
        f"made in {time.perf_counter() - t0:.1f} s")
    seqs = {wire: dsec.DSECSequence.from_store(
        *rec, nr_events_data=WINDOWS, nr_events_window=EVENTS,
        binning=wire) for wire in DATA_WIRES}
    n_groups = {"folded": SENSOR_H // 24 * (SENSOR_W // 128),
                "folded_bands": SENSOR_H // 24}
    for wire, seq in seqs.items():
        best = float("inf")
        for i in range(3):
            t0 = time.perf_counter()
            sample = seq[i]
            best = min(best, time.perf_counter() - t0)
        offs = sample["band_offsets"]
        if offs.shape != (WINDOWS, n_groups[wire] + 1):
            raise AssertionError(f"{wire}: band offsets {offs.shape}")
        log(f"host ingest, {wire} wire: {1e3 * best / WINDOWS:.3f} ms per "
            f"window of {EVENTS} events (slicer + fused native rectify, time "
            f"re-zero and ghost-folded binning, one thread; best of 3 "
            f"samples), offsets {offs.shape}, record capacity "
            f"{sample['raw_events'].shape[1]}")

    mods, step = bench.build_eval(8, dev)
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    hook = mods.head.register_forward_hook(keep_logits)
    n_batches = DATA_SAMPLES // 8
    label_px = 8 * (SENSOR_H - CROP) * SENSOR_W
    results = {}
    for wire in DATA_WIRES:
        dl = loader.BatchLoader(seqs[wire], batch_size=8, shuffle=False,
                                num_workers=4, collate_buffers=4,
                                prefetch_size=2, pin_memory=True)

        def one_pass(keep=None):
            for batch in loader.prefetch_to_device(iter(dl), size=2,
                                                   device=dev):
                out = step(to_soa(batch))
                if keep is not None:
                    keep.append((out["latent8"], out["pred"], out["cm"],
                                 logits[0]))
            torch.cuda.synchronize()

        reset_counts()
        keep = []
        one_pass(keep)
        counts = read_counts()
        want = ((n_batches, 3 * WINDOWS * n_batches) if wire == "folded"
                else (0, 3 * WINDOWS * n_batches) + (0,) * 6 + (n_batches,))
        log(f"data -> loader -> prefetch -> eval step, {wire} wire, "
            f"{n_batches} batches of B=8 T={WINDOWS}: launches "
            f"{show_counts(counts)}")
        need_counts(counts, want)
        add_launches(kern_rows, "data", counts)
        for latent, pred, cm, _ in keep:
            if (float(cm.sum()) != label_px or not torch.isfinite(latent).all()
                    or tuple(pred.shape) != (8, SENSOR_H - CROP, SENSOR_W)):
                raise AssertionError(f"bad eval output on the {wire} wire: "
                                     f"cm.sum {float(cm.sum())}")
        results[wire] = keep
        with tempfile.TemporaryDirectory() as tmp:
            prof = bench.profile_call(one_pass, tmp, f"data_{wire}", top=6)
        log(f"  {n_batches * 8 * WINDOWS / (prof['wall_ms'] / 1e3):.2f} "
            f"windows/s through the loader (one pass of {DATA_SAMPLES} "
            f"samples: wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['busy_ms']:.1f} ms over a {prof['span_ms']:.1f} ms span, "
            f"device idle share {100.0 * prof['idle_share']:.1f}%)")
    hook.remove()
    for i, (ref, got) in enumerate(zip(*(results[w] for w in DATA_WIRES))):
        slice_agreement(f"eval batch {i}, full-width band wire vs x-slot "
                        "wire", got[0], ref[0], got[1], ref[1], ref[3],
                        got[2], ref[2])
    del results, keep, mods, step
    torch.cuda.empty_cache()

    mods1, _ = bench.build_stream(1, dev)
    pipe = bench.make_pipeline()
    cms = {}
    for wire in DATA_WIRES:
        stream = dsec.SequenceRecurrent(
            dsec.DSECSequence.from_store(*rec, nr_events_data=1,
                                         nr_events_window=EVENTS,
                                         binning=wire),
            nr_events_window=EVENTS)
        scored = sum(w < DATA_STREAM for w in stream.label_idx)

        def run():
            return run_streaming_eval(
                mods1, (stream[i] for i in range(DATA_STREAM)), pipe)

        reset_counts()
        m = run()
        counts = read_counts()
        want = ((DATA_STREAM, 3 * DATA_STREAM) if wire == "folded"
                else (0, 3 * DATA_STREAM) + (0,) * 6 + (DATA_STREAM,))
        log(f"data -> SequenceRecurrent -> run_streaming_eval B=1, {wire} "
            f"wire, {DATA_STREAM} windows ({scored} scored): launches "
            f"{show_counts(counts)}")
        need_counts(counts, want)
        add_launches(kern_rows, "data_stream", counts)
        cm_sum = float(m.confusion.sum())
        if scored < 2 or cm_sum != scored * label_px / 8:
            raise AssertionError(f"bad stream output on the {wire} wire: "
                                 f"cm.sum {cm_sum}, {scored} scored")
        cms[wire] = m.confusion.astype(np.float64)
        with tempfile.TemporaryDirectory() as tmp:
            prof = bench.profile_call(run, tmp, f"data_stream_{wire}", top=6)
        log(f"  {DATA_STREAM / (prof['wall_ms'] / 1e3):.2f} windows/s "
            f"(wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['busy_ms']:.1f} ms over a {prof['span_ms']:.1f} ms span, "
            f"device idle share {100.0 * prof['idle_share']:.1f}%)")
    moved = 100.0 * np.abs(cms["folded_bands"] - cms["folded"]).sum() / (
        2 * cms["folded"].sum())
    log(f"  streaming, full-width band wire vs x-slot wire: confusion matrix "
        f"{moved:.3f}% of the pixels moved (bound <= "
        f"{100.0 - SLICE_PRED_AGREE}%)")
    if not moved <= 100.0 - SLICE_PRED_AGREE:
        raise AssertionError("the band wires disagree in streaming")
    del mods1, rec, seqs
    torch.cuda.empty_cache()


# DDD17 (phase 5c): bench_extra.py's DDD17 shapes, B=16 x T=20 windows of
# 32k integer-coordinate events on 260x346, 6 classes; the rollout at
# 200x352, the UDA train rollout at the 120x216 crop. The cells of one window
# at each geometry (B, C, H, W) are held against their plain versions there.
DDD17_B = bench.DDD17_BATCH
DDD17_CELLS = {"200x352": [(DDD17_B, 64, 100, 176), (DDD17_B, 128, 50, 88),
                           (DDD17_B, 256, 25, 44)],
               "120x216": [(DDD17_B, 64, 60, 108), (DDD17_B, 128, 30, 54),
                           (DDD17_B, 256, 15, 27)]}
DDD17_STORE_IMAGES = DDD17_B


def ddd17_voxel_inputs(batch):
    """The B1 kernel's operands of a DDD17 batch, all B x T windows
    window-major, and the padded geometry: ``batch_voxel.band_operands``,
    which ``voxelize_band`` launches B1 on."""
    flat = lambda a: a.transpose(0, 1).reshape(-1, a.shape[-1])
    h, w = bench.DDD17_SENSOR
    return batch_voxel.band_operands(
        *(flat(batch[k]) for k in ("ev_x", "ev_y", "ev_t", "ev_p", "ev_valid",
                                   "ev_band_offsets")),
        num_bins=BINS, height=h, width=w, trilinear=False)


def ddd17_kernels(dev, kern_rows):
    """B1 over one DDD17 step's 320 windows of integer records, and B2 and
    B2-int8 at the cells of both DDD17 geometries, each against its plain
    version on the same inputs, with kernel, plain and bound times."""
    h, w = bench.DDD17_SENSOR
    batch = bench.make_ddd17_batch(11, DDD17_B, dev)
    args, kw = ddd17_voxel_inputs(batch)
    n_win = args[0].shape[0]
    n0 = voxel_folded.launches
    grid_k, stats_k = voxel_folded.voxelize_folded(*args, **kw)
    torch.cuda.synchronize()
    if voxel_folded.launches != n0 + 1:
        raise AssertionError("voxelize_folded did not launch B1 once")
    grid_p, stats_p = voxel_folded.voxelize_folded_ref(*args, **kw)
    err_raw = (grid_k - grid_p).abs().max().item()
    err = (normalize_from_stats(grid_k, stats_k)
           - normalize_from_stats(grid_p, stats_p)).abs().max().item()
    live = grid_k[:, :, :h, :w].double()
    stats_live = torch.stack([live.sum((1, 2, 3)), (live * live).sum(
        (1, 2, 3)), (live != 0).sum((1, 2, 3)).double()], -1)
    pad_empty = not (grid_k[..., w:].any() or grid_k[:, :, h:].any())
    stats_rel = ((stats_k.double() - stats_live).abs()
                 / stats_live.abs().clamp(min=1.0)).max().item()
    log(f"DDD17 B1 voxel_folded ({n_win} windows of {bench.DDD17_EVENTS} "
        f"integer events, {kw['height']}x{kw['width']} grid, "
        f"{(kw['height'] // voxel_folded.tile_h_for_bins(BINS)) * 3} groups):"
        f" max|d| raw grid {err_raw:.3e}, normalized grid {err:.3e} (bound "
        f"{VOXEL_ATOL}); padded rows and columns empty {pad_empty}; stats vs "
        f"the sensor grid's rel max|d| {stats_rel:.3e} (bound 1e-5)")
    if not (err <= VOXEL_ATOL and pad_empty and stats_rel <= 1e-5):
        raise AssertionError("B1 on integer records disagrees with its plain "
                             "version")
    del grid_p, live
    ms = cuda_ms(lambda: voxel_folded.voxelize_folded(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: voxel_folded.voxelize_folded_ref(*args, **kw),
                       3)
    # the bound writes the sensor grid the pipeline keeps (the kernel's
    # tile pad, checked empty above, is not work the function needs)
    offs, live_events = args[4], int(args[4][:, -1].sum())
    bound_ms, bound_by = voxel_bound(live_events, offs.numel(),
                                     n_win * kw["bins"] * h * w + 3 * n_win,
                                     corners=2)
    padded_ms, _ = voxel_bound(live_events, offs.numel(),
                               grid_k.numel() + 3 * n_win, corners=2)
    log(f"DDD17 B1 time for {n_win} windows: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; of the "
        f"{h}x{w} sensor grid, {padded_ms:.3f} ms of the padded "
        f"{kw['height']}x{kw['width']} one), share of bound "
        f"{100.0 * bound_ms / ms:.1f}%")
    row = kern_rows[KERNEL_NAMES.index("B1")]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ddd17"] = {"windows": n_win, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
    del grid_k, args, batch
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(12)
    for int8 in (False, True):
        name = "B2-int8" if int8 else "B2"
        impl = "pallas_int8_interpret" if int8 else "pallas"
        kind = "int8" if int8 else "bf16"
        plain = (conv_lstm.conv_lstm_int8_ref if int8
                 else conv_lstm.conv_lstm_ref)
        row = kern_rows[KERNEL_NAMES.index(name)]
        per_geometry = {}
        for geo, shapes in DDD17_CELLS.items():
            tot = [0.0, 0.0, 0.0]
            for b, ch, hh, ww in shapes:
                x, hs, c, wt, bias = cell_inputs(g, dev, b, ch, hh, ww,
                                                 int8=int8)
                prep = conv_lstm.prepare_cell_weights(wt, impl)
                h_p, c_p = plain(x, hs, c, wt, bias)
                h_k, c_k = conv_lstm.conv_lstm_cell(
                    x, hs, c.clone(), wt, bias, impl=impl, prepared=prep)
                torch.cuda.synchronize()
                if int8:
                    bad = sum(int(((got.float() - want.float()).abs()
                                   > bf16_ulp(got, want)
                                   + INT8_ULP_SLACK).sum())
                              for got, want in ((h_k, h_p), (c_k, c_p)))
                    e = max((h_k.float() - h_p.float()).abs().max().item(),
                            (c_k.float() - c_p.float()).abs().max().item())
                    what = (f"max|d| {e:.3e}, {bad} values beyond one bf16 "
                            "ulp (bound 0)")
                    ok = bad == 0
                else:
                    eh = (h_k.float() - h_p.float()).abs().max().item()
                    ec = (c_k.float() - c_p.float()).abs().max().item()
                    e = max(eh, ec)
                    what = (f"max|dh| {eh:.3e} (bound {LSTM_H_ATOL}), max|dc| "
                            f"{ec:.3e} (bound {LSTM_C_ATOL})")
                    ok = eh <= LSTM_H_ATOL and ec <= LSTM_C_ATOL
                row["max_abs_err"] = max(row["max_abs_err"], e)
                cw = c.clone()
                t_k = cuda_ms(lambda: conv_lstm.conv_lstm_cell(
                    x, hs, cw, wt, bias, impl=impl, prepared=prep), 20)
                t_p = cuda_ms(lambda: plain(x, hs, c, wt, bias), 3)
                _, (t_b, by) = cell_bound(x, wt, bias, kind)
                tot = [tot[0] + t_k, tot[1] + t_p, tot[2] + t_b]
                log(f"DDD17 {name} B={b} C={ch} {hh}x{ww}: {what}; kernel "
                    f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {t_b:.4f} ms "
                    f"({by}), share of bound {100.0 * t_b / t_k:.1f}%")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {b}x{ch}x{hh}x{ww}")
                del x, hs, c, cw, h_p, c_p, h_k, c_k
            per_geometry[geo] = {"ms": tot[0], "plain_ms": tot[1],
                                 "bound_ms": tot[2]}
            log(f"DDD17 {name}, the three cells of a {geo} window at "
                f"B={DDD17_B}: kernel {tot[0]:.3f} ms, plain {tot[1]:.3f} ms,"
                f" bound {tot[2]:.4f} ms, share {100.0 * tot[2] / tot[0]:.1f}%")
        row["ddd17"] = per_geometry
    torch.cuda.empty_cache()


def ddd17_plain_logits(mods, recon, pipe, batch):
    """The plain path's latent8 and logits of an eval rollout."""
    with plain_versions(), torch.inference_mode():
        windows, _ = pipe.build_all(batch, out_dtype=mods.e2vid.dtype)
        _, _, latent = recon.rollout(windows)
        return latent[8].float(), mods.head(latent)[1].float()


def ddd17_rates(what, runs, batch, order, windows):
    """Median windows/s of each run of ``runs`` (``timed_steps``)."""
    samples = timed_steps(runs, order, batch)
    for name, ts in samples.items():
        med = statistics.median(ts)
        log(f"{what} ({name}): {windows / med:.2f} windows/s, median "
            f"{1e3 * med:.1f} ms over {len(ts)} steps "
            f"{[round(1e3 * t, 1) for t in ts]}")


def ddd17_store(tmp: str, rng, name: str = "dir0",
                images: int = DDD17_STORE_IMAGES) -> str:
    """A DDD17 recording directory ``tmp/name``: ``images`` images, each
    with a step's 20 x 32k events before it (int64 ns times, int16 x, y,
    p), and the 50 ms image index."""
    span = WINDOWS * bench.DDD17_EVENTS
    n = span * images + 5000
    h, w = bench.DDD17_SENSOR
    t = np.cumsum(rng.integers(1000, 50_000, n, dtype=np.int64))
    xyp = np.stack([rng.integers(0, w, n), rng.integers(0, h, n),
                    rng.integers(0, 2, n)], axis=1).astype(np.int16)
    d = os.path.join(tmp, name)
    os.makedirs(os.path.join(d, "index"))
    t.tofile(os.path.join(d, "events.dat.t"))
    xyp.tofile(os.path.join(d, "events.dat.xyp"))
    ends = 5000 + span * (1 + np.arange(images))
    np.save(os.path.join(d, "index", "index_50ms.npy"),
            np.stack([t[ends - 1], ends, ends - 1000], 1).astype(np.int64))
    return d


def phase_ddd17(dev, kern_rows):
    """Phase 5c: DDD17 on the card (module docstring)."""
    ddd17_kernels(dev, kern_rows)
    b = DDD17_B
    hw_val, hw_crop = bench.DDD17_RESIZED, bench.DDD17_CROP

    # --- supervised train, then eval ---
    batch = bench.make_ddd17_batch(3, b, dev)
    mods, state, step = bench.build_ddd17("ess_supervised", dev)
    n_exact, n_int8 = int8_cells(b, *hw_val)
    reset_counts()
    loss = float(step(state, batch)["loss"])
    counts = read_counts()
    log(f"DDD17 supervised train step B={b} T={WINDOWS} "
        f"{bench.DDD17_SENSOR} -> {hw_val}: launches {show_counts(counts)} "
        f"(by the size rule {n_int8} int8 cells a window, {n_exact} exact)")
    need_counts(counts, (1, n_exact * WINDOWS, n_int8 * WINDOWS, 0, 0, 0))
    add_launches(kern_rows, "ddd17_train", counts)
    _, state_p, step_p = bench.build_ddd17("ess_supervised", dev)
    with plain_versions():
        loss_p = float(step_p(state_p, batch)["loss"])
    pipe = builder.make_pipeline(mods.cfg)
    with torch.no_grad():
        windows, _ = pipe.build_all(batch, out_dtype=mods.e2vid.dtype)
        lat_k = mods.recon_train.rollout(windows, decode=False)[2][8].float()
        with plain_versions():
            lat_p = mods.recon_train.rollout(windows,
                                             decode=False)[2][8].float()
    rel = ((lat_k - lat_p).abs().max() / lat_p.abs().max()).item()
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    log(f"  step 1, kernel path vs plain path: loss {loss:.6f} vs "
        f"{loss_p:.6f} (relative difference {loss_rel:.3e}, bound "
        f"{TRAIN_LOSS_REL}); latent8 rel max|d| {rel:.3e} (bound "
        f"{TRAIN_LATENT_REL})")
    if not (np.isfinite(loss) and loss_rel <= TRAIN_LOSS_REL
            and rel <= TRAIN_LATENT_REL):
        raise AssertionError("DDD17 train: kernel path disagrees with the "
                             "plain path")
    del windows, lat_k, lat_p
    torch.cuda.reset_peak_memory_stats()
    runs = {"int8 kernels": (state, step), "plain versions": (state_p, step_p)}
    timed_steps(runs, (("int8 kernels", 1),), batch)
    log(f"  peak device memory of the DDD17 supervised train step: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    ddd17_rates(f"DDD17 supervised train step B={b}", runs, batch,
                (("plain versions", 1), ("int8 kernels", 3),
                 ("int8 kernels", 3), ("plain versions", 1)), b * WINDOWS)
    del state_p, step_p, runs

    eval_pipe = builder.make_pipeline(mods.cfg, train=False)
    eval_step = make_eval_step(mods, eval_pipe)
    reset_counts()
    out = eval_step(batch)
    counts = read_counts()
    log(f"DDD17 supervised eval step B={b}: launches {show_counts(counts)}")
    need_counts(counts, (1, 3 * WINDOWS, 0, 0, 0, 0))
    add_launches(kern_rows, "ddd17_eval", counts)
    lat_p, logits_p = ddd17_plain_logits(mods, mods.recon_val, eval_pipe,
                                         batch)
    if float(out["cm"].sum()) != float((batch["label"] != 255).sum()):
        raise AssertionError("DDD17 eval: the confusion matrix misses pixels")
    slice_agreement("DDD17 eval, kernel path vs plain path", out["latent8"],
                    lat_p, out["pred"], logits_p.argmax(1), logits_p)
    del out, lat_p, logits_p
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for plain in (True, False, False, True):
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(eval_step(batch)["loss"])
            torch.cuda.synchronize()
            ts.append((plain, time.perf_counter() - t0))
    for plain in (False, True):
        med = statistics.median(t for p_, t in ts if p_ == plain)
        log(f"DDD17 supervised eval step B={b} "
            f"({'plain versions' if plain else 'kernels'}): "
            f"{b * WINDOWS / med:.2f} windows/s, median {1e3 * med:.1f} ms")
    log(f"  peak device memory of the DDD17 eval step: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del mods, state, step, eval_step
    torch.cuda.empty_cache()

    # --- UDA train at the 120x216 crop, then eval B at 200x352 ---
    batch_u = bench.make_ddd17_batch(4, b, dev, uda_=True)
    mods, state, step = bench.build_ddd17("ess", dev)
    n_exact, n_int8 = int8_cells(b, *hw_crop)
    reset_counts()
    out = {k: float(v) for k, v in step(state, batch_u).items()}
    counts = read_counts()
    log(f"DDD17 UDA train step B={b} T={WINDOWS}, the {hw_crop} crop: "
        f"launches {show_counts(counts)} (by the size rule {n_int8} int8 "
        f"cell a window, level 0; {n_exact} exact)")
    need_counts(counts, (1, n_exact * WINDOWS, n_int8 * WINDOWS, 0, 0, 0))
    add_launches(kern_rows, "ddd17_uda_train", counts)
    _, state_p, step_p = bench.build_ddd17("ess", dev)
    with plain_versions():
        out_p = {k: float(v) for k, v in step_p(state_p, batch_u).items()}
    rels = {k: abs(out[k] - v) / max(abs(v), 1e-12) for k, v in out_p.items()}
    log("  step 1, kernel path vs plain path, relative difference: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rels.items()))
        + f" (bound on loss {TRAIN_LOSS_REL})")
    if not (sorted(out) == UDA_LOSS_KEYS
            and all(np.isfinite(v) for v in out.values())
            and rels["loss"] <= TRAIN_LOSS_REL):
        raise AssertionError("DDD17 UDA: kernel path disagrees with the "
                             "plain path")
    torch.cuda.reset_peak_memory_stats()
    runs = {"int8 kernels": (state, step), "plain versions": (state_p, step_p)}
    timed_steps(runs, (("int8 kernels", 1),), batch_u)
    log(f"  peak device memory of the DDD17 UDA train step: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    ddd17_rates(f"DDD17 UDA train step B={b}", runs, batch_u,
                (("plain versions", 1), ("int8 kernels", 3),
                 ("int8 kernels", 3), ("plain versions", 1)), b * WINDOWS)
    del state_p, step_p, runs, batch_u

    eval_b = uda.make_eval_step_b(mods, eval_pipe)
    reset_counts()
    out = eval_b(batch)
    counts = read_counts()
    log(f"DDD17 UDA eval B step B={b} at {hw_val}: launches "
        f"{show_counts(counts)}")
    need_counts(counts, (1, 3 * WINDOWS, 0, 0, 0, 0))
    add_launches(kern_rows, "ddd17_uda_eval_b", counts)
    lat_p, logits_p = ddd17_plain_logits(mods, mods.recon_val, eval_pipe,
                                         batch)
    if not (out["img_fake"].shape == (b, 1) + hw_val
            and bool(torch.isfinite(out["img_fake"]).all())):
        raise AssertionError("DDD17 UDA eval B: bad img_fake")
    slice_agreement("DDD17 UDA eval B, kernel path vs plain path",
                    out["latent8"], lat_p, out["pred"], logits_p.argmax(1),
                    logits_p)
    del mods, state, step, eval_b, out, lat_p, logits_p, batch
    torch.cuda.empty_cache()

    # --- the host path: a written store -> windows -> binning -> eval ---
    rng = np.random.default_rng(13)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        store = DDD17EventStore.open(ddd17_store(tmp, rng))
        log(f"DDD17 store of {len(store.t)} events written and opened in "
            f"{time.perf_counter() - t0:.1f} s")
        samples, host_s = [], []
        for i in range(DDD17_STORE_IMAGES):
            t0 = time.perf_counter()
            samples.append(ddd17.events_for_image(
                store, i, nr_events_data=WINDOWS,
                nr_events_window=bench.DDD17_EVENTS))
            host_s.append(time.perf_counter() - t0)
        del store
    log(f"  host ingest (pad_windows_ddd17 + integer band binning, one "
        f"thread): {1e3 * statistics.median(host_s) / WINDOWS:.3f} ms per "
        f"window of {bench.DDD17_EVENTS} events (median of "
        f"{DDD17_STORE_IMAGES} samples)")
    recs = np.stack([s["raw_events"] for s in samples])
    host = {"ev_x": recs[..., 0], "ev_y": recs[..., 1], "ev_t": recs[..., 2],
            "ev_p": recs[..., 3],
            "ev_valid": np.stack([s["valid"] for s in samples]),
            "ev_band_offsets": np.stack([s["band_offsets"]
                                         for s in samples]),
            "label": rng.integers(0, bench.DDD17_CLASSES, (b,) + hw_val)}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in host.items()}
    del samples, recs, host
    mods = build_modules(bench.make_ddd17_cfg("ess_supervised"), device=dev)
    init_params(mods, torch.Generator().manual_seed(0))
    eval_pipe = builder.make_pipeline(mods.cfg, train=False)
    eval_step = make_eval_step(mods, eval_pipe)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eval_step(batch)
    float(out["loss"])
    dt = time.perf_counter() - t0
    counts = read_counts()
    log(f"DDD17 store -> pad_windows_ddd17 -> integer band binning -> eval "
        f"step B={b}: launches {show_counts(counts)}; {b * WINDOWS / dt:.2f}"
        f" windows/s on the device (one step, {1e3 * dt:.1f} ms)")
    need_counts(counts, (1, 3 * WINDOWS, 0, 0, 0, 0))
    add_launches(kern_rows, "ddd17_store_eval", counts)
    lat_p, logits_p = ddd17_plain_logits(mods, mods.recon_val, eval_pipe,
                                         batch)
    slice_agreement("DDD17 store eval, kernel path vs plain path",
                    out["latent8"], lat_p, out["pred"], logits_p.argmax(1),
                    logits_p)
    del mods, eval_step, out, lat_p, logits_p, batch
    torch.cuda.empty_cache()


# The trainer and its CLIs (phase 5d): configs/settings_DDD17_supervised.yaml
# as written but for the dataset, the log directory, two epochs and no paired
# frames, on a DDD17 tree written here. Seven dir* folders, so that JAX's
# split table finds its splits (train 0, 2, 3, 5, 6; valid 1; test 4), each an
# event store as ddd17_store makes one and 8-bit grayscale PNG masks; the
# train folders hold 35 masks (two steps an epoch at B=16, drop_last), the
# valid folder one batch.
CLI_MASKS = {0: 7, 1: DDD17_B, 2: 7, 3: 7, 4: 1, 5: 7, 6: 7}
CLI_EPOCHS = 2
CLI_STEPS = 2                # train steps an epoch
CLI_MIOU_ATOL = 0.5          # evaluate CLI vs the training run's last mIoU
CLI_CONFIGS = ("configs/settings_DDD17_supervised.yaml",
               "configs/settings_DDD17.yaml")


def png_file(img: np.ndarray, kinds) -> bytes:
    """An 8-bit PNG of ``img``, gray (H, W) or RGB (H, W, 3) uint8, row
    ``y`` filtered with ``kinds[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth); every row is filtered at once from the unfiltered image."""
    import struct
    import zlib

    h = img.shape[0]
    ch = 1 if img.ndim == 2 else 3
    v = img.reshape(h, -1).astype(np.int16)
    a = np.pad(v, ((0, 0), (ch, 0)))[:, :-ch]
    b = np.pad(v, ((1, 0), (0, 0)))[:-1]
    c = np.pad(b, ((0, 0), (ch, 0)))[:, :-ch]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    k = np.asarray(kinds, np.uint8)
    pred = np.select([k[:, None] == i for i in (1, 2, 3, 4)],
                     [a, b, (a + b) >> 1, paeth], 0)
    rows = ((v - pred) & 255).astype(np.uint8)
    data = zlib.compress(np.concatenate([k[:, None], rows], 1).tobytes())

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, 8, 0 if ch == 1 else 2,
                       0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", data) + chunk(b"IEND", b""))


def ddd17_tree(tmp: str, rng) -> str:
    """The DDD17 tree of phase 5d under ``tmp/ddd17``: CLI_MASKS masks a
    folder (class ids 0-5, ~5 % ignored), each image with 20 x 32k events
    before it."""
    root = os.path.join(tmp, "ddd17")
    h, w = bench.DDD17_SENSOR
    for i, n in CLI_MASKS.items():
        d = ddd17_store(root, rng, f"dir{i}", images=n)
        os.makedirs(os.path.join(d, "segmentation_masks"))
        for m in range(n):
            mask = rng.integers(0, bench.DDD17_CLASSES, (h, w)).astype(
                np.uint8)
            mask[rng.random((h, w)) < 0.05] = 255
            with open(os.path.join(d, "segmentation_masks",
                                   f"seg_{m + 1:05d}.png"), "wb") as f:
                f.write(png_file(mask, np.arange(h) % 2 + 1))  # Sub, Up
    return root


def cli_yaml(tmp: str, src: str, name: str, changes: dict) -> str:
    """``src`` with ``changes`` ({"a.b.c": value}) applied, written to
    ``tmp/name``; each change is logged."""
    import yaml

    with open(src) as f:
        raw = yaml.safe_load(f)
    for dotted, value in changes.items():
        *path, key = dotted.split(".")
        node = raw
        for k in path:
            node = node[k]
        log(f"  {os.path.basename(src)} -> {name}: {dotted} "
            f"{node.get(key)!r} -> {value!r}")
        node[key] = value
    out = os.path.join(tmp, name)
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return out


@contextlib.contextmanager
def tapped_steps(calls: list):
    """Wrap the step builders of ``train.supervised`` and ``train.uda`` so
    that each step call appends (kind, its launch counts, its loss or None)
    to ``calls``; the Trainer builds its steps through them."""
    from ess_tpu_torch.train import supervised

    builders = [(supervised, "make_train_step", "train"),
                (supervised, "make_eval_step", "eval"),
                (uda, "make_train_step", "train"),
                (uda, "make_eval_step_a", "eval_a"),
                (uda, "make_eval_step_b", "eval")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in builders]

    def tap(make, kind):
        def make_tapped(*args, **kwargs):
            step = make(*args, **kwargs)

            def tapped(*a, **kw):
                before = read_counts(sync=False)
                out = step(*a, **kw)
                after = read_counts(sync=False)
                loss = float(out["loss"]) if kind == "train" else None
                calls.append((kind, tuple(x - y for x, y in
                                          zip(after, before)), loss))
                return out
            return tapped
        return make_tapped

    for (mod, name, kind), (_, _, make) in zip(builders, saved):
        setattr(mod, name, tap(make, kind))
    try:
        yield
    finally:
        for mod, name, make in saved:
            setattr(mod, name, make)


@contextlib.contextmanager
def timed_epochs(seconds: list):
    """Time each ``Trainer.train_epoch`` (wall, through the loader)."""
    from ess_tpu_torch.train import loop

    run = loop.Trainer.train_epoch

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(self)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    loop.Trainer.train_epoch = timed
    try:
        yield
    finally:
        loop.Trainer.train_epoch = run


def quiet(fn, *args, **kwargs) -> str:
    """Run ``fn`` with its standard output captured; return the text."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue()


def captured(fn, *args, **kwargs) -> str:
    """Run ``fn`` with its standard output captured, then log it."""
    text = quiet(fn, *args, **kwargs)
    for line in text.splitlines():
        log(f"  | {line}")
    return text


def printed_summary(text: str) -> dict:
    return {k: float(v) for k, v in (line.split(": ", 1) for line in
            text.splitlines() if line.startswith("semseg_"))}


def need_calls(calls, kind: str, n: int, want) -> None:
    """``n`` step calls of ``kind``, each with the launch counts ``want``."""
    mine = [c for c in calls if c[0] == kind]
    if len(mine) != n:
        raise AssertionError(f"{len(mine)} {kind} step calls; want {n}")
    for _, counts, _ in mine:
        need_counts(counts, want)


def phase_cli(dev, kern_rows, tmp: str, root: str):
    """Phase 5d: the port's train and evaluate CLIs in-process on the DDD17
    tree ``root`` (:func:`ddd17_tree`) at the full width of the DDD17
    supervised config, and a resume (module docstring); ``tmp`` takes the
    runs."""
    from ess_tpu_torch.cli import evaluate as cli_evaluate
    from ess_tpu_torch.cli import train as cli_train
    from ess_tpu_torch.core.config import load_config
    from ess_tpu_torch.io import timers
    from ess_tpu_torch.train import loop

    t_phase = time.perf_counter()
    b, win = DDD17_B, DDD17_B * WINDOWS
    per_call = (1, 3 * WINDOWS)     # B1, B2: lstm_impl_train unset -> B2
    log(f"phase 5d config, from {CLI_CONFIGS[0]}:")
    base = {"dataset.DDD17_events.dataset_path": root,
            "optim.num_epochs": CLI_EPOCHS,
            "dataset.DDD17_events.require_paired_data_val": False}
    yaml_sup = cli_yaml(tmp, CLI_CONFIGS[0], "supervised.yaml", {
        **base, "dir.log": os.path.join(tmp, "runs")})
    cfg = load_config(yaml_sup)
    ds = cfg.dataset.sensor_b
    if (cfg.optim.batch_size_b, ds.nr_events_data, ds.nr_events_window,
            cfg.model.e2vid_base_channels, cfg.model.compute_dtype,
            cfg.model.data_augmentation_train, cfg.model.lstm_impl_train,
            cfg.task.semseg_num_classes) != (
            b, WINDOWS, bench.DDD17_EVENTS, 32, "bfloat16", True, None,
            bench.DDD17_CLASSES):
        raise AssertionError(f"{CLI_CONFIGS[0]} is not the width phase "
                             "5d expects")

    # --- 1. python -m ess_tpu_torch.cli.train, two epochs ---
    calls, epoch_s = [], []
    timers.reset_timers()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with tapped_steps(calls), timed_epochs(epoch_s):
        out = captured(cli_train.main, ["--settings_file", yaml_sup])
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = list(timers._ACCUM["train_step"])
    timers.reset_timers()   # nothing left for the report at exit
    n_train, n_val = CLI_EPOCHS * CLI_STEPS, CLI_EPOCHS + 1
    log(f"cli.train: {n_train} train steps, {n_val} validations of one "
        f"batch; launches {show_counts(counts)}")
    need_calls(calls, "train", n_train, per_call)
    need_calls(calls, "eval", n_val, per_call)
    need_counts(counts, [(n_train + n_val) * k for k in per_call])
    add_launches(kern_rows, "cli_train", counts)
    summary = printed_summary(out)
    losses = [c[2] for c in calls if c[0] == "train"]
    runs = sorted(os.listdir(os.path.join(tmp, "runs")))
    run_dir = os.path.join(tmp, "runs", runs[0])
    ckpt_keys = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    with open(os.path.join(run_dir, "checkpoints", "1",
                           "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    logged_loss = [r["train/loss"] for r in logged if "train/loss" in r]
    log(f"  losses {[round(v, 5) for v in losses]}; train/loss lines "
        f"{logged_loss}; checkpoints {ckpt_keys} (metadata of 1: "
        f"{meta}); summary {summary}")
    miou = summary.get("semseg_sensor_b_mean_iou", float("nan"))
    if not (len(runs) == 1 and ckpt_keys == ["0", "1"]
            and meta == {"epoch": 1, "step_count": n_train}
            and len(logged_loss) == CLI_EPOCHS
            and all(np.isfinite(losses + logged_loss))
            and 0.0 <= miou <= 100.0
            and os.path.isfile(os.path.join(run_dir, "supervised.yaml"))):
        raise AssertionError("cli.train: bad run")
    ms = 1e3 * statistics.median(step_s)
    log(f"  ms per train step in the Trainer (step + loss read): "
        f"{[round(1e3 * t, 1) for t in step_s]}, median {ms:.1f} ms, "
        f"{win / (ms / 1e3):.2f} windows/s")
    for e, t in enumerate(epoch_s):
        log(f"  epoch {e} through the loader: {1e3 * t / CLI_STEPS:.1f} "
            f"ms per step, {CLI_STEPS * win / t:.2f} windows/s")
    log(f"  peak device memory of the train CLI: {peak / 2 ** 30:.2f} "
        f"GiB; {bench.card()}")

    # the first step on the plain versions, from the same seed and batch
    _, train_b, _, _ = cli_train.build_loaders(cfg)
    with plain_versions():
        tr = loop.Trainer(cfg, train_b=train_b,
                          log_dir=os.path.join(tmp, "plain"))
        batches = tr._train_batches()
        loss_p = float(tr.train_step(tr.state, next(batches))["loss"])
        batches.close()
    rel = abs(losses[0] - loss_p) / abs(loss_p)
    log(f"  step 1, kernel path vs plain path: loss {losses[0]:.6f} vs "
        f"{loss_p:.6f} (relative difference {rel:.3e}, bound "
        f"{TRAIN_LOSS_REL})")
    if not rel <= TRAIN_LOSS_REL:
        raise AssertionError("cli.train: kernel path disagrees with the "
                             "plain path")
    del tr, batches

    t0 = time.perf_counter()
    ingest = []
    for i in range(8):
        t1 = time.perf_counter()
        train_b.dataset[i]
        ingest.append(time.perf_counter() - t1)
    log(f"  host ingest (DDD17Events.__getitem__: memmaps -> "
        f"pad_windows_ddd17 -> band binning, PNG mask read and resize; "
        f"one thread): {1e3 * statistics.median(ingest) / WINDOWS:.3f} "
        f"ms per window of {bench.DDD17_EVENTS} events (median of 8)")
    for workers in sorted({1, cfg.hardware.num_cpu_workers}):
        batches = iter(loader.BatchLoader(train_b.dataset, b,
                                          shuffle=False,
                                          num_workers=workers))
        t0 = time.perf_counter()
        next(batches)
        dt = time.perf_counter() - t0
        batches.close()
        log(f"  the loader alone, {workers} thread(s): {1e3 * dt:.1f} ms "
            f"a batch of {b} samples ({1e3 * dt / win:.3f} ms a window)")

    # --- 2. resume from the run, one more epoch profiled ---
    yaml_res = cli_yaml(tmp, CLI_CONFIGS[0], "resume.yaml", {
        **base, "dir.log": os.path.join(tmp, "resumed"),
        "checkpoint.resume_training": True,
        "checkpoint.resume_file": run_dir})
    cfg_r = load_config(yaml_res)
    _, train_b, _, val_b = cli_train.build_loaders(cfg_r)
    tr = loop.Trainer(cfg_r, train_b=train_b, val_b=val_b,
                      profile_steps=(n_train, n_train + 1))
    saved = torch.load(os.path.join(run_dir, "checkpoints", "1",
                                    "state.pt"), weights_only=True)
    head = tr.state.head.state_dict()
    same = all(torch.equal(head[k].cpu(), v)
               for k, v in saved["head"].items())
    log(f"  resumed: epoch {tr.epoch}, step {tr.step_count}, RAdam step "
        f"{tr.state.opt_back.step_count}; head bit-identical to the "
        f"saved one: {same}")
    if not (tr.epoch == CLI_EPOCHS and tr.step_count == n_train
            and tr.state.step == n_train
            and tr.state.opt_back.step_count == n_train and same
            and sorted(head) == sorted(saved["head"])):
        raise AssertionError("resume: bad state")
    epoch_s = []
    reset_counts()
    with timed_epochs(epoch_s):
        tr.train_epoch()
    counts = read_counts()
    timers.reset_timers()
    need_counts(counts, [CLI_STEPS * k for k in per_call])
    add_launches(kern_rows, "cli_resumed_epoch", counts)
    prof = bench.trace_summary(os.path.join(tr.log_dir, "profile",
                                            "trace.json"), top=6)
    log(f"  the resumed epoch: {1e3 * epoch_s[0] / CLI_STEPS:.1f} ms per "
        f"step through the loader; profiled step {n_train + 1}: device "
        f"busy {prof['busy_ms']:.1f} ms of a {prof['span_ms']:.1f} ms "
        f"span, idle share {100 * prof['idle_share']:.1f} %; top "
        + ", ".join(f"{k['name'][:40]} {k['ms']:.2f} ms ({k['calls']})"
                    for k in prof["top"]))
    del tr, saved
    torch.cuda.empty_cache()

    # --- 3. python -m ess_tpu_torch.cli.evaluate on the run ---
    calls = []
    reset_counts()
    with tapped_steps(calls):
        out = captured(cli_evaluate.main, [
            "--settings_file", yaml_sup, "--checkpoint",
            os.path.join(run_dir, "checkpoints")])
    counts = read_counts()
    need_calls(calls, "eval", 1, per_call)
    add_launches(kern_rows, "cli_evaluate", counts)
    miou_e = printed_summary(out).get("semseg_sensor_b_mean_iou",
                                      float("nan"))
    log(f"cli.evaluate: launches {show_counts(counts)}; mIoU "
        f"{miou_e:.4f} against the training run's last {miou:.4f} "
        f"(bound {CLI_MIOU_ATOL})")
    if not abs(miou_e - miou) <= CLI_MIOU_ATOL:
        raise AssertionError("cli.evaluate disagrees with the training "
                             "run's last validation")
    torch.cuda.empty_cache()

    if "cv2" in sys.modules or "h5py" in sys.modules:
        raise AssertionError("phase 5d imported cv2 or h5py")
    log(f"phase 5d took {time.perf_counter() - t_phase:.1f} s")


# ESS UDA from disk (phase 5e): configs/settings_DDD17.yaml as written but
# for its two dataset paths, the log directory and two epochs: sensor A the
# Cityscapes_gray image set on a Cityscapes tree written here (CITY_TRAIN +
# CITY_VAL frames at the real 2048x1024 RGB, smooth scenes with sensor noise,
# rows filtered by a random mix of Sub, Up, Average and Paeth, and gray
# labelIds masks of regions), sensor B phase 5d's DDD17 tree with grayscale
# frames added to its valid folder (the config pairs them at validation).
# Two steps an epoch at B=16 on each side.
CITY_TRAIN, CITY_VAL = 32, 16
CITY_HW = (1024, 2048)
CITY_NOISE = 2.0             # sensor noise of the written scenes, levels
CITY_GEOMETRIES = (("random_crop", 200, 352), ("full_frame", 440, 640))


def cityscapes_tree(tmp: str, rng) -> tuple:
    """The Cityscapes tree of phase 5e under ``tmp/cityscapes``; returns
    (its root, mean bytes of a frame's PNG, of a mask's)."""
    from concurrent.futures import ThreadPoolExecutor

    root = os.path.join(tmp, "cityscapes")
    h, w = CITY_HW
    yy, xx = np.mgrid[0:h + 256, 0:w + 256].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(xx / 61 + yy / 97),
                     128 + 80 * np.cos(xx / 37 - yy / 53),
                     128 + 70 * np.sin((xx + 2 * yy) / 79)], -1)
    jobs = [(split, i, int(s)) for split, n in (("train", CITY_TRAIN),
                                                ("val", CITY_VAL))
            for i, s in zip(range(n), rng.integers(0, 1 << 30, n))]

    def write(job):
        split, i, seed = job
        g = np.random.default_rng(seed)
        city = f"city{i % 3}"
        oy, ox = g.integers(0, 256, 2)
        img = base[oy:oy + h, ox:ox + w] + g.normal(0, CITY_NOISE,
                                                    (h, w, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        ids = g.integers(0, 34, (h // 64, w // 64)).astype(np.uint8)
        label = np.repeat(np.repeat(ids, 64, 0), 64, 1)
        sizes = []
        for sub, suffix, arr in (("leftImg8bit", "leftImg8bit", img),
                                 ("gtFine", "gtFine_labelIds", label)):
            d = os.path.join(root, sub, split, city)
            os.makedirs(d, exist_ok=True)
            data = png_file(arr, g.integers(1, 5, h))
            with open(os.path.join(d, f"{city}_{i:06d}_{suffix}.png"),
                      "wb") as f:
                f.write(data)
            sizes.append(len(data))
        return sizes

    with ThreadPoolExecutor(8) as pool:
        sizes = np.array(list(pool.map(write, jobs)))
    return root, float(sizes[:, 0].mean()), float(sizes[:, 1].mean())


def paired_frames(root: str, rng) -> int:
    """Grayscale 260x346 frames beside the masks of the DDD17 tree's valid
    folder (``imgs/img_<id>.png``), as the UDA config pairs them."""
    h, w = bench.DDD17_SENSOR
    d = os.path.join(root, "dir1")
    masks = sorted(os.listdir(os.path.join(d, "segmentation_masks")))
    os.makedirs(os.path.join(d, "imgs"), exist_ok=True)
    for name in masks:
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        with open(os.path.join(d, "imgs", "img_" + name.split("_")[-1]),
                  "wb") as f:
            f.write(png_file(img, rng.integers(0, 5, h)))
    return len(masks)


def decode_breakdown(paths) -> dict:
    """Median ms a frame on this thread: the whole read of the image sets
    (``png.imread_gray`` + ``imgproc.resize_linear`` to 256x512) and its
    parts (file read, ``zlib`` inflate, the C++ unfilter with its gray mix,
    the C++ resize)."""
    from ess_tpu_torch.data import imgproc

    parts: dict = {k: [] for k in ("whole", "read", "inflate",
                                   "unfilter_gray", "resize")}
    for path in paths:
        t0 = time.perf_counter()
        imgproc.resize_linear(png.imread_gray(path), 256, 512)
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            data = f.read()
        t2 = time.perf_counter()
        rows, channels = png._rows(data)
        t3 = time.perf_counter()
        gray = png.unfilter_gray(rows)
        t4 = time.perf_counter()
        imgproc.resize_linear(gray, 256, 512)
        t5 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                 t5 - t4)):
            parts[k].append(1e3 * dt)
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_uda_cli(dev, kern_rows, tmp: str, root: str):
    """Phase 5e: ``python -m ess_tpu_torch.cli.train`` in-process on
    ``configs/settings_DDD17.yaml`` (ESS UDA, sensor A Cityscapes_gray from
    disk) on the trees above, with the image loader's rates, the decode
    time of a frame and one profiled step (module docstring)."""
    from ess_tpu_torch.cli import train as cli_train
    from ess_tpu_torch.core.config import load_config
    from ess_tpu_torch.data.cityscapes import CityscapesGray
    from ess_tpu_torch.io import timers
    from ess_tpu_torch.train import loop

    t_phase = time.perf_counter()
    b, win = DDD17_B, DDD17_B * WINDOWS
    per_call = (1, 3 * WINDOWS)     # B1, B2: lstm_impl_train unset -> B2
    rng = np.random.default_rng(15)
    t0 = time.perf_counter()
    city, frame_bytes, mask_bytes = cityscapes_tree(tmp, rng)
    n_frames = paired_frames(root, rng)
    log(f"Cityscapes tree of {CITY_TRAIN} + {CITY_VAL} frames "
        f"{CITY_HW[1]}x{CITY_HW[0]} RGB (mean PNG {frame_bytes / 2**20:.2f} "
        f"MiB a frame, {mask_bytes / 2**10:.1f} KiB a mask) and "
        f"{n_frames} paired DDD17 frames written in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase 5e config, from {CLI_CONFIGS[1]}:")
    yaml_uda = cli_yaml(tmp, CLI_CONFIGS[1], "uda.yaml", {
        "dataset.DDD17_events.dataset_path": root,
        "dataset.cityscapes_img.dataset_path": city,
        "dir.log": os.path.join(tmp, "uda_runs"),
        "optim.num_epochs": CLI_EPOCHS})
    cfg = load_config(yaml_uda)
    ds, ds_a = cfg.dataset.sensor_b, cfg.dataset.sensor_a
    if (cfg.model.model_name, ds_a.name, ds_a.shape, ds_a.random_crop,
            cfg.optim.batch_size_a, cfg.optim.batch_size_b,
            ds.nr_events_data, ds.nr_events_window, ds.require_paired_data_val,
            cfg.model.e2vid_base_channels, cfg.model.compute_dtype,
            cfg.model.data_augmentation_train, cfg.model.lstm_impl_train) != (
            "ess", "Cityscapes_gray", (200, 352), True, b, b, WINDOWS,
            bench.DDD17_EVENTS, True, 32, "bfloat16", True, None):
        raise AssertionError(f"{CLI_CONFIGS[1]} is not the width phase 5e "
                             "expects")

    # --- 1. python -m ess_tpu_torch.cli.train, two epochs of UDA ---
    calls, epoch_s = [], []
    timers.reset_timers()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with tapped_steps(calls), timed_epochs(epoch_s):
        out = captured(cli_train.main, ["--settings_file", yaml_uda])
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = list(timers._ACCUM["train_step"])
    timers.reset_timers()
    n_train, n_val = CLI_EPOCHS * CLI_STEPS, CLI_EPOCHS + 1
    log(f"cli.train (UDA): {n_train} train steps, {n_val} validations of "
        f"one image and one event batch; launches {show_counts(counts)}")
    need_calls(calls, "train", n_train, per_call)
    need_calls(calls, "eval", n_val, per_call)
    need_calls(calls, "eval_a", n_val, ())
    need_counts(counts, [(n_train + n_val) * k for k in per_call])
    add_launches(kern_rows, "cli_uda_train", counts)
    summary = printed_summary(out)
    losses = [c[2] for c in calls if c[0] == "train"]
    runs = sorted(os.listdir(os.path.join(tmp, "uda_runs")))
    run_dir = os.path.join(tmp, "uda_runs", runs[0])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    logged_a = [r["train/semseg_sensor_a_loss"] for r in logged
                if "train/semseg_sensor_a_loss" in r]
    keys = ("semseg_sensor_a_mean_iou", "semseg_sensor_b_mean_iou",
            "semseg_sensor_cycle_mean_iou")
    log(f"  losses {[round(v, 5) for v in losses]}; train/semseg_sensor_a_"
        f"loss lines {logged_a}; summary {summary}")
    if not (len(runs) == 1 and len(logged_a) == CLI_EPOCHS
            and all(np.isfinite(losses + logged_a))
            and all(0.0 <= summary.get(k, -1.0) <= 100.0 for k in keys)
            and sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
            == ["0", "1"]):
        raise AssertionError("cli.train (UDA): bad run")
    ms = 1e3 * statistics.median(step_s)
    log(f"  ms per train step in the Trainer (step + loss read): "
        f"{[round(1e3 * t, 1) for t in step_s]}, median {ms:.1f} ms, "
        f"{win / (ms / 1e3):.2f} windows/s")
    for e, t in enumerate(epoch_s):
        log(f"  epoch {e} through the loaders: {1e3 * t / CLI_STEPS:.1f} ms "
            f"per step, {CLI_STEPS * win / t:.2f} windows/s, "
            f"{CLI_STEPS * b / t:.2f} images/s")
    log(f"  peak device memory of the UDA train CLI: {peak / 2 ** 30:.2f} "
        f"GiB; {bench.card()}")

    # the first step on the plain versions, from the same seed and batches
    train_a, train_b, val_a, val_b = cli_train.build_loaders(cfg)
    with plain_versions():
        tr = loop.Trainer(cfg, train_b=train_b, train_a=train_a,
                          log_dir=os.path.join(tmp, "uda_plain"))
        batches = tr._train_batches()
        loss_p = float(tr.train_step(tr.state, next(batches))["loss"])
        batches.close()
    rel = abs(losses[0] - loss_p) / abs(loss_p)
    log(f"  step 1, kernel path vs plain path: loss {losses[0]:.6f} vs "
        f"{loss_p:.6f} (relative difference {rel:.3e}, bound "
        f"{TRAIN_LOSS_REL})")
    if not rel <= TRAIN_LOSS_REL:
        raise AssertionError("cli.train (UDA): kernel path disagrees with "
                             "the plain path")
    del tr, batches
    torch.cuda.empty_cache()

    # --- 2. one more epoch in a Trainer, its second step profiled ---
    train_a, train_b, val_a, val_b = cli_train.build_loaders(cfg)
    tr = loop.Trainer(cfg, train_b=train_b, train_a=train_a,
                      log_dir=os.path.join(tmp, "uda_profiled"),
                      profile_steps=(1, 2))
    reset_counts()
    tr.train_epoch()
    counts = read_counts()
    timers.reset_timers()
    need_counts(counts, [CLI_STEPS * k for k in per_call])
    add_launches(kern_rows, "cli_uda_profiled_epoch", counts)
    prof = bench.trace_summary(os.path.join(tr.log_dir, "profile",
                                            "trace.json"), top=6)
    log(f"  profiled UDA step 2: device busy {prof['busy_ms']:.1f} ms of a "
        f"{prof['span_ms']:.1f} ms span, idle share "
        f"{100 * prof['idle_share']:.1f} %; top "
        + ", ".join(f"{k['name'][:40]} {k['ms']:.2f} ms ({k['calls']})"
                    for k in prof["top"]))
    del tr
    torch.cuda.empty_cache()

    # --- 3. the image set alone: decode, and the loader's rates ---
    frames = sorted(train_a.dataset.images)
    parts = decode_breakdown(frames)
    log(f"  decode a {CITY_HW[1]}x{CITY_HW[0]} RGB frame, one thread "
        f"(median of {len(frames)}): {parts['whole']:.2f} ms read + gray + "
        f"resize to 256x512 (target <= 40 ms); parts: file read "
        f"{parts['read']:.2f}, inflate (zlib) {parts['inflate']:.2f}, "
        f"unfilter + gray mix (C++) {parts['unfilter_gray']:.2f}, resize "
        f"(C++) {parts['resize']:.2f} ms")
    for mode, h, w in CITY_GEOMETRIES:
        images = CityscapesGray(city, height=h, width=w,
                                semseg_num_classes=cfg.task.semseg_num_classes,
                                augmentation=True,
                                random_crop=mode == "random_crop",
                                seed=cfg.seed)
        for workers in (1, 8):
            batches = iter(loader.BatchLoader(images, b, shuffle=False,
                                              num_workers=workers))
            t0 = time.perf_counter()
            batch = next(batches)
            dt = time.perf_counter() - t0
            batches.close()
            if batch["image"].shape != (b, h, w, 1):
                raise AssertionError(f"image batch {batch['image'].shape}")
            log(f"  the image loader alone, {mode} {h}x{w}, {workers} "
                f"thread(s): {1e3 * dt:.1f} ms a batch of {b}, "
                f"{b / dt:.2f} samples/s")
    # (PIL may be loaded: torch.utils.tensorboard, which the run's metrics
    # writer mirrors to where it is installed, imports it; the image sets
    # never do, tests/test_torch_image_sets.py checks)
    if "cv2" in sys.modules or "h5py" in sys.modules:
        raise AssertionError("phase 5e imported cv2 or h5py")
    log(f"phase 5e took {time.perf_counter() - t_phase:.1f} s")


# The reconstruction program (phase 5f): python -m ess_tpu_torch.cli.reconstruct
# in-process on the DAVIS346 sensor (260x346, padded to 264x352) with a
# seeded E2VID-lightweight checkpoint (base 32, 3 encoders, 2 residual
# blocks, sum skips: the upstream checkpoint's geometry) in the upstream
# .pth.tar layout, on written t x y p streams at ~1M events/s: -N 10000 over
# 60 windows (a 0.6 s text file), -T 50 over 20 (a 1 s file) and --color
# -N 20000 over 30 (the zip copy of the 0.6 s file). Each run once on the
# kernel path (B3, 1 launch a window) and once with B3's plain version; the
# frames held against each other: gray within 1 grey level, color within 2
# (the CPU test's levels, tests/test_torch_reconstruct_cli.py), on at most
# 0.1 % of a frame's values. B3's raw grid on every window of the -N and -T
# runs is held against its plain version on the CPU within RECON_GRID_TOL
# (absolute and relative), as tests/test_torch_kernels_cuda.py does.
RECON_HW = (260, 346)
RECON_RATE = 1_000_000        # events/s of the written streams
RECON_RUNS = (("gray_N", "short.txt", ["-N", "10000"], 60),
              ("gray_T", "long.txt", ["-T", "50"], 20),
              ("color_N", "short.zip", ["-N", "20000", "--color"], 30))
RECON_FRAME_BOUND = {"gray_N": (1, 0.001), "gray_T": (1, 0.001),
                     "color_N": (2, 0.001)}
RECON_GRID_TOL = 1e-5


def recon_stream(path: str, seconds: float, rng) -> int:
    """A t x y p text file with a ``width height`` header: RECON_RATE
    events/s over ``seconds``, integer pixels, t in seconds from 1.0."""
    h, w = RECON_HW
    n = int(seconds * RECON_RATE)
    t = 1.0 + np.sort(rng.uniform(0, seconds, n))
    cols = (t.tolist(), rng.integers(0, w, n).tolist(),
            rng.integers(0, h, n).tolist(), rng.integers(0, 2, n).tolist())
    with open(path, "w") as f:
        f.write(f"{w} {h}\n")
        f.write("\n".join(map("{:.9f} {} {} {}".format, *cols)))
        f.write("\n")
    return n


def recon_checkpoint(path: str) -> None:
    """A seeded E2VID-lightweight ``.pth.tar`` in the upstream layout: the
    program's own seeded initialization, doubled (as the CPU test's), so
    that frames span many grey levels."""
    from ess_tpu_torch.cli import reconstruct
    from ess_tpu_torch.models.e2vid import RecurrentUNet

    model = RecurrentUNet(device="cpu")
    reconstruct.seeded_init(model, seed=16)
    torch.save({"state_dict": {f"unetrecurrent.{k}": 2 * v
                               for k, v in model.state_dict().items()},
                "model": {"num_bins": 5, "num_encoders": 3,
                          "base_num_channels": 32, "num_residual_blocks": 2,
                          "skip_type": "sum"}}, path)


def recon_frames(folder: str) -> dict:
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = png.decode(f.read())
    return out


def phase_reconstruct(dev, kern_rows, tmp: str):
    """Phase 5f: the reconstruction program (module docstring)."""
    import zipfile

    from ess_tpu_torch.cli import reconstruct
    from torch.profiler import ProfilerActivity, profile

    from ess_tpu_torch.data.readers import (
        FixedDurationEventReader, FixedSizeEventReader)
    from ess_tpu_torch.ops.pad import crop_output
    from ess_tpu_torch.recon.reconstructor import Reconstructor

    t_phase = time.perf_counter()
    h, w = RECON_HW
    folder = os.path.join(tmp, "recon")
    os.makedirs(folder)
    rng = np.random.default_rng(16)
    t0 = time.perf_counter()
    n_short = recon_stream(os.path.join(folder, "short.txt"), 0.6, rng)
    n_long = recon_stream(os.path.join(folder, "long.txt"), 1.0, rng)
    with zipfile.ZipFile(os.path.join(folder, "short.zip"), "w",
                         zipfile.ZIP_DEFLATED) as zf:
        zf.write(os.path.join(folder, "short.txt"), "events.txt")
    ckpt = os.path.join(folder, "e2vid_lightweight.pth.tar")
    recon_checkpoint(ckpt)
    log(f"phase 5f: {w}x{h} streams of {n_short} and {n_long} events at "
        f"{RECON_RATE} events/s (+ a zip copy) and a seeded E2VID-lightweight "
        f"checkpoint written in {time.perf_counter() - t0:.1f} s")

    for name, src, flags, n_win in RECON_RUNS:
        argv = ["-c", ckpt, "-i", os.path.join(folder, src)] + flags
        out = {}
        for path in ("kernel", "plain"):
            out[path] = os.path.join(folder, f"{name}_{path}")
            with plain_versions() if path == "plain" else \
                    contextlib.nullcontext():
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                text = quiet(reconstruct.main, argv + ["-o", out[path]])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counts()
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("window ")]
            log(f"  | {text.splitlines()[0]} | {lines[0]} ... {lines[-1]}")
            if (text.splitlines()[0] != f"sensor size: {w} x {h}"
                    or len(lines) != n_win):
                raise AssertionError(f"{name}: {len(lines)} window lines; "
                                     f"want {n_win}")
            if path == "kernel":
                need_counts(counts, [0, 0, 0, n_win])
                add_launches(kern_rows, f"reconstruct_{name}", counts)
                log(f"  {name} ({' '.join(flags)}): {n_win} windows in "
                    f"{wall:.2f} s, {n_win / wall:.2f} windows/s, launches "
                    f"{show_counts(counts)}, peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            else:
                need_counts(counts, [0, 0, 0, 0])
                log(f"  {name} on B3's plain version: {n_win / wall:.2f} "
                    f"windows/s")
        got, want = recon_frames(out["kernel"]), recon_frames(out["plain"])
        shape = (h, w, 3) if "--color" in flags else (h, w)
        names = [f"frame_{i:010d}.png" for i in range(n_win)]
        if list(got) != names or list(want) != names:
            raise AssertionError(f"{name}: frame files {list(got)[:3]}...")
        levels, share = RECON_FRAME_BOUND[name]
        worst, off_share, spread = 0, 0.0, []
        for k in names:
            if got[k].shape != shape or want[k].shape != shape:
                raise AssertionError(f"{name}: frame {got[k].shape}")
            off = np.abs(got[k].astype(np.int16) - want[k])
            worst = max(worst, int(off.max()))
            off_share = max(off_share, float((off > 0).mean()))
            spread.append(float(got[k].std()))
        log(f"  {name} frames, kernel vs plain path: max {worst} levels, "
            f"at most {100 * off_share:.3f} % of a frame's values differ "
            f"(bound {levels}, {100 * share:.1f} %); frame std "
            f"{min(spread):.1f}-{max(spread):.1f} levels")
        if worst > levels or off_share > share or min(spread) < 2:
            raise AssertionError(f"{name}: frames disagree or are flat")

    # B3's grids against its plain version on the CPU, on every window of
    # the -N and -T runs (launched outside the counted runs above)
    short = os.path.join(folder, "short.txt")

    def window_grid(win, device):
        return batch_voxel.voxelize_window_soa(
            *reconstruct.window_tensors(win, device), num_bins=5, height=h,
            width=w, normalize=False)

    for name, reader in (
            ("gray_N", FixedSizeEventReader(short, 10000)),
            ("gray_T", FixedDurationEventReader(
                os.path.join(folder, "long.txt"), 50))):
        worst, n_win = 0.0, 0
        for win in reader:
            got, want = window_grid(win, dev).cpu(), window_grid(win, "cpu")
            off = (got - want).abs()
            worst = max(worst, float(off.max()))
            if not bool((off <= RECON_GRID_TOL * (1 + want.abs())).all()):
                raise AssertionError(f"{name} window {n_win}: B3's grid "
                                     f"off by {float(off.max())}")
            n_win += 1
        log(f"  {name}: B3's grid on all {n_win} windows against its plain "
            f"version on the CPU: max abs err {worst:.3g} (bound "
            f"{RECON_GRID_TOL:g} abs + rel)")

    # the entry point as a user runs it, in a process of its own
    cli_out = os.path.join(folder, "gray_N_module")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ess_tpu_torch.cli.reconstruct", "-c", ckpt,
         "-i", short, "-o", cli_out, "-N", "10000"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"python -m ess_tpu_torch.cli.reconstruct: exit "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    got = recon_frames(cli_out)
    want = recon_frames(os.path.join(folder, "gray_N_kernel"))
    if list(got) != list(want) or any(
            got[k].shape != (h, w)
            or np.abs(got[k].astype(np.int16) - want[k]).max() > 1
            for k in got):
        raise AssertionError("python -m ess_tpu_torch.cli.reconstruct: "
                             "frames differ from the in-process run's")
    log(f"  python -m ess_tpu_torch.cli.reconstruct -c <ckpt> -i short.txt "
        f"-N 10000: exit 0, {len(got)} frames of {w}x{h} (within 1 level "
        f"of the in-process run's) in {time.perf_counter() - t0:.1f} s, "
        f"process start included")

    # the per-window split of -N 10000, each part alone on the same windows
    t0 = time.perf_counter()
    windows = list(FixedSizeEventReader(short, 10000))
    parse_ms = 1e3 * (time.perf_counter() - t0) / len(windows)
    h2d = []
    for win in windows:
        t0 = time.perf_counter()
        cols = reconstruct.window_tensors(win, dev)
        torch.cuda.synchronize()
        h2d.append(1e3 * (time.perf_counter() - t0))
    model = reconstruct.build_model(ckpt, dev)
    recon = Reconstructor(model=model, height=h, width=w)

    def voxelize():
        return batch_voxel.voxelize_window_soa(*cols, num_bins=5, height=h,
                                               width=w, normalize=False)

    grid, state = normalize_nonzero(voxelize()), recon.init_state(1, dev)
    with torch.no_grad():
        vox_ms = cuda_ms(voxelize, 50)
        roll_ms = cuda_ms(lambda: recon.step(normalize_nonzero(grid), state),
                          20)
        img = recon.step(grid, state)[0]
    frame = reconstruct.to_frame8(img[0, 0]).cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(10):
        png.imwrite(os.path.join(folder, "one.png"), frame)
    png_ms = 1e2 * (time.perf_counter() - t0)
    log(f"  a -N 10000 window, each part alone: text parse "
        f"{parse_ms:.2f} ms (host), host-to-device copy "
        f"{statistics.median(h2d):.3f} ms (host clock, synchronized), "
        f"voxelizer {vox_ms:.3f} ms (device: tile binning + B3 + time "
        f"normalization), normalize + rollout step {roll_ms:.3f} ms "
        f"(device), PNG write {png_ms:.2f} ms (host)")
    # the idle share of one -N 10000 run of the program over 10 windows: the
    # third call, after two warm-up calls, so cuDNN's plans are chosen; the
    # model build and the checkpoint load are in it
    with open(short) as f:
        head = [next(f) for _ in range(1 + 100_000)]
    ten = os.path.join(folder, "ten.txt")
    with open(ten, "w") as f:
        f.writelines(head)
    with tempfile.TemporaryDirectory() as trace_dir:
        prof = bench.profile_call(
            lambda: quiet(reconstruct.main, [
                "-c", ckpt, "-i", ten, "-o", os.path.join(folder, "ten"),
                "-N", "10000"]), trace_dir, "reconstruct", top=6)
    log(f"  profiled -N 10000 run of the program over 10 windows (model "
        f"build and checkpoint load included): wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms "
        f"over a {prof['span_ms']:.1f} ms span, device idle share "
        f"{100.0 * prof['idle_share']:.1f} %; top "
        + ", ".join(f"{k['name'][:40]} {k['ms']:.2f} ms ({k['calls']})"
                    for k in prof["top"]))
    # the idle share in steady state: windows 10-19 of the -N 10000 stream
    # through the program's per-window body (parse, copy, voxelize,
    # normalize, step, crop, frame, PNG), the model built and windows 0-9
    # run first
    stream = iter(FixedSizeEventReader(short, 10000))
    state = recon.init_state(1, dev)

    def cli_window():
        nonlocal state
        grid = normalize_nonzero(window_grid(next(stream), dev))
        img, state, _ = recon.step(grid, state)
        frame = reconstruct.to_frame8(crop_output(img, recon.geometry)[0, 0])
        png.imwrite(os.path.join(folder, "one.png"), frame.cpu().numpy())

    with torch.no_grad():
        for _ in range(10):
            cli_window()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as trace:
            t0 = time.perf_counter()
            for _ in range(10):
                cli_window()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as trace_dir:
        path = os.path.join(trace_dir, "reconstruct_steady_trace.json")
        trace.export_chrome_trace(path)
        steady = bench.trace_summary(path, top=4)
    log(f"  profiled windows 10-19 of -N 10000 in steady state (the "
        f"program's per-window body, model built): wall {wall:.1f} ms, "
        f"device busy {steady['busy_ms']:.1f} ms over a "
        f"{steady['span_ms']:.1f} ms span, device idle share "
        f"{100.0 * steady['idle_share']:.1f} %")
    if "cv2" in sys.modules:
        raise AssertionError("phase 5f imported cv2")
    del model, recon, grid, state
    torch.cuda.empty_cache()
    log(f"phase 5f took {time.perf_counter() - t_phase:.1f} s")


def slice_agreement(what, latent, latent_ref, pred, pred_ref, logits_ref,
                    cm=None, cm_ref=None) -> None:
    """Hold one path against a reference path under the slice bounds
    (SLICE_*): the latent, the argmax on all pixels and on the pixels whose
    top-2 logit gap in the reference exceeds SLICE_GAP, and, where given,
    the share of confusion-matrix counts that moved."""
    latent, latent_ref = latent.float(), latent_ref.float()
    rel = ((latent - latent_ref).abs().max() / latent_ref.abs().max()).item()
    top2 = logits_ref.float().topk(2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > SLICE_GAP
    same = pred == pred_ref
    agree = 100.0 * same.float().mean().item()
    agree_clear = 100.0 * same[clear].float().mean().item()
    msg = (f"  {what}: latent rel max|d| {rel:.3e} (bound {SLICE_LATENT_REL}); "
           f"pred agreement {agree:.3f}% (bound >= {SLICE_PRED_AGREE}%), "
           f"{agree_clear:.3f}% where the top-2 gap exceeds {SLICE_GAP} "
           f"(bound >= {SLICE_PRED_AGREE_CLEAR}%)")
    ok = (rel <= SLICE_LATENT_REL and agree >= SLICE_PRED_AGREE
          and agree_clear >= SLICE_PRED_AGREE_CLEAR)
    if cm is not None:
        moved = 100.0 * float((cm - cm_ref).abs().sum()) / (
            2 * float(cm_ref.sum()))
        msg += (f"; confusion matrix {moved:.3f}% of the pixels moved (bound "
                f"<= {100.0 - SLICE_PRED_AGREE}%)")
        ok = ok and moved <= 100.0 - SLICE_PRED_AGREE
    log(msg)
    if not ok:
        raise AssertionError(f"{what}: the paths disagree")


FORM_ORDER = ("standard", "block_xla", "block_pallas", "block_pallas",
              "block_xla", "standard")
FORM_TEXT = {"standard": "standard 5x5 form",
             "block_xla": "block space, library conv",
             "block_pallas": "block space, fused conv kernel"}


def timed_forms(what: str, run, windows_per_call: int, reps: int = 2) -> None:
    """Time ``run(form)`` (one synchronized call, seconds) for the three
    rollout forms in turns and print the medians side by side."""
    samples = {form: [] for form in bench.FORMS}
    for form in FORM_ORDER:
        samples[form] += [run(form) for _ in range(reps)]
    for form in bench.FORMS:
        ts = samples[form]
        med = statistics.median(ts)
        log(f"{what} ({FORM_TEXT[form]}): {windows_per_call / med:.2f} "
            f"windows/s, median {1e3 * med:.1f} ms over {len(ts)} calls "
            f"{[round(1e3 * t, 1) for t in ts]}")


def phase_block(dev, kern_rows):
    """The eval step, the train step and streaming with the head and
    first-encoder convs on the fused conv kernel: launch counts, agreement
    with the plain versions and with the standard 5x5 form, and the three
    forms' rates side by side."""
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    # --- eval step, B=8 ---
    batch8 = make_batch(4, 8, dev, ignore_rows=20)
    evals, outs = {}, {}
    for form in bench.FORMS:
        mods, step = bench.build_eval(8, dev, form=form)
        mods.head.register_forward_hook(keep_logits)
        evals[form] = step
        reset_counts()
        out = step(batch8)
        counts = read_counts()
        kern = form == "block_pallas"
        log(f"block-conv slice, eval step B=8 T={WINDOWS} "
            f"({FORM_TEXT[form]}): launches {show_counts(counts)}")
        need_counts(counts, (1, 3 * WINDOWS, 0, 0, 2 * WINDOWS * kern, 0))
        if kern:
            add_launches(kern_rows, "eval_block_conv", counts)
        if not (torch.isfinite(out["latent8"]).all()
                and np.isfinite(float(out["loss"]))):
            raise AssertionError(f"eval step ({form}) output is not finite")
        outs[form] = (out, logits[0])
    with plain_versions():
        ref = evals["block_pallas"](batch8)
    if read_counts() != counts:
        raise AssertionError("the plain path launched a kernel")
    out_k = outs["block_pallas"][0]
    slice_agreement("eval, fused conv kernel path vs plain path",
                    out_k["latent8"], ref["latent8"], out_k["pred"],
                    ref["pred"], logits[0])
    out_s, logits_s = outs["standard"]
    for form in ("block_xla", "block_pallas"):
        slice_agreement(f"eval, {FORM_TEXT[form]} vs standard 5x5 form",
                        outs[form][0]["latent8"], out_s["latent8"],
                        outs[form][0]["pred"], out_s["pred"], logits_s)
    log(f"  losses: standard {float(out_s['loss']):.6f}, block library "
        f"{float(outs['block_xla'][0]['loss']):.6f}, block kernel "
        f"{float(out_k['loss']):.6f}, plain {float(ref['loss']):.6f}")
    del outs, out, ref, out_k, out_s, logits_s

    def eval_call(form):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(evals[form](batch8)["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_forms(f"eval step B=8 T={WINDOWS}", eval_call, 8 * WINDOWS)
    del evals
    torch.cuda.empty_cache()

    # --- train step, B=8, int8 cell (and int8 block convs on the kernel) ---
    trains, first = {}, {}
    for form in bench.FORMS:
        mods, state, step = bench.build_train(bench.make_cfg(8), dev,
                                              form=form)
        trains[form] = (state, step)
        reset_counts()
        first[form] = float(step(state, batch8)["loss"])
        counts = read_counts()
        kern = form == "block_pallas"
        log(f"block-conv slice, train step B=8 T={WINDOWS} "
            f"({FORM_TEXT[form]}): launches {show_counts(counts)}, loss "
            f"{first[form]:.6f}")
        need_counts(counts, (1, 0, 3 * WINDOWS, 0, 0, 2 * WINDOWS * kern))
        prep = conv3x3.launches_int8_prep
        log(f"  int8 conv prep kernel launches: {prep} for {counts[5]} "
            f"convs (2 a conv: 3 launches a conv in all, bound 3)")
        if prep != 2 * counts[5]:
            raise AssertionError(f"{prep} int8 conv prep launches for "
                                 f"{counts[5]} convs")
        if kern:
            add_launches(kern_rows, "train_block_conv", counts)
    mods_p, state_p, step_p = bench.build_train(bench.make_cfg(8), dev,
                                                form="block_pallas")
    with plain_versions():
        loss_p = float(step_p(state_p, batch8)["loss"])
    pipe = bench.make_pipeline()
    with torch.no_grad():
        windows, _ = pipe.build_all(batch8, aug=AugmentParams(),
                                    out_dtype=mods_p.e2vid.dtype)
        lat_k = mods_p.recon_train.rollout(windows, decode=False)[2][8].float()
        with plain_versions():
            lat_p = mods_p.recon_train.rollout(windows,
                                               decode=False)[2][8].float()
    rel = ((lat_k - lat_p).abs().max() / lat_p.abs().max()).item()
    loss_rel = abs(first["block_pallas"] - loss_p) / abs(loss_p)
    log(f"  train step 1, int8 kernels (cell and block convs) vs plain path: "
        f"loss {first['block_pallas']:.6f} vs {loss_p:.6f} (relative "
        f"difference {loss_rel:.3e}, bound {TRAIN_LOSS_REL}); latent8 rel "
        f"max|d| {rel:.3e} (bound {TRAIN_LATENT_REL}); standard form's loss "
        f"{first['standard']:.6f}, block library form's "
        f"{first['block_xla']:.6f}")
    if not (loss_rel <= TRAIN_LOSS_REL and rel <= TRAIN_LATENT_REL
            and all(np.isfinite(v) for v in first.values())):
        raise AssertionError("train block-conv kernel path disagrees with "
                             "the plain path")
    del mods_p, state_p, step_p, windows, lat_k, lat_p

    def train_call(form):
        state, step = trains[form]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(state, batch8)["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_forms(f"train step B=8 T={WINDOWS}, int8 cell", train_call,
                8 * WINDOWS)
    del trains, batch8
    torch.cuda.empty_cache()

    # --- streaming, B=8 and B=1, tile wire ---
    label_px = (SENSOR_H - CROP) * SENSOR_W
    scored = STREAM_WINDOWS // bench.WINDOWS_PER_SCORE
    for b in (8, 1):
        windows = bench.make_stream(
            7, b, dev, "tile", windows=STREAM_WINDOWS,
            resets=((0, 1.0), (STREAM_WINDOWS // 2, 0.5)))
        streams, finals = {}, {}
        for form in bench.FORMS:
            mods, steps = bench.build_stream(b, dev, form=form)
            mods.head.register_forward_hook(keep_logits)
            streams[form] = (mods, steps)
            reset_counts()
            state, cm = bench.run_stream(
                steps, mods.recon_val.init_state(b, dev), windows)
            counts = read_counts()
            kern = form == "block_pallas"
            log(f"block-conv slice, streaming B={b}, tile wire, "
                f"{STREAM_WINDOWS} windows ({FORM_TEXT[form]}): launches "
                f"{show_counts(counts)}")
            need_counts(counts, (0, 3 * STREAM_WINDOWS, 0, STREAM_WINDOWS,
                                 2 * STREAM_WINDOWS * kern, 0))
            if kern:
                add_launches(kern_rows, "stream_block_conv", counts)
            latent = state[-1][0].float()
            if (float(cm.sum()) != scored * b * label_px
                    or tuple(latent.shape) != (b, 256, (SENSOR_H - CROP) // 8,
                                               SENSOR_W // 8)
                    or not torch.isfinite(latent).all()):
                raise AssertionError(f"bad stream output ({form}): cm.sum "
                                     f"{float(cm.sum())}, latent "
                                     f"{tuple(latent.shape)}")
            finals[form] = (latent, logits[0].argmax(dim=1), cm, logits[0])
        mods, steps = streams["block_pallas"]
        with plain_versions():
            state_p, cm_p = bench.run_stream(
                steps, mods.recon_val.init_state(b, dev), windows)
        lat, pred, cm, _ = finals["block_pallas"]
        slice_agreement(f"streaming B={b}, fused conv kernel path vs plain "
                        "path", lat, state_p[-1][0], pred,
                        logits[0].argmax(dim=1), logits[0], cm, cm_p)
        lat_s, pred_s, cm_s, logits_s = finals["standard"]
        for form in ("block_xla", "block_pallas"):
            lat, pred, cm, _ = finals[form]
            slice_agreement(f"streaming B={b}, {FORM_TEXT[form]} vs standard "
                            "5x5 form", lat, lat_s, pred, pred_s, logits_s,
                            cm, cm_s)
        del finals, state, state_p
        timed = windows[:bench.WINDOWS_PER_SCORE]
        rounds = 5 if b == 1 else 3

        def stream_call(form):
            mods_, steps_ = streams[form]
            wps = bench.stream_windows_per_sec(mods_, steps_, timed, rounds)
            return b / wps                      # seconds per window

        timed_forms(f"streaming eval B={b}, tile wire, 19 encode + 1 score "
                    "per 20 windows", stream_call, b, reps=1)
        del streams, windows, timed
        torch.cuda.empty_cache()


def main() -> None:
    dev = phase_device()
    phase_build()
    rows = [check_voxelizer(dev), check_cells(dev, int8=False),
            check_cells(dev, int8=True), check_voxel_tiled(dev),
            check_conv3x3(dev), check_conv3x3_int8(dev), check_level(dev),
            check_cell_variants(dev), check_voxel_folded_legacy(dev),
            check_head_cmajor(dev)]
    phase_slice(dev, rows)
    phase_train(dev, rows)
    phase_uda(dev, rows)
    phase_ddd17(dev, rows)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = ddd17_tree(tmp, np.random.default_rng(14))
        log(f"DDD17 tree of {sum(CLI_MASKS.values())} masks in 7 folders "
            f"written in {time.perf_counter() - t0:.1f} s")
        phase_cli(dev, rows, tmp, root)
        phase_uda_cli(dev, rows, tmp, root)
        phase_reconstruct(dev, rows, tmp)
    phase_stream(dev, rows)
    phase_data(dev, rows)
    phase_block(dev, rows)
    phase_tools(dev, rows)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
