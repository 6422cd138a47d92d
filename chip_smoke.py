"""Drive the PyTorch + CUDA port's DSEC eval, train, UDA train and
streaming-eval paths, its DDD17 supervised and UDA steps, its train and
evaluate CLIs (ESS UDA from Cityscapes images on disk included), its
E2VID reconstruction program and the YAML's model and event options once
on one NVIDIA GPU, in the rollout form of
``build_modules`` and with the block convs on the fused conv kernel, then
its three kernel tools and its measurement tools (the step roofline, the
voxelizer and cell benches and profiles, the increments ladders), then
the host event path from an in-memory
recording to the eval and streaming steps, then the dense and in-loop
forms of the steps, DSEC rectification on the card and A10's drift, then
the voxelizer's opt-in pins (int8 tent planes, stack and raw windows),
then the model's forms (the quad-block rollout, the fused-final head, the
blocked ResNet stem and decoder conv, ``head_conv_impl``), then the rest
of the JAX package's library surface (the reconstruction options and
``rollout_all``, post-processing and display, the UNet family, the voxel
ops, the fused level's size rule).

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
   on the same normalized window; the voxelizer pins' forms, each its own
   row and launch count: B1-stack, B1-raw, B1-int8, B3-legacy-int8 and
   B3-legacy-raw over 160 windows of 100k events, B3-int8 at the
   streaming B=8 (its row's times) and B=1 -- the int8 forms against their
   plain int8 versions bit for bit (both add the same integer products),
   the stack and raw forms against the default kernel's grid relaid out
   bit for bit (stats alike) and normalized against their plain versions;
3b. repeat: two runs on one input, bit for bit (any element that differs
   fails): B1 and B3-legacy over 160 windows of 100k events and B3 over 8,
   and the six pin forms on the same inputs, launched twice and against a
   second process that builds the same input from the same seed; B2, B2-int8, B4 and B4-int8 at the main path's B=8
   shapes launched twice; the int8 train rollout twice on one window
   stack; the DSEC int8 train step twice from one seeded state on one
   batch (loss, latent8, the head's update);
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
   window, 260x346 gray or 260x346x3; with ``--color`` also the phase and
   gray frames the merge reads) held kernel against plain; B3's grid
   on every ``-N`` and ``-T`` window against its plain version on the CPU;
   ``python -m ess_tpu_torch.cli.reconstruct -N 10000`` once in its own
   process, its frames against the in-process run's; windows/s, peak
   memory, a window's text parse, host-to-device copy, voxelizer, rollout
   step and PNG write each alone, and the idle share of a profiled 10-window
   run of the program (set-up included) and of windows 10-19 through the
   program's per-window body with the model built (steady state);
5g. the YAML's model and event options, one key changed at a time: the
   train CLI in-process for one epoch on phase 5d's tree with
   ``configs/settings_DDD17_supervised.yaml`` and ``event_representation:
   'histogram'`` / ``'ev_segnet'`` (tile-sorted raw events, no B1),
   ``e2vid_recurrent_block: 'convgru'`` (no B2), ``e2vid_norm: 'IN'``
   (standard layout) and ``skip_connect_task: False`` (the plain head),
   and with ``configs/settings_DDD17.yaml`` (ESS UDA, phase 5e's Cityscapes
   tree) and the histogram -- launches a train step and a validation
   batch, finite losses and mIoUs, step 1 against the plain versions; the
   DSEC supervised eval and train steps at the bench shape (B=8) with the
   histogram and with the ConvGRU backbone -- launches, agreement with the
   plain versions (the slice bounds; train loss within 2 %), windows/s
   alternated with the plain path, peak memory, the idle share of a
   profiled step; streaming with the ConvGRU backbone at B=8 over 40
   windows on the tile wire against the plain path, its rate and idle
   share; and ``ess_tpu_torch.tools.sanity_train``: its ``main`` (the
   overfit of a label-correlated batch at the bench shape on the int8
   train cell) and the same overfit on the exact cell (the loss falls
   below 0.7x of the first step's on both) and on the histogram, with each
   loss trajectory and batch mIoU;
5h. data parallel (``ess_tpu_torch/parallel``): the train CLI on phase
   5d's tree and config with ``--num_devices 1`` (a world of one on NCCL)
   against ``--num_devices 0`` run twice: per-step losses and final head
   weights equal bit for bit, or within the two one-device runs' own
   difference where those differ (B1 sums in no fixed order), with B1 and
   B2 launches as in phase 5d, and the same summary; the same run under
   ``torchrun --standalone --nproc_per_node 1`` with ``--num_devices -1``,
   its logged losses and summary equal to the one-device run's; two ranks
   on this one card over gloo, started by ``parallel.launch.spawn`` with
   an explicit backend: each rank's B2-int8 and B4-int8 preps of its rows
   (the absmax kernel, the maximum over the ranks, the prep with the given
   absmax) against the one-device prep of the whole batch, bit for bit;
   the DSEC supervised train step at global B=8 and the UDA train step at
   the ``settings_DDD17.yaml`` shape (global B=16, augmentation on), each
   on the int8 kernels with one sample of rank 1's rows piling its events
   on one pixel, against the one-device step on the same global batch --
   every int8 prep call's s_x on each rank the one of the global batch bit
   for bit, losses, the parameters' updates, the ranks equal bit for bit,
   each rank's launches, ms a step, windows/s and peak memory a rank,
   beside the one device's; three planted faults (a rank-local absmax,
   rank-local loss sums, no gradient average), each of which must fail one
   of these checks; and
   ``--num_devices 2`` through the CLI on NCCL where two cards exist, else
   a line saying why it did not run and the CLI's raise for 2 on one card;
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
8b. measurement tools through their ``main``: ``roofline`` (the bound of
   the supervised and UDA train steps beside each step's measured time at
   B=8, the share of the bound it reaches, and each group's device time
   from a profile of one step), ``bench_kernel`` (B3, B1 and B3-legacy at
   160 windows with a three-launch repeat check, bit for bit) and
   ``profile_kernel``, ``bench_lstm`` (the library cell, B2 and B2-int8 at
   the three encoder shapes, B2's and B2-int8's two launches bit for bit)
   and ``profile_lstm``, ``bench_increments`` and ``bench_uda_increments``
   (the ladders of the config levers, with the voxelizer pins' rungs
   ``+raw-windows``, ``+stack-emit``, ``+voxel-int8`` and the UDA
   ladder's ``+blocked-stem`` and ``+raw-windows``) -- launch counts,
   finite readings;
9. host event path: an in-memory DSEC-shaped recording (20M events on
   480x640, a rectify map with sub-pixel offsets, labels every ~0.3 s)
   through ``DSECSequence.from_store`` (slicer, then the fused native
   rectify + binning on four wires: f32 band records on 5 x-slots and on
   full-width bands, and ``wire_format='packed'`` u16 columns of the folded
   records and of tile-sorted events) -> ``BatchLoader`` (pinned collate
   ring) -> ``prefetch_to_device`` -> the eval step at B=8, T=20 windows of
   100k events, each wire's outputs held against the default wire's, and
   through ``SequenceRecurrent`` -> ``run_streaming_eval`` at B=1 on every
   wire -- host ingest ms per window, bytes a batch on the host-to-device
   wire, launch counts, windows/s and the device idle share; on each packed
   wire also, on one batch decoded on the card, its voxelizer (B1 or B3)
   against its plain version, the eval step against the plain versions,
   and the supervised train step and the UDA train step (B=8, int8 cell)
   with their launch counts and first losses against the plain versions;
10. the dense and in-loop forms (B=8, T=20 windows of 100k events): the
   eval step and the supervised train step (int8 cell) with
   ``precompute=False`` (each window voxelized just before its step, T
   voxelizer launches a step) on the band wire (B1) and the tile wire
   (B3), against the precomputed form on the same batch and draws (the
   slice bounds; the train loss and the int8 rollout's latent within
   phase 5's), with both forms' windows/s and peak memory read
   alternately; raw sensor-coordinate windows of phase 9's recording
   rectified on the card (``make_pipeline(rectify_map=)``, B3 with the
   tile sort on the card) through the eval step against the host-rectified
   tile wire of the same events (``ingest_rectify_bin``), B3's rectified
   grids against its plain version and the host's, the rectify gather's
   share of the step's device time and both steps' rates;
   ``EventPipeline.__call__`` -> dense ``{"events"}`` batches through the
   eval, train and UDA train steps against the raw wire of the same
   events (no voxelizer in the step); and A10: ``rollout_events`` over 60
   carried windows on the exact (B2) and the int8 (B2-int8) cell, the
   drift of the int8 state from the exact one at windows 1, 20, 40 and 60
   and its maximum against A10_H_BOUND / A10_C_BOUND;
11. the voxelizer pins at the bench shape (B=8, T=20 windows of 100k
   events, band wire): the eval step (exact cell) and the train step (int8
   cell, flips) with ``stack_windows``, ``raw_windows``,
   ``voxel_oh_dtype='int8'`` and the s2d branch (``windows_s2d``) against
   the default on one batch and one set of draws -- the branch each takes,
   launch counts, the stack and raw forms bit for bit (loss, latent8,
   argmax, confusion matrix, image; train: loss, latent8, the head's
   update), the int8 planes under the slice bounds (eval) and the train
   loss bound, the s2d branch under the slice bounds, each form's
   windows/s and peak memory alternated; the eval step on the full-width
   band wire with raw windows (bit for bit) and the int8 planes (the same
   bounds) against that wire's default (B3-legacy-raw, B3-legacy-int8);
   the UDA train step at B=2 with raw windows against the default, losses
   bit for bit; the DDD17
   supervised train step (B=16, the width resize on the raw accumulator)
   with raw windows against its default (loss within TRAIN_LOSS_REL, the
   windows within VOXEL_ATOL); streaming at B=8 on the tile wire with the
   int8 planes (B3-int8), 40 windows, against the plain path under the
   streaming bounds and against the f32 planes (reported), both rates
   alternated; the phase's seconds;
12. the model's forms at the bench shape (B=8, T=20 windows of 100k
   events, band wire): the quad-block rollout (``build_modules(
   quad_block=True)``, s4d windows) through the eval step (exact cell), the
   train step (int8 cell, flips) and 20 streamed windows at B=8 on the tile
   wire, each on the library block convs and on B4 / B4-int8, against the
   default block-space rollout under the slice bounds (the train loss
   within TRAIN_LOSS_REL) with launch counts and the branch taken; the
   supervised train step with the fused-final head and the UDA train step
   at B=8 with the blocked stem and the fused-final head against the
   standard forms (losses within TRAIN_LOSS_REL); and the keep-rule
   timings, each form against its standard one in the same run, calls
   alternated: the blocked decoder conv on the eval step's decode, the
   blocked stem and the fused-final head in the UDA train step, the
   fused-final head in the supervised train step, ``head_conv_impl=
   'auto'`` on a standard-layout eval rollout; the phase's seconds.
   Phase 3 also holds B4 and B4-int8 at the quad-block rollout's three
   block convs and B2 / B2-int8 at its level-0 cell (x, h, c at 110x160
   with 256 channels, the gate weights remapped by ``gates_kernel_s2d``)
   against their plain versions, their times and bounds at B=8 in the
   rows' ``quad`` entries;
13. the rest of the library surface at E2VID-lightweight's full width
   (base 32, bf16, B2 and B4): windows of 100k events voxelized one at a
   time (B3) and ``Reconstructor(normalize=True, flip=True,
   standardize=True).rollout_all`` at 480x640, B=8, T=20 and at the
   DAVIS346's 260x346 (padded), B=1, each against the same path on the
   plain versions (frames within RECON13_FRAME_BOUND), with launch counts
   and windows/s; ``no_recurrent``: every ``rollout_all`` frame equal to
   one step from zero state, ``rollout``'s frame the last one, bit for
   bit; the post-processing chain on sample 0's 20 windows (100 hot pixels
   zeroed, its rollout, the auto-HDR rescaler and unsharp mask on the
   card, the bilateral filter and the display's composed frame on the
   host), ms a frame for each stage; ``UNet`` at B=8, ``UNetDecoder`` and
   ``UNetTaskDecoder`` on a rollout's final latent and a transposed-conv,
   tanh ``RecurrentUNet`` rollout, bf16 against f32, with times;
   ``voxel_grid_temporal`` and ``event_histogram`` of a 100k-event window
   against the host voxelizer and numpy; B5 declining an ``h_prev`` below
   JAX's size rule (no launch) and launching above it, against its plain
   version; the phase's seconds.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from ess_tpu_torch.data.pipeline import (  # noqa: E402
    AugmentParams, EventPipeline, to_soa)
from ess_tpu_torch.data.slicer import (  # noqa: E402
    ArrayEventStore, DDD17EventStore)
from ess_tpu_torch.models import layers  # noqa: E402
from ess_tpu_torch.ops import (  # noqa: E402
    batch_voxel, conv3x3, conv_halo, conv_lstm, head_cmajor, level,
    voxel_folded, voxel_scatter, voxel_tiled)
from ess_tpu_torch.ops.voxel import (  # noqa: E402
    masked_time_norm, normalize_from_stats, normalize_nonzero)
from ess_tpu_torch.ops.conv_s2d import (  # noqa: E402
    gates_bias_s2d, gates_kernel_s2d)
from ess_tpu_torch.recon import color  # noqa: E402
from ess_tpu_torch.recon.reconstructor import Reconstructor  # noqa: E402
from ess_tpu_torch.tools import (  # noqa: E402
    REPEATS as CHAIN_REPEATS, STEPS as CHAIN_STEPS, bench_head,
    bench_increments, bench_kernel, bench_level, bench_lstm,
    bench_lstm_breakdown, bench_uda_increments, profile_kernel, profile_lstm,
    roofline)
from ess_tpu_torch.train import builder, uda  # noqa: E402
from ess_tpu_torch.train.builder import build_modules, init_params  # noqa: E402
from ess_tpu_torch.train.streaming import run_streaming_eval  # noqa: E402
from ess_tpu_torch.train.supervised import (  # noqa: E402
    draw_augment, make_eval_step, make_train_step)

WINDOWS, EVENTS, CLASSES = bench.WINDOWS, bench.EVENTS_PER_WINDOW, bench.NUM_CLASSES
CELL_SHAPES = [(2, 64, 220, 320), (2, 128, 110, 160), (2, 256, 55, 80)]
# block convs (name, B, C_in, C_out, H, W): the E2VID head conv and the first
# encoder's conv over 2x2 space-to-depth blocks of a 440x640 window, and an
# odd shape (other tile widths, a ragged last pixel tile)
CONV_SHAPES = [("head", 2, 20, 128, 220, 320),
               ("encoder 0", 2, 128, 64, 220, 320),
               ("odd", 2, 24, 16, 13, 40),
               ("quad head", 2, 80, 512, 110, 160),
               ("quad encoder 0", 2, 512, 256, 110, 160),
               ("quad encoder 1", 2, 256, 128, 110, 160)]
# the quad-block rollout's level-0 cell (B, C, H, W): x, h and c in 2x2
# space-to-depth form at 440x640, the gate weights remapped
QUAD_CELL = (2, 256, 110, 160)
KERNEL_NAMES = ("B1", "B2", "B2-int8", "B3", "B4", "B4-int8", "B5", "T2",
                "B3-legacy", "T1", "B1-stack", "B1-raw", "B1-int8",
                "B3-int8", "B3-legacy-int8", "B3-legacy-raw")
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
# cells zero in one grid only, a voxelizer on 160 decoded packed windows vs
# its plain version (a + and - deposit that cancel in one order only)
VOXEL_PATTERN_MAX = 16
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
# ~2M events/s, DATA_SAMPLES labeled samples (two B=8 eval batches per
# wire) and DATA_STREAM windows streamed at B=1 per wire. The wires are
# DSECSequence's (binning, wire_format): f32 records on 5 x-slots per band
# (B1, the default) and on full-width bands (B3-legacy), and the packed u16
# wire's folded records (B1) and tile-sorted events (B3). Every other wire
# is held against the default under the slice bounds (SLICE_*): the
# full-width bands reorder sums, the packed wires quantize coordinates to
# 1/64 px, times to 1/60000 of a window and folded polarities to 1/127.
DATA_EVENTS = 20_000_000
DATA_SAMPLES = 16
DATA_STREAM = 60
DATA_WIRES = {"folded": ("folded", "f32"),
              "folded_bands": ("folded_bands", "f32"),
              "packed_folded": ("folded", "packed"),
              "packed": ("tile", "packed")}
# A packed wire against the default f32 wire: the windows before
# normalization within the JAX package's packed-vs-f32 grid bounds
# (tests/test_native.py: max |d| 0.25 on the folded wire, 1.01 on the tile
# wire, where an event in (-1, 0) is clamped onto the frame edge; mean |d|
# 5e-3), the eval outputs within the slice bounds on the latent, all
# pixels' argmax and the confusion matrix. The argmax where the top-2 gap
# exceeds SLICE_GAP is held to PACKED_PRED_AGREE_CLEAR, not to the
# summation-order bound: the quantized input moves the seeded backbone's
# logits by more, in the JAX package as in the port
# (tests/test_torch_packed_steps.py reads the same agreement from both).
# The bound lies between the correct decode (98.30-98.35 %) and the nearest
# of five faulty decodes (92.69-92.73 %, x one lattice step off; NVIDIA
# H100 80GB HBM3 at 700 W, PERF.md); the first packed batch is also decoded
# with the two faults nearest to it, and the bound must reject both.
PACKED_GRID_MAX = {"packed_folded": 0.25, "packed": 1.01}
PACKED_GRID_MEAN = 5e-3
PACKED_PRED_AGREE_CLEAR = 97.0
PACKED_FAULTS = {
    "x one lattice step (1/64 px) off": lambda d: dict(
        d, ev_x=d["ev_x"] + 1.0 / 64.0),
    "time 1% short": lambda d: dict(d, ev_t=d["ev_t"] * 0.99),
}
# the voxelizer each wire launches (KERNEL_NAMES index)
DATA_VOXELIZER = {"folded": 0, "folded_bands": 8, "packed_folded": 0,
                  "packed": 3}

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
def level_rule_lowered():
    """Lower the fused level's size rule (``level.FUSE_MIN_ELEMENTS``), so
    that its entry launches the kernels at the small shapes that check
    them against the int8 bounds."""
    saved = level.FUSE_MIN_ELEMENTS
    level.FUSE_MIN_ELEMENTS = 0
    try:
        yield
    finally:
        level.FUSE_MIN_ELEMENTS = saved


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
    voxel_folded.launches_stack = 0
    voxel_folded.launches_raw = 0
    voxel_folded.launches_int8 = 0
    voxel_tiled.launches_int8 = 0
    voxel_folded.launches_legacy_int8 = 0
    voxel_folded.launches_legacy_raw = 0


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
            head_cmajor.launches, voxel_folded.launches_stack,
            voxel_folded.launches_raw, voxel_folded.launches_int8,
            voxel_tiled.launches_int8, voxel_folded.launches_legacy_int8,
            voxel_folded.launches_legacy_raw)


def show_counts(counts) -> str:
    return ", ".join(f"{k} {n}" for k, n in zip(KERNEL_NAMES, counts))


def all_counts(want) -> tuple:
    """``want`` names the first kernels' counts; the rest are 0."""
    return tuple(want) + (0,) * (len(KERNEL_NAMES) - len(want))


def by_name(want: dict) -> tuple:
    """Launch counts (KERNEL_NAMES order) from {kernel name: count}; the
    rest 0."""
    unknown = set(want) - set(KERNEL_NAMES)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}")
    return tuple(want.get(n, 0) for n in KERNEL_NAMES)


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


def zero_pattern(a: torch.Tensor, b: torch.Tensor) -> int:
    """Cells zero in one grid only (the normalization counts nonzero
    cells, so such a cell moves by the grid's mean over its std)."""
    return int(((a != 0) != (b != 0)).sum())


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
        f"{err_raw:.3e}, normalized grid {err:.3e} (bound {VOXEL_ATOL}); "
        f"cells zero in one grid only {zero_pattern(grid_k, grid_p)}, "
        f"nonzero counts differ by "
        f"{(stats_k[:, 2] - stats_p[:, 2]).abs().max().item():.0f} at most")
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


PIN_REPLACES = {   # the TPU kernel form each pin row ports
    "B1-stack": "ess_tpu/ops/voxel_pallas.py:480",   # stack_out emission
    "B1-raw": "ess_tpu/ops/voxel_pallas.py:1257",    # layout='raw'
    "B1-int8": "ess_tpu/ops/voxel_pallas.py:463",    # int8 planes, slotted
    "B3-int8": "ess_tpu/ops/voxel_pallas.py:308",    # int8 planes, halo
    "B3-legacy-int8": "ess_tpu/ops/voxel_pallas.py:308",
    "B3-legacy-raw": "ess_tpu/ops/voxel_pallas.py:1257"}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of ``a`` and ``b`` whose bits differ (any dtype)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    if a.dtype in BITS:
        return bit_diff(a, b)[0]
    return int((a != b).sum())


def check_voxel_pins(dev) -> list:
    """The voxelizer pins' forms (phase 3): B1-stack, B1-raw, B1-int8,
    B3-legacy-int8 and B3-legacy-raw over one step's 160 windows of 100k
    events, B3-int8 at the streaming B=8 (its row's times) and B=1. The
    int8 forms against their plain versions bit for bit (both add the same
    integer products); the stack and raw forms against the default
    kernel's grid relaid out bit for bit, stats alike, and normalized
    against their plain versions (VOXEL_ATOL); kernel and plain times, the
    default's bound (the same bytes)."""
    cases = bench_kernel.make_cases(dev, 8 * WINDOWS, EVENTS, SENSOR_H,
                                    SENSOR_W, BINS, seed=1)
    th = voxel_folded.tile_h_for_bins(BINS)
    rows = {}

    def row(name, fn, plain, cols, kw, err, out_floats):
        n = cols[0].shape[0]
        ms = cuda_ms(lambda: fn(*cols, **kw), 20)
        plain_ms = cuda_ms(lambda: plain(*cols, **kw), 3)
        bound_ms, bound_by = voxel_bound(int(cols[4][:, -1].sum()),
                                         cols[4].numel(), out_floats)
        log(f"{name} ({n} windows): kernel {ms:.3f} ms, plain {plain_ms:.3f}"
            f" ms, bound {bound_ms:.3f} ms ({bound_by}), share of bound "
            f"{100.0 * bound_ms / ms:.1f}%")
        return {"name": name, "route": "cuda",
                "source": ("ess_tpu_torch/csrc/voxel_tiled.cu"
                           if name.startswith("B3-int8")
                           else "ess_tpu_torch/csrc/voxel_folded.cu"),
                "replaces": PIN_REPLACES[name], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    for wire in ("B1", "B3-legacy"):
        fn, cols, kw = cases[wire][:3]
        plain = voxel_folded.voxelize_folded_ref
        grid, stats = fn(*cols, **kw)
        name = f"{wire}-int8"
        reset_counts()
        out, out_stats = fn(*cols, **kw, **PIN_FORMS[name])
        if read_counts() != by_name({name: 1}):
            raise AssertionError(f"{name}: launches {show_counts(read_counts())}")
        ref, ref_stats = plain(*cols, **kw, **PIN_FORMS[name])
        n_diff, d = bit_diff(out, ref)
        moved = (out - grid).abs().max().item()
        stat_rel = ((out_stats - ref_stats).abs()
                    / ref_stats.abs().clamp(min=1.0)).max().item()
        log(f"{name} (160 windows): grid {n_diff} of {out.numel()} elements "
            f"differ from the plain int8 version (bound 0), max|d| {d:.3e}; "
            f"stats rel max|d| {stat_rel:.3e}; against the f32 grid max|d| "
            f"{moved:.3e} (1/127-step weights)")
        if n_diff or stat_rel > 1e-4:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows[name] = row(name, fn, plain, cols, {**kw, **PIN_FORMS[name]}, d,
                         out.numel() + 3 * out.shape[0])
        del out, ref
        for name in ((f"{wire}-stack", f"{wire}-raw") if wire == "B1"
                     else (f"{wire}-raw",)):
            form = PIN_FORMS[name]
            reset_counts()
            out, out_stats = fn(*cols, **kw, **form)
            if read_counts() != by_name({name: 1}):
                raise AssertionError(f"{name}: launches "
                                     f"{show_counts(read_counts())}")
            want = voxel_scatter.relayout(grid, form["layout"], th)
            n_diff, n_stats = same_bits(out, want), same_bits(out_stats,
                                                              stats)
            ref, ref_stats = plain(*cols, **kw, **form)
            err = (normalize_from_stats(out, out_stats)
                   - normalize_from_stats(ref, ref_stats)).abs().max().item()
            log(f"{name} (160 windows): against the default grid relaid out "
                f"{n_diff} elements and {n_stats} stats differ (bound 0); "
                f"normalized against the plain version max|d| {err:.3e} "
                f"(bound {VOXEL_ATOL})")
            if n_diff or n_stats or not err <= VOXEL_ATOL:
                raise AssertionError(f"{name} disagrees")
            rows[name] = row(name, fn, plain, cols, {**kw, **form}, err,
                             out.numel() + 3 * out.shape[0])
            del out, ref, want
        del grid, stats
    fn, cols, kw = cases["B3"][:3]
    plain = voxel_tiled.voxelize_tiled_ref
    kw8 = {**kw, **PIN_FORMS["B3-int8"]}
    for n in (8, 1):
        sub = [a[:n] for a in cols]
        reset_counts()
        out = fn(*sub, **kw8)
        if read_counts() != by_name({"B3-int8": 1}):
            raise AssertionError("B3-int8: launches "
                                 f"{show_counts(read_counts())}")
        ref = plain(*sub, **kw8)
        n_diff, d = bit_diff(out, ref)
        log(f"B3-int8 ({n} windows): grid {n_diff} of {out.numel()} "
            f"elements differ from the plain int8 version (bound 0)")
        if n_diff:
            raise AssertionError("B3-int8 disagrees with its plain version")
        r = row("B3-int8", fn, plain, sub, kw8, d, out.numel())
        rows.setdefault("B3-int8", r)
        del out, ref
    del cases
    torch.cuda.empty_cache()
    return [rows[n] for n in KERNEL_NAMES[10:]]


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
            f"normalized grid {e:.3e} (bound {VOXEL_ATOL}); cells zero in "
            f"one grid only {zero_pattern(got, want)}")
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
    bound_by, quad = set(), []
    for b8 in (False, True):
        for shape in CELL_SHAPES + [QUAD_CELL]:
            b, ch, hh, ww = shape
            b = 8 if b8 else b
            x, h, c, w, bias = cell_inputs(g, dev, b, ch, hh, ww, int8=int8)
            if shape == QUAD_CELL:   # the level-0 gate weights, remapped
                w, bias = (gates_kernel_s2d(w[:ch, :ch // 2]),
                           gates_bias_s2d(bias[:ch]))
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
                if shape == QUAD_CELL:
                    quad.append(quad_entry("quad level 0", 2 * ch, 4 * ch,
                                           hh, ww, t_k, t_p, t_b, by, None))
                    log_cell_plan(f"{name} quad", conv_halo.cell_plan(
                        b, hh, ww, ch, ch, int8=int8,
                        sm_count=conv_halo.sm_count(dev)))
                else:
                    ms, plain_ms = ms + t_k, plain_ms + t_p
                    lib_ms += t_l
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
            "library_ms": None, "quad": quad}


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


def quad_entry(name, cin, cout, hh, ww, t_k, t_p, t_b, by, t_l) -> dict:
    """One quad-block shape's numbers for a kernel row's ``quad`` list
    (B=8): kernel, plain and library ms and the bound."""
    return {"shape": f"{name} B=8 {cin}->{cout} {hh}x{ww}", "ms": t_k,
            "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
            "library_ms": t_l}


def check_conv3x3(dev):
    """B4 against its plain version at CONV_SHAPES (B=2) and at the main
    path's B=8 for the head and encoder-0 block convs; the row's times,
    bound and library time are those of the two B=8 convs, the B=2 ones are
    logged beside them."""
    g = torch.Generator().manual_seed(9)
    err = ms = plain_ms = bound_ms = lib_ms = 0.0
    bound_by, quad = set(), []

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
        if name.startswith("quad"):
            quad.append(quad_entry(name, cin, cout, hh, ww, t_k8, t_p8,
                                   t_b8, by8, t_l8))
        else:
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
            "library_ms": lib_ms, "quad": quad}


def check_conv3x3_int8(dev):
    """B4-int8 against its plain version at CONV_SHAPES (B=2), bit for bit,
    and at the main path's B=8 for the head and encoder-0 block convs, where
    the row's times and bound are taken: the two prep launches included,
    TOP/s, share of bound, launches per conv, the plan and what ``ptxas
    -v`` said; cuDNN's bf16 conv + bias + ReLU on the same shapes beside it
    (not the same function: ``library_ms`` stays None)."""
    g = torch.Generator().manual_seed(10)
    err = ms = plain_ms = bound_ms = 0.0
    bound_by, quad = set(), []

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
        if name.startswith("quad"):
            quad.append(quad_entry(name, cin, cout, hh, ww, t_k8, t_p8,
                                   t_b8, by8, None))
        else:
            ms, plain_ms = ms + t_k8, plain_ms + t_p8
            bound_ms += t_b8
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
            "library_ms": None, "quad": quad}


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
    give the same bits (at the small level, below JAX's size rule, it must
    decline)."""
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
        out = level.encoder_level_int8(
            u, (h0, c0.clone(memory_format=torch.channels_last)), ek, eb, gk,
            gb, u_s2d=u_s2d, prepared=prep)
        torch.cuda.synchronize()
        if level.launches != n0 + (1 if odd else 2):
            raise AssertionError("the level did not count its launches")
        if odd and out is not None:
            raise AssertionError("B5 took an h_prev below the size rule")
        if not odd and not (torch.equal(out[0], h_k)
                            and torch.equal(out[1][1], c_k)):
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
            f"encoder_level_int8 "
            f"{'declines (size rule)' if odd else 'gives the same bits'}; "
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
        del h_p, c_p, h_k, c_k, out
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
    pattern = zero_pattern(grid_k, grid_p)
    del grid_p
    kwb = dict(num_bins=BINS, height=SENSOR_H, width=SENSOR_W, normalize=True)
    got = batch_voxel.voxelize_band(x, y, t, p, vd, offs, **kwb)
    scols, soffs, _ = wires[True]
    err_wire = (got - batch_voxel.voxelize_band(*scols, soffs, **kwb)
                ).abs().max().item()
    log(f"B3-legacy voxel_folded_band ({n_win} windows): max|d| raw grid "
        f"{err_raw:.3e}, normalized grid {err:.3e} (bound {VOXEL_ATOL}), "
        f"cells zero in one grid only {pattern}; "
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


# Repeat phase: the seed of its inputs, and the width of the bits each
# dtype is compared in
REPEAT_SEED = 21
# the voxelizer pins' kernel forms: row name -> the wrapper's keywords
PIN_FORMS = {"B1-stack": {"layout": "stack"}, "B1-raw": {"layout": "raw"},
             "B1-int8": {"oh_dtype": "int8"}, "B3-int8": {"oh_dtype": "int8"},
             "B3-legacy-int8": {"oh_dtype": "int8"},
             "B3-legacy-raw": {"layout": "raw"}}
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.int8: torch.int8, torch.int32: torch.int32}


def bit_diff(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(elements of ``a`` and ``b`` whose bits differ, max |a - b|)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    n = int((a.view(BITS[a.dtype]) != b.view(BITS[b.dtype])).sum())
    d = (a.float() - b.float()).abs().max().item() if a.numel() else 0.0
    return n, d


def repeat_voxel_inputs(dev) -> dict:
    """The repeat phase's voxelizer calls, built from REPEAT_SEED by
    ``bench_kernel.make_cases`` (``bench.make_raw``'s recipe): B1 on the
    x-slot band wire and B3-legacy on the full-width one over 160 windows
    of 100k DSEC events, B3 on the tile wire over the first 8: name ->
    (function, columns, keywords)."""
    cases = bench_kernel.make_cases(dev, 8 * WINDOWS, EVENTS, SENSOR_H,
                                    SENSOR_W, BINS, seed=REPEAT_SEED)
    calls = {name: c[:3] for name, c in cases.items()}
    fn, cols, kw = calls["B3"]
    calls["B3"] = (fn, [a[:8] for a in cols], kw)
    # the pins' forms of each voxelizer, on the same inputs
    for name, form in PIN_FORMS.items():
        fn, cols, kw = calls[name.rsplit("-", 1)[0]]
        calls[name] = (fn, cols, {**kw, **form})
    return calls


def repeat_child(out_dir: str) -> None:
    """The repeat phase's second process: the same voxelizer inputs from
    the same seed, each voxelizer once, its outputs saved to ``out_dir``."""
    dev = torch.device("cuda", 0)
    for name, (fn, cols, kw) in repeat_voxel_inputs(dev).items():
        for i, t in enumerate(bench_kernel.outputs(fn, cols, kw)):
            np.save(os.path.join(out_dir, f"{name}_{i}.npy"), t.cpu().numpy())


def repeat_report(what: str, pairs, rows: list) -> None:
    """Log each (name, a, b) pair's differing elements and max |d|, and
    keep (what, name, n, d) in ``rows``."""
    for name, a, b in pairs:
        n, d = bit_diff(a, b)
        rows.append((what, name, n, d))
        log(f"  {what}: {name}: {n} of {a.numel()} elements differ, max|d| "
            f"{d:.3e}")


def repeat_voxelizers(dev, rows: list) -> None:
    calls = repeat_voxel_inputs(dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import chip_smoke as cs; "
                        f"cs.repeat_child({tmp!r})"], check=True,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
        log(f"repeat 1: second process done in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, (fn, cols, kw) in calls.items():
            first = bench_kernel.outputs(fn, cols, kw)
            second = bench_kernel.outputs(fn, cols, kw)
            torch.cuda.synchronize()
            parts = ("grid", "stats")
            repeat_report(f"1 {name} two launches", [
                (parts[i], a, b) for i, (a, b) in enumerate(
                    zip(first, second))], rows)
            other = [torch.from_numpy(np.load(os.path.join(
                tmp, f"{name}_{i}.npy"))).to(dev) for i in range(len(first))]
            repeat_report(f"1 {name} two processes", [
                (parts[i], a, b) for i, (a, b) in enumerate(
                    zip(first, other))], rows)
            del first, second, other
    del calls
    torch.cuda.empty_cache()


def repeat_cells(dev, rows: list) -> None:
    g = torch.Generator().manual_seed(REPEAT_SEED)
    for int8 in (False, True):
        name, impl = ("B2-int8", "pallas_int8") if int8 else ("B2", "pallas")
        for _, ch, hh, ww in CELL_SHAPES:
            x, h, c, w, bias = cell_inputs(g, dev, 8, ch, hh, ww, int8=int8)
            prep = conv_lstm.prepare_cell_weights(w, impl)
            outs = [conv_lstm.conv_lstm_cell(x, h, c.clone(), w, bias,
                                             impl=impl, prepared=prep)
                    for _ in range(2)]
            torch.cuda.synchronize()
            repeat_report(f"2 {name} B=8 C={ch} {hh}x{ww}", [
                ("h'", outs[0][0], outs[1][0]),
                ("c'", outs[0][1], outs[1][1])], rows)
    for int8 in (False, True):
        name, impl = ("B4-int8", "pallas_int8") if int8 else ("B4", "pallas")
        for what, _, cin, cout, hh, ww in CONV_SHAPES[:2]:
            x, w, bias = conv_inputs(g, dev, 8, cin, cout, hh, ww)
            prep = conv3x3.prepare_conv_weights(w, int8=int8)
            outs = [conv3x3.conv3x3_fused(x, w, bias, relu=True, impl=impl,
                                          prepared=prep) for _ in range(2)]
            torch.cuda.synchronize()
            repeat_report(f"2 {name} {what} B=8 {cin}->{cout} {hh}x{ww}",
                          [("y", outs[0], outs[1])], rows)


def repeat_rollout(dev, rows: list) -> None:
    mods, state, step = bench.build_train(bench.make_cfg(8), dev)
    batch = make_batch(REPEAT_SEED, 8, dev, ignore_rows=20)
    pipe = bench.make_pipeline()
    recon = mods.recon_train
    with torch.no_grad():
        windows, _ = pipe.build_all(batch, aug=AugmentParams(),
                                    out_dtype=recon.model.dtype)
        lats = [recon.rollout(windows, decode=False)[2] for _ in range(2)]
    torch.cuda.synchronize()
    repeat_report("3 int8 train rollout, one window stack", [
        (f"latent{k}", lats[0][k], lats[1][k]) for k in sorted(lats[0])],
        rows)
    del windows, lats

    # the train step twice from one seeded state on one batch
    runs = [(mods, state, step), bench.build_train(bench.make_cfg(8), dev)]
    got = []
    for m, st, stp in runs:
        seen = {}

        def keep_latent(mod, args, seen=seen):
            seen.setdefault("latent8", args[0][8].clone())

        hook = st.head.register_forward_pre_hook(keep_latent)
        before = [p.detach().clone() for p in st.head.parameters()]
        loss = stp(st, batch)["loss"]
        hook.remove()
        update = torch.cat([(p.detach() - q).reshape(-1).float() for p, q in
                            zip(st.head.parameters(), before)])
        got.append((loss, seen["latent8"], update))
    torch.cuda.synchronize()
    (l0, z0, u0), (l1, z1, u1) = got
    repeat_report("4 DSEC int8 train step, one state, one batch", [
        ("loss", l0, l1), ("latent8", z0, z1), ("head update", u0, u1)],
        rows)
    log(f"  4: head update max|d| over its largest |value| "
        f"{(u0 - u1).abs().max().item() / u0.abs().max().item():.3e}")
    del runs, got, mods, state, step
    torch.cuda.empty_cache()


def phase_repeat(dev) -> list:
    """Repeat phase: each comparison's elements that differ bit for bit,
    and their max |d|, between two runs on one input; any element that
    differs fails the phase. (1) B1, B3 and
    B3-legacy, and the pins' forms (PIN_FORMS), launched twice, and
    against a second process that builds the same input from the same
    seed; (2) B2, B2-int8, B4 and B4-int8
    launched twice at the main path's B=8 shapes; (3) the int8 train
    rollout twice on one window stack built once; (4) the DSEC int8
    train step twice from one seeded state on one batch: loss, latent8,
    the head's update."""
    t0 = time.perf_counter()
    rows = []
    repeat_voxelizers(dev, rows)
    repeat_cells(dev, rows)
    repeat_rollout(dev, rows)
    n_diff = sum(r[2] for r in rows)
    log(f"repeat phase: {sum(1 for r in rows if r[2])} of {len(rows)} "
        f"comparisons differ ({n_diff} elements) in "
        f"{time.perf_counter() - t0:.1f} s")
    if n_diff:
        raise AssertionError("two runs on one input differ: "
                             + "; ".join(f"{r[0]} {r[1]}: {r[2]}"
                                         for r in rows if r[2]))
    return rows


def phase_tools(dev, kern_rows):
    """The two attribution tools through their ``main``: at a small shape
    with the JAX level test's bounds enforced, then at B=8 and the three
    encoder levels with the counts read around each; then, at the same
    shapes and through the entry the tool drives, a 20-step fused chain
    against the plain chain."""
    chains = 1 + CHAIN_REPEATS                  # warm-up + timed chains
    with level_rule_lowered():   # LEVEL_SMALL is below the size rule
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
    need_counts(counts, by_name({"T1": 2 * per_variant}))
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


# A19's tools in phase 8: timed calls a bench_kernel case (3 warm-up + 3
# x TOOL_CALLS, then TOOL_REPEAT launches on one input) and steps a ladder
# rung (one warm-up + the iterations)
TOOL_CALLS, TOOL_REPEAT = 10, 3
LADDER_ITERS, UDA_LADDER_ITERS = 3, 2


def roofline_share(dev, kern_rows, tmp: str) -> None:
    """The roofline's bound of the supervised and UDA train steps beside
    each step's measured time at B=8 (``bench.windows_per_sec``), the
    share of the bound the step reaches, and each group's device time from
    a profile of one step (``roofline --trace``)."""
    for step_name, build, make in (
            ("supervised", lambda: bench.build_train(bench.make_cfg(8), dev),
             lambda: make_batch(0, 8, dev)),
            ("uda", lambda: bench.build_uda(bench.make_uda_cfg(8), dev),
             lambda: bench.make_uda_batch(0, 8, dev))):
        _, state, step = build()
        batch = make()
        wps = bench.windows_per_sec(step, state, batch, 10)
        ms = 1e3 * 8 * WINDOWS / wps
        prof = bench.profile_call(lambda: float(step(state, batch)["loss"]),
                                  tmp, f"roofline_{step_name}", top=1 << 30)
        res = roofline.main([f"--step={step_name}", "--json", "--trace",
                             prof["trace"]])
        bound_ms = res["total_bound_ms"]
        log(f"roofline, {step_name} train step B=8 T={WINDOWS}: bound "
            f"{bound_ms:.3f} ms a step ({res['bound_windows_per_sec']:.0f} "
            f"windows/s; datasheet peaks), measured {ms:.3f} ms "
            f"({8 * WINDOWS / ms * 1e3:.2f} windows/s), share of the bound "
            f"{100.0 * bound_ms / ms:.1f}%; device busy {prof['busy_ms']:.3f}"
            f" ms of the profiled step")
        for gr in res["groups"]:
            m = gr["measured_ms"]
            log(f"  {gr['group']}: bound {gr['bound_ms']:.3f} ms, device "
                f"{'-' if m is None else f'{m:.3f}'} ms"
                + ("" if not m or not gr["bound_ms"] else
                   f" ({100.0 * gr['bound_ms'] / m:.1f}% of the bound)"))
        if not (np.isfinite(ms) and 0 < bound_ms < ms):
            raise AssertionError(f"roofline {step_name}: bound {bound_ms} "
                                 f"vs measured {ms}")
        del state, step, batch
        torch.cuda.empty_cache()


def phase_tools_measure(dev, kern_rows) -> None:
    """A19's tools through their ``main`` at full size: the roofline beside
    the measured steps, bench_kernel (the voxelizers at 160 windows, a
    repeat check that must hold bit for bit) and profile_kernel, bench_lstm
    (library cell vs B2 and B2-int8 at the three encoder shapes, B2's and
    B2-int8's two launches bit for bit) and profile_lstm, and the two
    increments ladders; each reading must be finite."""
    with tempfile.TemporaryDirectory() as tmp:
        roofline_share(dev, kern_rows, tmp)
        per_case = 3 + 3 * TOOL_CALLS + TOOL_REPEAT
        reset_counts()
        res = bench_kernel.main(["--quick", f"--calls={TOOL_CALLS}",
                                 f"--repeat={TOOL_REPEAT}"])
        counts = read_counts()
        log(f"bench_kernel at 160 windows: launches {show_counts(counts)}")
        need_counts(counts, (per_case, 0, 0, per_case, 0, 0, 0, 0,
                             per_case))
        add_launches(kern_rows, "bench_kernel", counts)
        for name, lines in res.items():
            ln = lines[0]
            if not (ln["repeat"]["bit_for_bit"]
                    and np.isfinite(ln["device_ms"])):
                raise AssertionError(f"bench_kernel {name}: {ln}")
        reset_counts()
        profile_kernel.main([f"--out={tmp}"])
        counts = read_counts()
        need_counts(counts, (3, 0, 0, 3, 0, 0, 0, 0, 3))
        add_launches(kern_rows, "profile_kernel", counts)

        reset_counts()
        res = bench_lstm.main([])
        counts = read_counts()
        per_cell = 2 + (1 + CHAIN_REPEATS) * CHAIN_STEPS
        log(f"bench_lstm at B=8: launches {show_counts(counts)}")
        need_counts(counts, (0, 3 * per_cell, 3 * per_cell))
        add_launches(kern_rows, "bench_lstm", counts)
        for li, cells in res.items():
            for name, r in cells.items():
                if not (np.isfinite(r["ms_per_step"]) and (
                        name == "xla" or r["repeat_bit_for_bit"])):
                    raise AssertionError(f"bench_lstm L{li} {name}: {r}")
        reset_counts()
        profile_lstm.main([f"--out={tmp}"])
        counts = read_counts()
        need_counts(counts, (0, 3 * CHAIN_STEPS, 3 * CHAIN_STEPS))
        add_launches(kern_rows, "profile_lstm", counts)

    steps = 1 + LADDER_ITERS
    reset_counts()
    lines = bench_increments.main([f"--iters={LADDER_ITERS}"])
    counts = read_counts()
    log(f"bench_increments: launches {show_counts(counts)}")
    need_counts(counts, by_name({
        "B1": 2 * steps, "B2-int8": 6 * steps * 3 * WINDOWS, "B3": 2 * steps,
        "B4-int8": steps * 2 * WINDOWS, "B1-raw": steps, "B1-stack": steps,
        "B1-int8": steps}))
    add_launches(kern_rows, "bench_increments", counts)
    steps = 1 + UDA_LADDER_ITERS
    reset_counts()
    lines += bench_uda_increments.main([f"--iters={UDA_LADDER_ITERS}"])
    counts = read_counts()
    log(f"bench_uda_increments: launches {show_counts(counts)}")
    need_counts(counts, by_name({   # 5 rungs: the first on the library cell
        "B1": 4 * steps, "B2-int8": 4 * steps * 3 * WINDOWS,
        "B4-int8": steps * 2 * WINDOWS, "B1-raw": steps}))
    add_launches(kern_rows, "bench_uda_increments", counts)
    if not all(np.isfinite(ln["windows_per_sec"]) for ln in lines):
        raise AssertionError(f"a ladder rung is not finite: {lines}")


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


def wire_counts(wire: str, n_vox: int, n_exact: int, n_int8: int = 0
                ) -> tuple:
    """Launch counts (KERNEL_NAMES order) of a path on a phase-9 wire:
    ``n_vox`` voxelizer launches and the cells'."""
    counts = [0] * len(KERNEL_NAMES)
    counts[DATA_VOXELIZER[wire]] = n_vox
    counts[1], counts[2] = n_exact, n_int8
    return tuple(counts)


def wire_bytes(sample: dict) -> tuple:
    """(event columns + offsets, label) bytes of one sample."""
    arrays = {k: v for k, v in sample.items() if isinstance(v, np.ndarray)}
    label = arrays.pop("label").nbytes
    return sum(v.nbytes for v in arrays.values()), label


def packed_checks(dev, kern_rows, wire: str, batch: dict, eval_step,
                  logits) -> None:
    """On one packed batch (on the card, as the loader delivered it): the
    wire's voxelizer on the decoded windows against its plain version, the
    eval step against the plain versions, and the train and UDA train
    steps' launches and first losses against the plain versions."""
    pipe = bench.make_pipeline()
    dec = pipe.decode_packed(batch)
    if dec["ev_x"].device != batch["ev_xq"].device:
        raise AssertionError("the packed batch was decoded off its device")
    flat = lambda a: a.transpose(0, 1).reshape(-1, a.shape[-1]).contiguous()
    kind = "band" if wire == "packed_folded" else "tile"
    offs = flat(dec[f"ev_{kind}_offsets"])
    cols = [flat(dec[k]) for k in ("ev_x", "ev_y", "ev_t", "ev_p",
                                   "ev_valid")]
    x, y, t, p, valid = cols
    th = voxel_folded.tile_h_for_bins(BINS)
    kw = dict(bins=BINS, height=-(-SENSOR_H // th) * th, width=SENSOR_W)
    if kind == "band":
        args, kw = batch_voxel.band_operands(
            x, y, t, p, valid, offs, num_bins=BINS, height=SENSOR_H,
            width=SENSOR_W, t_prenormalized=True)
        kernel, plain = voxel_folded.voxelize_folded, \
            voxel_folded.voxelize_folded_ref
        grids = lambda f: f(*args, **kw)          # (grid, stats)
        norm = normalize_from_stats
    else:
        ok = valid & (x > -1) & (x < SENSOR_W) & (y > -1) & (y < SENSOR_H)
        pol = torch.where(ok, torch.where(p > 0, 1.0, -1.0), 0.0)
        args = (x, y, t, pol.contiguous(), offs.int())
        kernel, plain = voxel_tiled.voxelize_tiled, \
            voxel_tiled.voxelize_tiled_ref
        grids = lambda f: (f(*args, **kw), None)
        norm = lambda g, _: normalize_nonzero(g)
    (raw_k, stats_k), (raw_p, stats_p) = grids(kernel), grids(plain)
    err_raw = (raw_k - raw_p).abs().max().item()
    # on the 1/64-px lattice + and - events cancel exactly in one sum order
    # and leave a residue in another: such a cell is zero in one grid only,
    # and the nonzero normalization moves it by the grid's mean over std
    both = (raw_k != 0) & (raw_p != 0)
    err = (norm(raw_k, stats_k) - norm(raw_p, stats_p))[both].abs().max() \
        .item()
    pattern = int(((raw_k != 0) != (raw_p != 0)).sum())
    name = "B1" if kind == "band" else "B3"
    ms = cuda_ms(lambda: kernel(*args, **kw), 10)
    log(f"  {wire} wire, {name} on the {offs.shape[0]} decoded windows of a "
        f"B=8 batch vs its plain version: raw grid max|d| {err_raw:.3e}, "
        f"normalized grid max|d| {err:.3e} where both are nonzero (bounds "
        f"{VOXEL_ATOL}); {pattern} of {raw_k.numel()} cells zero in one "
        f"grid only (bound {VOXEL_PATTERN_MAX}); kernel {ms:.3f} ms a call")
    if not (err_raw <= VOXEL_ATOL and err <= VOXEL_ATOL
            and pattern <= VOXEL_PATTERN_MAX):
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"the {wire} wire")
    del raw_k, raw_p, dec, cols, args

    out = eval_step(batch)
    with plain_versions():
        ref = eval_step(batch)
    slice_agreement(f"{wire} wire, eval step B=8, kernel path vs plain path",
                    out["latent8"], ref["latent8"], out["pred"], ref["pred"],
                    logits[0], out["cm"], ref["cm"])
    del out, ref

    n_exact, n_int8 = int8_cells(8, SENSOR_H - CROP, SENSOR_W)
    cfg = bench.make_cfg(8)
    _, state, step = bench.build_train(cfg, dev)
    reset_counts()
    loss = float(step(state, batch)["loss"])
    counts = read_counts()
    need_counts(counts, wire_counts(wire, 1, n_exact * WINDOWS,
                                    n_int8 * WINDOWS))
    add_launches(kern_rows, f"data_train_{wire}", counts)
    _, state_p, step_p = bench.build_train(cfg, dev)
    with plain_versions():
        loss_p = float(step_p(state_p, batch)["loss"])
    rel = abs(loss - loss_p) / abs(loss_p)
    log(f"  {wire} wire, train step B=8 (int8 cell): launches "
        f"{show_counts(counts)}; loss {loss:.6f} vs plain {loss_p:.6f} "
        f"(relative difference {rel:.3e}, bound {TRAIN_LOSS_REL})")
    if not (np.isfinite(loss) and rel <= TRAIN_LOSS_REL):
        raise AssertionError(f"train step on the {wire} wire")
    del state, step, state_p, step_p

    ucfg = bench.make_uda_cfg(8)
    rng = np.random.default_rng(9)
    shape = (8, SENSOR_H - CROP, SENSOR_W)
    ubatch = {k: v for k, v in batch.items() if k.startswith("ev_")}
    ubatch["image_a"] = torch.from_numpy(rng.normal(
        size=(8, 1) + shape[1:]).astype(np.float32)).to(dev)
    ubatch["label_a"] = torch.from_numpy(
        rng.integers(0, CLASSES, shape)).to(dev)
    _, state, step = bench.build_uda(ucfg, dev)
    reset_counts()
    out = {k: float(v) for k, v in step(state, ubatch).items()}
    counts = read_counts()
    need_counts(counts, wire_counts(wire, 1, n_exact * WINDOWS,
                                    n_int8 * WINDOWS))
    add_launches(kern_rows, f"data_uda_train_{wire}", counts)
    _, state_p, step_p = bench.build_uda(ucfg, dev)
    with plain_versions():
        loss_p = float(step_p(state_p, ubatch)["loss"])
    rel = abs(out["loss"] - loss_p) / abs(loss_p)
    log(f"  {wire} wire, UDA train step B=8 (int8 cell): launches "
        f"{show_counts(counts)}; loss {out['loss']:.6f} vs plain "
        f"{loss_p:.6f} (relative difference {rel:.3e}, bound "
        f"{TRAIN_LOSS_REL})")
    if not (sorted(out) == UDA_LOSS_KEYS
            and all(np.isfinite(v) for v in out.values())
            and rel <= TRAIN_LOSS_REL):
        raise AssertionError(f"UDA train step on the {wire} wire")
    del state, step, state_p, step_p, ubatch
    torch.cuda.empty_cache()


def packed_grids(wire: str, batch: dict, ref_batch: dict) -> None:
    """The windows of a packed batch before normalization against those of
    the default f32 wire's batch of the same samples, within
    PACKED_GRID_MAX / PACKED_GRID_MEAN."""
    pipe = bench.make_pipeline()
    kw = dict(num_bins=BINS, height=SENSOR_H, width=SENSOR_W,
              trilinear=True)

    def grids(b):
        if "ev_xq" in b:
            b = pipe.decode_packed(b)
        kind = "band" if "ev_band_offsets" in b else "tile"
        flat = lambda a: a.transpose(0, 1).reshape(-1, a.shape[-1])
        return batch_voxel.voxelize_window_soa(
            *(flat(b[k]).contiguous() for k in ("ev_x", "ev_y", "ev_t",
                                                "ev_p", "ev_valid")),
            tile_offsets=flat(b[f"ev_{kind}_offsets"]).contiguous(),
            offsets_kind=kind,
            t_prenormalized=bool(b.get("ev_t_prenormalized", False)), **kw)

    d = (grids(batch) - grids(ref_batch)).abs()
    worst, mean = d.max().item(), d.mean().item()
    log(f"  {wire} wire vs folded wire, the B=8 x T={WINDOWS} windows before "
        f"normalization: max|d| {worst:.4f} (bound "
        f"{PACKED_GRID_MAX[wire]}), mean|d| {mean:.3e} (bound "
        f"{PACKED_GRID_MEAN})")
    if not (worst <= PACKED_GRID_MAX[wire] and mean <= PACKED_GRID_MEAN):
        raise AssertionError(f"the {wire} wire's windows are not the f32 "
                             "wire's within the quantization bounds")


def packed_faults(wire: str, batch: dict, ref: tuple, eval_step) -> None:
    """The first packed batch decoded with each of PACKED_FAULTS through the
    eval step, against the f32 wire's outputs ``ref`` (latent, pred, cm,
    logits): each fault's argmax agreement where the top-2 gap exceeds
    SLICE_GAP must fall below PACKED_PRED_AGREE_CLEAR."""
    dec = bench.make_pipeline().decode_packed(batch)
    for fault, mangle in PACKED_FAULTS.items():
        out = eval_step(mangle(dec))
        agree, agree_clear = pred_agreement(out["pred"], ref[1], ref[3])
        rel = ((out["latent8"] - ref[0]).abs().max()
               / ref[0].abs().max()).item()
        log(f"  {wire} wire decoded with a fault, {fault}, vs folded wire: "
            f"latent rel max|d| {rel:.3e}; pred agreement {agree:.3f}%, "
            f"{agree_clear:.3f}% where the top-2 gap exceeds {SLICE_GAP} "
            f"(must be < {PACKED_PRED_AGREE_CLEAR}%)")
        if not agree_clear < PACKED_PRED_AGREE_CLEAR:
            raise AssertionError(f"the {wire} wire's agreement bound does "
                                 f"not reject a decode with {fault}")
    del dec


def phase_data(dev, kern_rows):
    """Phase 9: the host event path on the four DSEC wires, from an
    in-memory recording through the dataset, the loader and the device
    prefetch to the eval step (B=8), and through ``SequenceRecurrent`` to
    ``run_streaming_eval`` (B=1); on the packed wires also the train and
    UDA steps (:func:`packed_checks`)."""
    t0 = time.perf_counter()
    rec = make_recording(5)
    card = bench.card()
    log(f"data: in-memory recording of {DATA_EVENTS} events "
        f"({(int(rec[0].t[-1]) + 1) / 1e6:.2f} s), {len(rec[3])} labels, "
        f"made in {time.perf_counter() - t0:.1f} s; card {card}")
    seqs = {wire: dsec.DSECSequence.from_store(
        *rec, nr_events_data=WINDOWS, nr_events_window=EVENTS,
        binning=binning, wire_format=fmt)
        for wire, (binning, fmt) in DATA_WIRES.items()}
    n_groups = {"folded": SENSOR_H // 24 * (SENSOR_W // 128),
                "folded_bands": SENSOR_H // 24,
                "packed_folded": SENSOR_H // 24 * (SENSOR_W // 128),
                "packed": SENSOR_H // 24 * (SENSOR_W // 128)}
    for wire, seq in seqs.items():
        best = float("inf")
        for i in range(3):
            t0 = time.perf_counter()
            sample = seq[i]
            best = min(best, time.perf_counter() - t0)
        packed = DATA_WIRES[wire][1] == "packed"
        offs = sample["tile_offsets" if wire == "packed"
                      else "band_offsets"]
        if offs.shape != (WINDOWS, n_groups[wire] + 1):
            raise AssertionError(f"{wire}: offsets {offs.shape}")
        cap = sample["ev_xq" if packed else "raw_events"].shape[1]
        ev_bytes, label_bytes = wire_bytes(sample)
        what = ("tile binning" if wire == "packed"
                else "ghost-folded binning")
        log(f"host ingest, {wire} wire: {1e3 * best / WINDOWS:.3f} ms per "
            f"window of {EVENTS} events (slicer + fused native rectify, "
            f"time {'normalization, 1/64-px quantization' if packed else 're-zero'}"
            f" and {what}, one thread; best of 3 samples), offsets "
            f"{offs.shape}, capacity {cap}; host-to-device bytes a B=8 batch:"
            f" {8 * ev_bytes / 1e6:.2f} MB of events and offsets "
            f"({ev_bytes / (WINDOWS * EVENTS):.3f} B an event) + "
            f"{8 * label_bytes / 1e6:.2f} MB of labels ({card})")

    mods, step = bench.build_eval(8, dev)
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    hook = mods.head.register_forward_hook(keep_logits)
    n_batches = DATA_SAMPLES // 8
    label_px = 8 * (SENSOR_H - CROP) * SENSOR_W
    results, first = {}, {}
    for wire in DATA_WIRES:
        dl = loader.BatchLoader(seqs[wire], batch_size=8, shuffle=False,
                                num_workers=4, collate_buffers=4,
                                prefetch_size=2, pin_memory=True)

        def one_pass(keep=None):
            for batch in loader.prefetch_to_device(iter(dl), size=2,
                                                   device=dev):
                batch = to_soa(batch)
                out = step(batch)
                if keep is not None:
                    first.setdefault(wire, batch)
                    keep.append((out["latent8"], out["pred"], out["cm"],
                                 logits[0]))
            torch.cuda.synchronize()

        reset_counts()
        keep = []
        one_pass(keep)
        counts = read_counts()
        log(f"data -> loader -> prefetch -> eval step, {wire} wire, "
            f"{n_batches} batches of B=8 T={WINDOWS}: launches "
            f"{show_counts(counts)}")
        need_counts(counts, wire_counts(wire, n_batches,
                                        3 * WINDOWS * n_batches))
        add_launches(kern_rows, f"data_{wire}", counts)
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
            f"device idle share {100.0 * prof['idle_share']:.1f}%; {card})")
    for wire in list(DATA_WIRES)[1:]:
        packed = DATA_WIRES[wire][1] == "packed"
        if packed:
            packed_grids(wire, first[wire], first["folded"])
        for i, (ref, got) in enumerate(zip(results["folded"],
                                           results[wire])):
            what = f"eval batch {i}, {wire} wire vs folded wire"
            if packed:
                d = (got[3] - ref[3]).abs().flatten()
                q = torch.quantile(d[torch.randperm(
                    d.numel(), device=d.device)[:2 ** 24]], 0.999).item()
                what += (f" (logits |d| max {d.max().item():.3f}, 99.9th "
                         f"percentile {q:.3f})")
            slice_agreement(what, got[0], ref[0], got[1], ref[1], ref[3],
                            got[2], ref[2], clear_min=(
                                PACKED_PRED_AGREE_CLEAR if packed
                                else SLICE_PRED_AGREE_CLEAR))
        if packed:
            packed_faults(wire, first[wire], results["folded"][0], step)
    del results, keep
    for wire in DATA_WIRES:
        if DATA_WIRES[wire][1] == "packed":
            packed_checks(dev, kern_rows, wire, first[wire], step, logits)
    hook.remove()
    del first, mods, step
    torch.cuda.empty_cache()

    mods1, _ = bench.build_stream(1, dev)
    pipe = bench.make_pipeline()
    cms = {}
    for wire, (binning, fmt) in DATA_WIRES.items():
        stream = dsec.SequenceRecurrent(
            dsec.DSECSequence.from_store(*rec, nr_events_data=1,
                                         nr_events_window=EVENTS,
                                         binning=binning, wire_format=fmt),
            nr_events_window=EVENTS)
        scored = sum(w < DATA_STREAM for w in stream.label_idx)

        def run():
            return run_streaming_eval(
                mods1, (stream[i] for i in range(DATA_STREAM)), pipe)

        reset_counts()
        m = run()
        counts = read_counts()
        log(f"data -> SequenceRecurrent -> run_streaming_eval B=1, {wire} "
            f"wire, {DATA_STREAM} windows ({scored} scored): launches "
            f"{show_counts(counts)}")
        need_counts(counts, wire_counts(wire, DATA_STREAM, 3 * DATA_STREAM))
        add_launches(kern_rows, f"data_stream_{wire}", counts)
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
            f"device idle share {100.0 * prof['idle_share']:.1f}%; {card})")
    for wire in list(DATA_WIRES)[1:]:
        moved = 100.0 * np.abs(cms[wire] - cms["folded"]).sum() / (
            2 * cms["folded"].sum())
        log(f"  streaming, {wire} wire vs folded wire: confusion matrix "
            f"{moved:.3f}% of the pixels moved (bound <= "
            f"{100.0 - SLICE_PRED_AGREE}%)")
        if not moved <= 100.0 - SLICE_PRED_AGREE:
            raise AssertionError(f"the {wire} wire disagrees in streaming")
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
    calls_train = list(calls)
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
    _, train_b, _, _, _ = cli_train.build_loaders(cfg)
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
    _, train_b, _, val_b, _ = cli_train.build_loaders(cfg_r)
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
    return {"yaml": yaml_sup, "run": run_dir, "losses": losses,
            "calls": calls_train}


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
    train_a, train_b, val_a, val_b, _ = cli_train.build_loaders(cfg)
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
    train_a, train_b, val_a, val_b, _ = cli_train.build_loaders(cfg)
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
# frames held against each other on at most 0.1 % of a frame's values: gray
# within 1 grey level; with --color, the frames the color merge reads (the
# four half-resolution Bayer phase frames and the full-resolution gray one,
# the rollout's outputs) within 1, and the merged color frames within the
# merge's own bound, recon/color.py::merge_move_bound: the largest move of
# a merged value that a one-level move of one input value can cause through
# the resize, the G/W mean and the 8-bit Lab round trip (38 levels over all
# 2^24 triples). B3 sums in no fixed order, so its grids differ from the
# plain version's at ~1e-7 and may flip a frame value's rounding. B3's raw grid on every window of the -N and -T
# runs is held against its plain version on the CPU within RECON_GRID_TOL
# (absolute and relative), as tests/test_torch_kernels_cuda.py does.
RECON_HW = (260, 346)
RECON_RATE = 1_000_000        # events/s of the written streams
RECON_RUNS = (("gray_N", "short.txt", ["-N", "10000"], 60),
              ("gray_T", "long.txt", ["-T", "50"], 20),
              ("color_N", "short.zip", ["-N", "20000", "--color"], 30))
RECON_FRAME_BOUND = {"gray_N": (1, 0.001), "gray_T": (1, 0.001),
                     "color_N": (None, 0.001),   # None: merge_move_bound
                     "color_N merged frames": (1, 0.001)}
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


@contextlib.contextmanager
def merge_inputs(frames: list):
    """Record, for each call of ``recon/color.py``'s color merge, the
    frames it reads: the R, G, W, B phase frames and the gray frame."""
    merge = color.merge_channels_into_color_image

    def tapped(channels):
        frames.append([channels[k].copy() for k in
                       ("R", "G", "W", "B", "grayscale")])
        return merge(channels)
    color.merge_channels_into_color_image = tapped
    try:
        yield
    finally:
        color.merge_channels_into_color_image = merge


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

    t0 = time.perf_counter()
    merge_bound = color.merge_move_bound()
    log(f"  the color merge's bound (recon/color.py::merge_move_bound, all "
        f"2^24 triples, {time.perf_counter() - t0:.1f} s): {merge_bound}")
    if merge_bound["bound"] < 1:
        raise AssertionError("a merge step moves a value by more than one "
                             "level")
    merged = {}
    for name, src, flags, n_win in RECON_RUNS:
        argv = ["-c", ckpt, "-i", os.path.join(folder, src)] + flags
        out = {}
        for path in ("kernel", "plain"):
            out[path] = os.path.join(folder, f"{name}_{path}")
            with plain_versions() if path == "plain" else \
                    contextlib.nullcontext(), \
                    merge_inputs(merged.setdefault(path, [])):
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
        frames = [(name, [got[k] for k in names],
                   [want[k] for k in names], shape)]
        if "--color" in flags:
            got_in, want_in = merged["kernel"], merged["plain"]
            if len(got_in) != n_win or len(want_in) != n_win:
                raise AssertionError(f"{name}: {len(got_in)} merges; want "
                                     f"{n_win}")
            frames.insert(0, (f"{name} merged frames",
                              [f for c in got_in for f in c],
                              [f for c in want_in for f in c], None))
        for what, got_f, want_f, fshape in frames:
            levels, share = RECON_FRAME_BOUND[what]
            levels = merge_bound["bound"] if levels is None else levels
            worst, off_share, spread = 0, 0.0, []
            for g, wnt in zip(got_f, want_f):
                if g.shape != wnt.shape or (fshape and g.shape != fshape):
                    raise AssertionError(f"{what}: frame {g.shape}")
                off = np.abs(g.astype(np.int16) - wnt)
                worst = max(worst, int(off.max()))
                off_share = max(off_share, float((off > 0).mean()))
                spread.append(float(g.std()))
            log(f"  {what}, kernel vs plain path: max {worst} levels, at "
                f"most {100 * off_share:.3f} % of a frame's values differ "
                f"(bound {levels}, {100 * share:.1f} %); frame std "
                f"{min(spread):.1f}-{max(spread):.1f} levels")
            if worst > levels or off_share > share or min(spread) < 2:
                raise AssertionError(f"{what}: frames disagree or are flat")

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
    recon = Reconstructor(model=model, height=h, width=w, normalize=False)

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


# The YAML's model and event options (phase 5g). Each changes one key of a
# config the repo ships; everything else runs as written. The CLI runs take
# phase 5d's DDD17 tree (and phase 5e's Cityscapes tree for the UDA run),
# one epoch of CLI_STEPS steps and the validations the Trainer runs. The
# per-call launches (B1, B2) follow from the wire and the cell: the
# histogram and EV-SegNet representations take tile-sorted raw events (no
# B1: their scatter is ATen's) and the ConvLSTM cells; the ConvGRU backbone
# computes its gates on the library convs (no B2); instance norm rolls out
# in the standard layout on the same kernels.
OPTION_KEYS = {
    "histogram": ("event_representation", "histogram"),
    "ev_segnet": ("event_representation", "ev_segnet"),
    "convgru": ("e2vid_recurrent_block", "convgru"),
    "IN": ("e2vid_norm", "IN"),
    "plain_head": ("skip_connect_task", False),
}
OPTION_CLI_RUNS = (   # (run, option, config, per-call launches B1, B2)
    ("histogram", "histogram", 0, (0, 3 * WINDOWS)),
    ("ev_segnet", "ev_segnet", 0, (0, 3 * WINDOWS)),
    ("convgru", "convgru", 0, (1, 0)),
    ("IN", "IN", 0, (1, 3 * WINDOWS)),
    ("plain_head", "plain_head", 0, (1, 3 * WINDOWS)),
    ("uda_histogram", "histogram", 1, (0, 3 * WINDOWS)),
)
OPTION_DSEC = ("histogram", "convgru")    # the DSEC steps at the bench shape
SANITY_STEPS = 40


def option_yaml_key(option: str) -> str:
    """The YAML key of ``option`` in the DDD17 configs."""
    key, _ = OPTION_KEYS[option]
    return (f"dataset.DDD17_events.{key}" if key == "event_representation"
            else f"model.{key}")


def with_option(cfg, option: str):
    """``cfg`` with the one key of ``option`` changed."""
    import dataclasses

    key, value = OPTION_KEYS[option]
    if key == "event_representation":
        return cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, sensor_b=dataclasses.replace(
                cfg.dataset.sensor_b, event_representation=value)))
    return cfg.replace(model=dataclasses.replace(cfg.model, **{key: value}))


def last_hidden(state) -> torch.Tensor:
    """The deepest level's hidden state: h of (h, c), or a GRU's h."""
    top = state[-1]
    return (top[0] if isinstance(top, tuple) else top).float()


def option_cli(dev, kern_rows, tmp: str, root: str, city: str) -> None:
    """Phase 5g, part 1: the train CLI on each option (OPTION_CLI_RUNS)."""
    from ess_tpu_torch.cli import train as cli_train
    from ess_tpu_torch.core.config import load_config
    from ess_tpu_torch.io import timers
    from ess_tpu_torch.train import loop

    win = DDD17_B * WINDOWS
    for run, option, which, per_call in OPTION_CLI_RUNS:
        changes = {"dataset.DDD17_events.dataset_path": root,
                   "dir.log": os.path.join(tmp, f"opt_{run}"),
                   "optim.num_epochs": 1,
                   option_yaml_key(option): OPTION_KEYS[option][1]}
        if which == 0:
            changes["dataset.DDD17_events.require_paired_data_val"] = False
        else:
            changes["dataset.cityscapes_img.dataset_path"] = city
        log(f"phase 5g run {run}, from {CLI_CONFIGS[which]}:")
        path = cli_yaml(tmp, CLI_CONFIGS[which], f"opt_{run}.yaml", changes)
        cfg = load_config(path)
        calls = []
        timers.reset_timers()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with tapped_steps(calls):
            out = captured(cli_train.main, ["--settings_file", path])
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        step_s = list(timers._ACCUM["train_step"])
        timers.reset_timers()
        n_val = 2           # before the epoch and after it
        log(f"  cli.train, {run}: {CLI_STEPS} train steps, {n_val} "
            f"validations; launches {show_counts(counts)}")
        need_calls(calls, "train", CLI_STEPS, per_call)
        need_calls(calls, "eval", n_val, per_call)
        need_counts(counts, [(CLI_STEPS + n_val) * k for k in per_call])
        add_launches(kern_rows, f"option_cli_{run}", counts)
        summary = printed_summary(out)
        losses = [c[2] for c in calls if c[0] == "train"]
        if not (all(np.isfinite(losses)) and summary
                and all(0.0 <= v <= 100.0 for k, v in summary.items()
                        if k.endswith("mean_iou"))):
            raise AssertionError(f"cli.train, {run}: bad run {summary}")
        log(f"  losses {[round(v, 5) for v in losses]}; summary {summary}; "
            f"ms per train step in the Trainer "
            f"{[round(1e3 * t, 1) for t in step_s]} (the second, after the "
            f"first's warm-up: {win / step_s[-1]:.2f} windows/s); peak "
            f"device memory {peak / 2 ** 30:.2f} GiB")
        train_a, train_b, _, _, _ = cli_train.build_loaders(cfg)
        with plain_versions():
            tr = loop.Trainer(cfg, train_b=train_b, train_a=train_a,
                              log_dir=os.path.join(tmp, f"opt_plain_{run}"))
            batches = tr._train_batches()
            loss_p = float(tr.train_step(tr.state, next(batches))["loss"])
            batches.close()
        rel = abs(losses[0] - loss_p) / abs(loss_p)
        log(f"  step 1, kernel path vs plain path: loss {losses[0]:.6f} vs "
            f"{loss_p:.6f} (relative difference {rel:.3e}, bound "
            f"{TRAIN_LOSS_REL})")
        if not rel <= TRAIN_LOSS_REL:
            raise AssertionError(f"cli.train, {run}: kernel path disagrees "
                                 "with the plain path")
        del tr, batches
        torch.cuda.empty_cache()


def option_dsec(dev, kern_rows, tmp: str) -> None:
    """Phase 5g, part 2: the DSEC supervised eval and train steps at the
    bench shape (B=8, T=20, 100k events, 440x640, train rollout on the int8
    cell) with each of OPTION_DSEC, against the plain path, with rates,
    peak memory and the idle share of a profiled step."""
    from ess_tpu_torch.train.builder import init_state
    from ess_tpu_torch.train.supervised import make_train_step

    b = 8
    n_exact, n_int8 = int8_cells(b, SENSOR_H - CROP, SENSOR_W)
    for option in OPTION_DSEC:
        cfg = with_option(bench.make_cfg(b), option)
        tile = cfg.dataset.sensor_b.event_representation != "voxel_grid"
        batch = make_batch(4, b, dev, wire="tile" if tile else "band",
                           ignore_rows=20)
        pipe = builder.make_pipeline(cfg, train=False)
        gru = cfg.model.e2vid_recurrent_block == "convgru"
        b1 = 0 if tile else 1
        want_eval = (b1, 0 if gru else 3 * WINDOWS)
        want_train = (b1, 0 if gru else n_exact * WINDOWS,
                      0 if gru else n_int8 * WINDOWS)

        def built():
            mods = build_modules(cfg, device=dev)
            init_params(mods, torch.Generator().manual_seed(0))
            return mods

        mods = built()
        logits = [None]
        hook = mods.head.register_forward_hook(
            lambda mod, args, out: logits.__setitem__(0, out[1].float()))
        ev = make_eval_step(mods, pipe)
        reset_counts()
        out = ev(batch)
        counts = read_counts()
        log(f"DSEC eval step B={b}, {option}: launches {show_counts(counts)}")
        need_counts(counts, want_eval)
        add_launches(kern_rows, f"option_dsec_eval_{option}", counts)
        if not (np.isfinite(float(out["loss"]))
                and float(out["cm"].sum()) == float(
                    (batch["label"] != 255).sum())):
            raise AssertionError(f"DSEC eval, {option}: bad output")
        with plain_versions():
            ref = ev(batch)
        slice_agreement(f"DSEC eval, {option}, kernel path vs plain path",
                        out["latent8"], ref["latent8"], out["pred"],
                        ref["pred"], logits[0], out["cm"], ref["cm"])
        hook.remove()
        del out, ref, logits

        state = init_state(mods)
        step = make_train_step(mods, pipe)
        reset_counts()
        loss = float(step(state, batch)["loss"])
        counts = read_counts()
        mods_p = built()
        state_p = init_state(mods_p)
        step_p = make_train_step(mods_p, pipe)
        with plain_versions():
            loss_p = float(step_p(state_p, batch)["loss"])
        rel = abs(loss - loss_p) / abs(loss_p)
        log(f"DSEC train step B={b}, {option}: launches {show_counts(counts)};"
            f" step 1 loss {loss:.6f} vs the plain path's {loss_p:.6f} "
            f"(relative difference {rel:.3e}, bound {TRAIN_LOSS_REL})")
        need_counts(counts, want_train)
        add_launches(kern_rows, f"option_dsec_train_{option}", counts)
        if not rel <= TRAIN_LOSS_REL:
            raise AssertionError(f"DSEC train, {option}: kernel path "
                                 "disagrees with the plain path")

        def eval_call():
            float(ev(batch)["loss"])

        def train_call():
            float(step(state, batch)["loss"])

        for name, call, plain_call in (
                ("eval", eval_call, eval_call),
                ("train", train_call,
                 lambda: float(step_p(state_p, batch)["loss"]))):
            torch.cuda.reset_peak_memory_stats()
            call()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            times = {"kernel": [], "plain": []}
            for plain in (True, False, False, True):
                with plain_versions() if plain else contextlib.nullcontext():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    (plain_call if plain else call)()
                    torch.cuda.synchronize()
                    times["plain" if plain else "kernel"].append(
                        time.perf_counter() - t0)
            prof = bench.profile_call(call, os.path.join(tmp, "opt_prof"),
                                      f"{name}_{option}", top=4)
            for kind, ts in times.items():
                med = statistics.median(ts)
                log(f"  DSEC {name} step B={b}, {option} ({kind} versions): "
                    f"{b * WINDOWS / med:.2f} windows/s, "
                    f"{[round(1e3 * t, 1) for t in ts]} ms")
            log(f"  DSEC {name} step B={b}, {option}: peak device memory "
                f"{peak:.2f} GiB; profiled step: device busy "
                f"{prof['busy_ms']:.1f} ms of a {prof['span_ms']:.1f} ms "
                f"span, idle share {100 * prof['idle_share']:.1f} %; top "
                + ", ".join(f"{k['name'][:40]} {k['ms']:.2f} ms "
                            f"({k['calls']})" for k in prof["top"]))
        del mods, mods_p, state, state_p, step, step_p, ev, batch
        torch.cuda.empty_cache()


def option_stream(dev, kern_rows, tmp: str) -> None:
    """Phase 5g, part 3: streaming with the ConvGRU backbone at B=8 over
    STREAM_WINDOWS windows on the tile wire (B3 a window, the gates on the
    library convs), against the plain path, with its rate and idle
    share."""
    from ess_tpu_torch.train.streaming import make_streaming_steps

    b = 8
    cfg = with_option(bench.make_cfg(b, None), "convgru")
    mods = build_modules(cfg, device=dev)
    init_params(mods, torch.Generator().manual_seed(0))
    steps = make_streaming_steps(mods, builder.make_pipeline(cfg,
                                                             train=False))
    logits = [None]
    hook = mods.head.register_forward_hook(
        lambda mod, args, out: logits.__setitem__(0, out[1].float()))
    windows = bench.make_stream(7, b, dev, "tile", windows=STREAM_WINDOWS,
                                resets=((0, 1.0), (STREAM_WINDOWS // 2, 0.5)))
    reset_counts()
    state, cm = bench.run_stream(steps, mods.recon_val.init_state(b, dev),
                                 windows)
    counts = read_counts()
    log(f"streaming B={b}, convgru, tile wire, {STREAM_WINDOWS} windows: "
        f"launches {show_counts(counts)}")
    need_counts(counts, (0, 0, 0, STREAM_WINDOWS))
    add_launches(kern_rows, "option_stream_convgru", counts)
    latent, pred = last_hidden(state), logits[0].argmax(dim=1)
    if not (len(state) == 3 and tuple(latent.shape) == (b, 256, 55, 80)
            and torch.isfinite(latent).all()):
        raise AssertionError("streaming, convgru: bad state")
    with plain_versions():
        state_p, cm_p = bench.run_stream(
            steps, mods.recon_val.init_state(b, dev), windows)
    slice_agreement("streaming B=8, convgru, kernel path vs plain path after "
                    f"{STREAM_WINDOWS} windows", latent, last_hidden(state_p),
                    pred, logits[0].argmax(dim=1), logits[0], cm, cm_p)
    hook.remove()
    timed = windows[:bench.WINDOWS_PER_SCORE]
    rates = {"plain": [], "kernel": []}
    for plain in (True, False, False, True):
        with plain_versions() if plain else contextlib.nullcontext():
            rates["plain" if plain else "kernel"].append(
                bench.stream_windows_per_sec(mods, steps, timed, 3))
    carried = [mods.recon_val.init_state(b, dev)]

    def twenty_windows():
        carried[0], cm_ = bench.run_stream(steps, carried[0], timed)
        float(cm_.sum())

    prof = bench.profile_call(twenty_windows, os.path.join(tmp, "opt_prof"),
                              "stream_convgru", top=4)
    for name, r in rates.items():
        log(f"  streaming B={b}, convgru ({name} versions): "
            f"{statistics.median(r):.2f} windows/s (runs "
            f"{[round(v, 1) for v in r]})")
    log(f"  profiled 20 windows: device busy {prof['busy_ms']:.1f} ms of a "
        f"{prof['span_ms']:.1f} ms span, idle share "
        f"{100 * prof['idle_share']:.1f} %")
    del mods, steps, windows, state, state_p, timed, carried
    torch.cuda.empty_cache()


def option_sanity(dev, kern_rows) -> None:
    """Phase 5g, part 4: the training-sanity tool's ``main`` (int8 train
    cell) and its overfit on the exact cell and on the histogram
    representation; the loss must fall below LOSS_DROP of the first
    step's on both cells."""
    from ess_tpu_torch.tools import sanity_train as st

    reset_counts()
    text = captured(st.main, SANITY_STEPS)
    counts = read_counts()
    log(f"  sanity_train.main: launches {show_counts(counts)}")
    add_launches(kern_rows, "option_sanity_int8", counts)
    if "SANITY OK" not in text:
        raise AssertionError("sanity_train.main did not finish")
    host = st.make_scene_batch(np.random.default_rng(0), st.B, st.T, st.N,
                               st.SENSOR_H, st.SENSOR_W, st.CLASSES,
                               st.CROP_BOTTOM)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in host.items()}
    for name, kw, must_fall in (
            ("exact", dict(lstm_impl_train=None), True),
            ("histogram", dict(representation="histogram"), False)):
        lines = []
        reset_counts()
        losses, miou = st.overfit(st.sanity_config(**kw), batch,
                                  SANITY_STEPS, device=dev, log=lines.append)
        counts = read_counts()
        add_launches(kern_rows, f"option_sanity_{name}", counts)
        fell = losses[-1] < st.LOSS_DROP * losses[0]
        log(f"  sanity overfit, {name}: losses "
            f"{[round(v, 4) for v in losses]}; train-batch mIoU {miou:.1f}; "
            f"last/first {losses[-1] / losses[0]:.3f} (bound < "
            f"{st.LOSS_DROP}{'' if must_fall else ', reported'}); launches "
            f"{show_counts(counts)}")
        if must_fall and not fell:
            raise AssertionError(f"sanity overfit, {name}: the loss did not "
                                 "fall")
    del batch
    torch.cuda.empty_cache()


# Data parallel (phase 5h): a world of one on NCCL through the train CLI,
# against the one-device CLI run twice; two gloo ranks sharing this card
# (parallel.launch.spawn, backend='gloo'), each step on its rows of the
# global batch, against the one-device step on that batch. Checks of the
# two ranks, of which each planted fault (DP_FAULTS, run in the same ranks
# on both steps) must fail at least one:
# - sx: every int8 prep call (cells and block convs) forms on every rank
#   the s_x of the largest |x| over the ranks' rows of that call, bit for
#   bit (a tap reads each call's local |x| maximum and its s_x); the
#   batch's sample B/2, rank 1's first row, piles events on one pixel, so
#   its |x| dwarfs rank 0's;
# - agree: the ranks' losses and states are equal bit for bit;
# - loss: each loss within DP_LOSS_REL (relative) of the one-device step;
# - update: each trainable parameter after one step within DP_UPDATE_REL of
#   the one-device step's largest change to a parameter (RAdam's first
#   update is lr times the gradient, so this bounds the gradient), and
#   each batch-norm running statistic within DP_UPDATE_REL of the largest
#   change to one (a statistic moves by ~1e3x a parameter's update: held
#   in one group with the parameters, it would hide them). The int8 cells
#   quantize with the same global absmax on both sides, but at another
#   batch the library convs may pick other algorithms, and B1 sums in no
#   fixed order, so a few quantized values flip: on the DSEC step the one
#   device against itself reads 3-4e-2, and on these batches of similar
#   halves the planted faults read 3-6e-2 too, so there only sx and agree
#   tell them apart; on the DDD17 UDA step sound runs read 3.1-3.3e-3 and
#   the gradient faults 3.1-3.8e-2, statistics 3.6-3.9e-4 against 0.68
#   (H100 runs). A per-tensor reading (each tensor's difference over its
#   own largest change, for tensors whose change is at least
#   DP_TENSOR_FLOOR of the largest) is printed beside it; tensors whose
#   exact gradient is 0 (biases before an instance norm) read 1-2 of their
#   own rounding-sized change in sound runs, so it bounds nothing alone.
# And each rank's int8 preps of its rows of a seeded global x (DP_PREPS,
# sample B/2 scaled 16x) equal the two-launch prep of the global x on one
# device bit for bit: scales, weights and the quantized rows.
# The world of one: bit for bit, or within DP_RUN_FACTOR times the two
# one-device runs' difference where they differ.
DP_LOSS_REL = 1e-3
DP_UPDATE_REL = (0.1, 1e-2)     # the DSEC step, the DDD17 UDA step
DP_TENSOR_FLOOR = 0.1
DP_RUN_FACTOR = 2
DP_TIMED = 3                 # timed train steps after the compared one
# (kind, (B, H, W, C_in, C_out or hidden)) at the DSEC B=8: the level-0
# and level-2 cells, the head and first encoder block convs
DP_PREPS = [("cell", (8, 220, 320, 64, 64)), ("cell", (8, 55, 80, 256, 256)),
            ("conv", (8, 220, 320, 20, 128)),
            ("conv", (8, 220, 320, 128, 64))]
DP_FAULTS = ("rank_absmax", "rank_sums", "no_gradient_average")


@contextlib.contextmanager
def tapped_preps(rows: list):
    """Wrap the int8 preps of the cells and the block convs: each call
    appends (the largest |x| of this process's rows, the s_x the prep
    formed) as a device pair, read after the run."""
    saved = conv_lstm.int8_prep, conv3x3.int8_prep

    def tap(prep):
        def tapped(x, *args):
            out = prep(x, *args)
            rows.append(torch.stack([torch.maximum(-x.amin(), x.amax())
                                     .float(), out[0][0]]))
            return out
        return tapped

    conv_lstm.int8_prep, conv3x3.int8_prep = map(tap, saved)
    try:
        yield
    finally:
        conv_lstm.int8_prep, conv3x3.int8_prep = saved


@contextlib.contextmanager
def dp_fault(name: str):
    """Plant one data-parallel fault in this process for the block:
    ``rank_absmax`` the int8 preps' x absmax over this rank's rows alone,
    ``rank_sums`` the losses' and batch norms' sums over this rank's rows
    alone, ``no_gradient_average`` each rank stepping with its own
    gradient."""
    from ess_tpu_torch.parallel import dp

    saved = [(m, k, getattr(m, k)) for m, k in (
        (conv_lstm, "global_partials"), (conv3x3, "global_partials"),
        (dp, "all_sum"), (dp, "average_gradients"))]
    if name == "rank_absmax":
        conv_lstm.global_partials = conv3x3.global_partials = \
            lambda *args: 0
    elif name == "rank_sums":
        dp.all_sum = lambda x: x
    elif name == "no_gradient_average":
        dp.average_gradients = list
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def dp_prep_x(kind: str, shape, seed: int) -> tuple:
    """A seeded global x of a DP_PREPS case on the card, sample B/2 scaled
    16x, and ``rows -> the prep of x[rows]`` with its output names."""
    b, h, w, cin, cout = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl_ = torch.channels_last
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = rnd(b, cin, h, w).to(torch.bfloat16).contiguous(memory_format=cl_)
    x[b // 2] *= 16
    if kind == "cell":
        hp = torch.tanh(rnd(b, cout, h, w)).to(torch.bfloat16).contiguous(
            memory_format=cl_)
        prep = conv_lstm.prepare_gate_weights(
            rnd(4 * cout, cin + cout, 3, 3) * 0.05, torch.float32)
        return (lambda rows: conv_lstm.int8_prep(x[rows], hp[rows], prep),
                ("scal", "w_img", "ws", "xq", "hq"))
    prep = conv3x3.prepare_conv_weights(
        rnd(cout, cin, 3, 3) * (9 * cin) ** -0.5, int8=True)
    return (lambda rows: conv3x3.int8_prep(x[rows], prep),
            ("scal", "wq", "ws"))


def dp_rank(specs: list, faults: tuple) -> dict:
    """What each of phase 5h's gloo ranks runs: its int8 preps of its rows
    of each DP_PREPS x, each spec through ``parallel.steps.run_steps``
    with the int8 preps tapped, then each spec once more (no timed steps)
    under each planted fault."""
    from ess_tpu_torch.parallel import dp

    preps = []
    for i, (kind, shape) in enumerate(DP_PREPS):
        run, _ = dp_prep_x(kind, shape, 40 + i)
        preps.append([t.cpu() for t in run(slice(*dp.row_range(shape[0])))])
    out = {"preps": preps, "specs": [dp_tapped_run(sp) for sp in specs],
           "faults": {}}
    for name in faults:
        with dp_fault(name):
            out["faults"][name] = [dp_tapped_run(dict(sp, timed=0))
                                   for sp in specs]
    return out


def dp_tapped_run(spec: dict) -> dict:
    from ess_tpu_torch.parallel import steps

    rows = []
    with tapped_preps(rows):
        res = steps.run_steps(spec)
    res["preps"] = torch.stack(rows).cpu() if rows else torch.zeros(0, 2)
    return res


def dp_errors(ranks: list, ref: dict) -> dict:
    """The checks of the ranks' results of one spec against the one-device
    ``ref`` (the block comment above): ``loss``; ``update`` over the
    trainable parameters and ``stats`` over the batch-norm running
    statistics, each tensor's difference over the largest change the
    reference step made in its group; ``tensor`` and ``worst`` (the three
    parameters of the largest difference over their own change, with
    their change's share of the largest); ``params`` (absolute, every
    tensor); ``agree``, ``sx`` and ``sx_one`` (the largest relative
    difference of the ranks' s_x from the one-device run's), with
    ``sx_ratio``: rank 1's |x| maximum over rank 0's at the first call."""
    err = {"loss": 0.0, "update": 0.0, "stats": 0.0, "tensor": 0.0,
           "params": 0.0}
    for res in ranks:
        for got, want in zip(res["train"], ref["train"]):
            for k, v in want.items():
                err["loss"] = max(err["loss"],
                                  abs(got[k] - v) / max(abs(v), 1e-30))
    changes = {(name, k): float((v.double() - ref["state0"][name][k].double()
                                 ).abs().max())
               for name, sd in ref["state"].items() if name in ref["state0"]
               for k, v in sd.items() if v.is_floating_point()}
    group = lambda key: "stats" if "running_" in key[1] else "update"
    largest = {g: max([c for key, c in changes.items() if group(key) == g]
                      + [1e-30]) for g in ("update", "stats")}
    per_tensor = {}
    for res in ranks:
        for name, sd in ref["state"].items():
            for k, v in sd.items():
                d = float((res["state"][name][k].double() - v.double()
                           ).abs().max())
                err["params"] = max(err["params"], d)
                if (name, k) not in changes:
                    continue
                g = group((name, k))
                err[g] = max(err[g], d / largest[g])
                if g == "update":
                    own = max(changes[(name, k)], 1e-30)
                    per_tensor[(name, k)] = max(
                        per_tensor.get((name, k), 0.0), d / own)
                    if changes[(name, k)] >= DP_TENSOR_FLOOR * largest[g]:
                        err["tensor"] = max(err["tensor"], d / own)
    err["worst"] = [(f"{key[0]}.{key[1]}", e,
                     changes[key] / largest["update"])
                    for key, e in sorted(per_tensor.items(),
                                         key=lambda kv: -kv[1])[:3]]
    first = ranks[0]
    err["agree"] = all(
        r["train"] == first["train"] and all(
            torch.equal(v, first["state"][n][k])
            for n, sd in r["state"].items() for k, v in sd.items())
        for r in ranks[1:])
    if "preps" not in first:
        return dict(err, sx=None, sx_one=None, sx_ratio=None)
    amax = torch.stack([r["preps"][:, 0] for r in ranks])
    want = conv_lstm._div127(torch.clamp(amax.max(0).values, min=1e-8))
    err["sx"] = len(want) > 0 and all(
        torch.equal(r["preps"][:, 1], want) for r in ranks)
    err["sx_one"] = (float(((want - ref["preps"][:, 1]).abs()
                            / ref["preps"][:, 1]).max())
                     if len(ref.get("preps", [])) == len(want) else None)
    err["sx_ratio"] = (float(amax[1, 0] / amax[0, 0]) if len(want)
                       else None)
    return err


def dp_caught(err: dict, update_rel: float) -> list:
    """The checks that ``err`` fails, the update held to ``update_rel``."""
    return [name for name, ok in (
        ("sx", err["sx"]), ("agree", err["agree"]),
        ("loss", err["loss"] <= DP_LOSS_REL),
        ("update", err["update"] <= update_rel),
        ("stats", err["stats"] <= update_rel)) if not ok]


def dp_cli(cli_train, yaml_path: str, n: int) -> dict:
    """One train CLI run with ``--num_devices n`` in this process: its
    train steps' losses and launches, ms a step, peak memory and final
    head."""
    from ess_tpu_torch.core.config import load_config
    from ess_tpu_torch.io import timers

    calls = []
    timers.reset_timers()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with tapped_steps(calls):
        text = quiet(cli_train.main, ["--settings_file", yaml_path,
                                      "--num_devices", str(n)])
    counts = read_counts()
    step_s = list(timers._ACCUM["train_step"])
    timers.reset_timers()
    log_dir = load_config(yaml_path).log_dir
    (run,) = os.listdir(log_dir)
    head = torch.load(os.path.join(log_dir, run, "checkpoints",
                                   str(CLI_EPOCHS - 1), "state.pt"),
                      weights_only=True)["head"]
    return {"calls": calls, "counts": counts, "text": text, "head": head,
            "losses": [c[2] for c in calls if c[0] == "train"],
            "ms": 1e3 * statistics.median(step_s),
            "peak": torch.cuda.max_memory_allocated()}


def logged_losses(log_root: str) -> list:
    """The ``train/loss`` lines of the one run under ``log_root``."""
    (run,) = os.listdir(log_root)
    with open(os.path.join(log_root, run, "metrics.jsonl")) as f:
        return [r["train/loss"] for r in map(json.loads, f)
                if "train/loss" in r]


def run_difference(a: dict, b: dict) -> tuple:
    """(largest loss difference, largest head difference) of two runs."""
    dl = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    dh = max(float((a["head"][k].double() - v.double()).abs().max())
             for k, v in b["head"].items())
    return dl, dh


def rank_counts(launches: dict) -> tuple:
    """``parallel.steps.launch_counts`` in KERNEL_NAMES order."""
    return all_counts([launches[k] for k in (
        "voxel_folded", "conv_lstm", "conv_lstm_int8", "voxel_tiled",
        "conv3x3", "conv3x3_int8")])


def dp_rows(b: int, r: int) -> tuple:
    """Rank ``r``'s rows of a global batch of ``b`` over two ranks."""
    from ess_tpu_torch.parallel import dp

    return dp.row_range(b, r, 2)


def show_worst(worst: list) -> str:
    return ", ".join(f"{t} {e:.3g} (its update {s:.2g} of the largest)"
                     for t, e, s in worst)


def phase_dp(dev, kern_rows, tmp: str, cli_run: dict) -> None:
    """Phase 5h: data parallel (module docstring); ``cli_run`` is phase
    5d's one-device train CLI run on its tree."""
    import yaml

    from ess_tpu_torch.cli import train as cli_train
    from ess_tpu_torch.parallel import launch, steps

    t_phase = time.perf_counter()
    card = bench.card()
    b, win = DDD17_B, DDD17_B * WINDOWS
    per_call = (1, 3 * WINDOWS)
    n_train = CLI_EPOCHS * CLI_STEPS
    yamls = {}
    for name in ("one", "world1", "torchrun"):
        with open(cli_run["yaml"]) as f:
            raw = yaml.safe_load(f)
        raw["dir"]["log"] = os.path.join(tmp, f"dp_{name}")
        yamls[name] = os.path.join(tmp, f"dp_{name}.yaml")
        with open(yamls[name], "w") as f:
            yaml.safe_dump(raw, f)

    # --- 1. a world of one on NCCL against one device ---
    runs = {"5d": {"losses": cli_run["losses"], "head": torch.load(
        os.path.join(cli_run["run"], "checkpoints", str(CLI_EPOCHS - 1),
                     "state.pt"), weights_only=True)["head"]}}
    runs["one"] = dp_cli(cli_train, yamls["one"], 0)
    runs["world1"] = dp_cli(cli_train, yamls["world1"], 1)
    need_calls(runs["world1"]["calls"], "train", n_train, per_call)
    need_calls(runs["world1"]["calls"], "eval", CLI_EPOCHS + 1, per_call)
    add_launches(kern_rows, "dp_cli_world1", runs["world1"]["counts"])
    d00 = run_difference(runs["5d"], runs["one"])
    d01 = run_difference(runs["world1"], runs["one"])
    d01b = run_difference(runs["world1"], runs["5d"])
    exact = d01 == d01b == (0.0, 0.0)
    for name in ("one", "world1"):
        r = runs[name]
        log(f"  train CLI --num_devices {0 if name == 'one' else 1}: "
            f"losses {r['losses']}; {r['ms']:.1f} ms a step in the "
            f"Trainer, {win / (r['ms'] / 1e3):.2f} windows/s, peak "
            f"{r['peak'] / 2 ** 30:.2f} GiB, launches "
            f"{show_counts(r['counts'])}; {card}")
    log(f"  world of one vs one device: max |d loss| {d01[0]:.3e} / "
        f"{d01b[0]:.3e}, head {d01[1]:.3e} / {d01b[1]:.3e} (against this "
        f"phase's and phase 5d's one-device runs); the two one-device runs "
        f"differ by {d00[0]:.3e} (loss) and {d00[1]:.3e} (head)")
    if not (exact or (d01[0] <= DP_RUN_FACTOR * d00[0]
                      and d01[1] <= DP_RUN_FACTOR * d00[1])):
        raise AssertionError("--num_devices 1 disagrees with --num_devices "
                             "0 beyond the one-device runs' own difference")
    if printed_summary(runs["world1"]["text"]) != \
            printed_summary(runs["one"]["text"]):
        raise AssertionError("--num_devices 1 printed another summary")

    # the same run under torchrun: one process that joins torchrun's group
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "ess_tpu_torch.cli.train",
         "--settings_file", yamls["torchrun"], "--num_devices", "-1"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    got, want = (logged_losses(os.path.join(tmp, f"dp_{name}"))
                 for name in ("torchrun", "one"))
    log(f"  torchrun --nproc_per_node 1 -m ess_tpu_torch.cli.train "
        f"--num_devices -1: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; summary "
        f"{printed_summary(proc.stdout)}; logged losses {got} (one device "
        f"{want})")
    if (proc.returncode or got != want or printed_summary(proc.stdout)
            != printed_summary(runs["one"]["text"])):
        raise AssertionError(f"the train CLI under torchrun disagrees with "
                             f"one device:\n{proc.stderr[-3000:]}")
    del runs
    torch.cuda.empty_cache()

    # --- 2. two gloo ranks on this card against one device ---
    n_ex_s, n_i8_s = int8_cells(8, SENSOR_H - CROP, SENSOR_W)
    n_ex_u, n_i8_u = int8_cells(DDD17_B, *bench.DDD17_CROP)
    host_s = {k: v.numpy() for k, v in
              make_batch(21, 8, "cpu", ignore_rows=20, pile=4).items()}
    host_u = {k: v.numpy() for k, v in bench.make_ddd17_batch(
        22, DDD17_B, "cpu", uda_=True, pile=DDD17_B // 2).items()}
    paths = []
    for name, host in (("dsec_sup", host_s), ("ddd17_uda", host_u)):
        paths.append(os.path.join(tmp, f"dp_{name}.npz"))
        np.savez(paths[-1], **host)
    del host_s, host_u
    pipe = bench.make_pipeline().cfg
    specs = [{"cfg": bench.make_cfg(8), "pipeline_train": pipe,
              "pipeline_val": pipe, "train": [paths[0]],
              "timed": DP_TIMED, "device": str(dev)},
             {"cfg": bench.make_ddd17_cfg("ess", DDD17_B),
              "train": [paths[1]], "timed": DP_TIMED, "device": str(dev)}]
    wants = [(1, n_ex_s * WINDOWS, n_i8_s * WINDOWS),
             (1, n_ex_u * WINDOWS, n_i8_u * WINDOWS)]
    one = [dp_tapped_run(sp) for sp in specs]
    again = [steps.run_steps(dict(sp, timed=0)) for sp in specs]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two = launch.spawn(dp_rank, 2, (specs, DP_FAULTS), device=dev,
                       backend="gloo")
    log(f"  two gloo ranks on {dev}: launched, ran the prep checks, both "
        f"specs and {len(DP_FAULTS)} planted faults, and joined in "
        f"{time.perf_counter() - t0:.1f} s")

    # the int8 preps of each rank's rows against one device's of the batch
    for i, (kind, shape) in enumerate(DP_PREPS):
        b = shape[0]
        run, names = dp_prep_x(kind, shape, 40 + i)
        want = [t.cpu() for t in run(slice(0, b))]
        alone = [float(run(slice(*dp_rows(b, r)))[0][0]) for r in (0, 1)]
        for r, res in enumerate(two):
            lo, hi = dp_rows(b, r)
            differ = [n for n, got, w in zip(names, res["preps"][i], want)
                      if not torch.equal(got, w[lo:hi] if n in ("xq", "hq")
                                         else w)]
            if differ:
                raise AssertionError(f"{kind} prep {shape}, rank {r}: "
                                     f"{differ} differ from one device's")
        log(f"  {'B2-int8' if kind == 'cell' else 'B4-int8'} prep, global "
            f"(B, H, W, C_in, C_out) {shape}, rows split over two ranks: "
            f"each rank's {', '.join(names)} equal one device's of the "
            f"whole batch bit for bit (s_x {float(want[0][0]):.6e}); a "
            f"rank-local absmax would give rank 0 s_x {alone[0]:.6e}, "
            f"rank 1 {alone[1]:.6e}")
        if alone[0] == float(want[0][0]):
            raise AssertionError("the prep check's batch does not tell a "
                                 "rank-local absmax from the global one")

    cases = (("DSEC supervised train step", 8),
             ("DDD17 UDA train step", DDD17_B))
    for i, (name, gb) in enumerate(cases):
        ranks = [r["specs"][i] for r in two]
        err = dp_errors(ranks, one[i])
        self_err = dp_errors([again[i]], one[i])
        need_counts(rank_counts(one[i]["launches_train"]), wants[i])
        for r in ranks:
            need_counts(rank_counts(r["launches_train"]), wants[i])
            add_launches(kern_rows, f"dp_gloo_rank{r['rank']}",
                         rank_counts(r["launches_train"]))
        log(f"  {name}, global B={gb} (B={gb // 2} a rank), int8 kernels: "
            f"losses {ranks[0]['train'][0]['loss']:.6f} (2 ranks) vs "
            f"{one[i]['train'][0]['loss']:.6f} (1 device); max relative "
            f"loss difference {err['loss']:.3e} (bound {DP_LOSS_REL}), "
            f"parameters {err['update']:.3e} of the largest update (bound "
            f"{DP_UPDATE_REL[i]}), batch-norm statistics {err['stats']:.3e} "
            f"of their largest change, {err['params']:.3e} absolute, per "
            f"tensor {err['tensor']:.3e} of its own update (parameters of "
            f"at least {DP_TENSOR_FLOOR} of the largest; worst of all "
            f"{show_worst(err['worst'])}); ranks equal bit for bit: "
            f"{err['agree']}; s_x of all {len(ranks[0]['preps'])} int8 "
            f"prep calls a rank the global one bit for bit: {err['sx']} "
            f"(rank 1's |x| max {err['sx_ratio']:.2f}x rank 0's at the "
            f"first call; {err['sx_one']:.3e} from one device's); launches "
            f"a rank {show_counts(rank_counts(ranks[0]['launches_train']))}"
            f" (the int8 rule on the global B={gb}); one device against "
            f"itself: loss {self_err['loss']:.3e}, parameters "
            f"{self_err['update']:.3e} of the largest update, statistics "
            f"{self_err['stats']:.3e}, per tensor "
            f"{self_err['tensor']:.3e} (worst of all "
            f"{show_worst(self_err['worst'])})")
        for who, r in [("1 device", one[i])] + [
                (f"rank {r['rank']}", r) for r in ranks]:
            log(f"    {who}: {r['ms_per_step']:.1f} ms a step, "
                f"{gb * WINDOWS / (r['ms_per_step'] / 1e3):.2f} windows/s "
                f"(global), peak {r['peak_bytes'] / 2 ** 30:.2f} GiB; {card}")
        caught = dp_caught(err, DP_UPDATE_REL[i])
        if caught or not all(np.isfinite(
                [v for r in ranks for v in r["train"][0].values()])):
            raise AssertionError(f"{name}: two ranks disagree with one "
                                 f"device: {caught}")

    # each planted fault fails a check
    for fault in DP_FAULTS:
        for i, (name, _) in enumerate(cases):
            err = dp_errors([r["faults"][fault][i] for r in two], one[i])
            caught = dp_caught(err, DP_UPDATE_REL[i])
            log(f"  planted fault {fault}, {name}: loss {err['loss']:.3e}, "
                f"parameters {err['update']:.3e} of the largest update, "
                f"statistics {err['stats']:.3e}, per tensor "
                f"{err['tensor']:.3e} (worst of all "
                f"{show_worst(err['worst'])}), ranks equal {err['agree']}, "
                f"s_x global {err['sx']}; fails {caught or 'no check'}")
            if not caught:
                raise AssertionError(f"the planted fault {fault} passes "
                                     f"every check of the two ranks ({name})")
    del one, two, again
    torch.cuda.empty_cache()

    # --- 3. --num_devices 2 on NCCL ---
    if torch.cuda.device_count() >= 2:
        with open(cli_run["yaml"]) as f:
            raw = yaml.safe_load(f)
        raw["dir"]["log"] = os.path.join(tmp, "dp_world2")
        path = os.path.join(tmp, "dp_world2.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        text = captured(cli_train.main, ["--settings_file", path,
                                         "--num_devices", "2"])
        if not 0 <= printed_summary(text).get(
                "semseg_sensor_b_mean_iou", -1) <= 100:
            raise AssertionError("--num_devices 2: no summary")
    else:
        log(f"  --num_devices 2 on NCCL did not run: "
            f"{torch.cuda.device_count()} CUDA device on this machine")
        try:
            quiet(cli_train.main, ["--settings_file", yamls["one"],
                                   "--num_devices", "2"])
        except ValueError as e:
            log(f"  --num_devices 2 on one card raises: {e}")
        else:
            raise AssertionError("--num_devices 2 ran on one card")
    log(f"phase 5h took {time.perf_counter() - t_phase:.1f} s")


def phase_options(dev, kern_rows, tmp: str, root: str) -> None:
    """Phase 5g: the YAML's model and event options (module docstring)."""
    t_phase = time.perf_counter()
    option_cli(dev, kern_rows, tmp, root, os.path.join(tmp, "cityscapes"))
    option_dsec(dev, kern_rows, tmp)
    option_stream(dev, kern_rows, tmp)
    option_sanity(dev, kern_rows)
    if "cv2" in sys.modules or "h5py" in sys.modules:
        raise AssertionError("phase 5g imported cv2 or h5py")
    log(f"phase 5g took {time.perf_counter() - t_phase:.1f} s")


def pred_agreement(pred, pred_ref, logits_ref) -> tuple:
    """% of all pixels with the reference's argmax, and % of the pixels
    whose top-2 logit gap in the reference exceeds SLICE_GAP."""
    top2 = logits_ref.float().topk(2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > SLICE_GAP
    same = pred == pred_ref
    return (100.0 * same.float().mean().item(),
            100.0 * same[clear].float().mean().item())


def slice_agreement(what, latent, latent_ref, pred, pred_ref, logits_ref,
                    cm=None, cm_ref=None, *,
                    clear_min: float = SLICE_PRED_AGREE_CLEAR) -> None:
    """Hold one path against a reference path under the slice bounds
    (SLICE_*): the latent, the argmax on all pixels and, at least
    ``clear_min`` %, on the pixels whose top-2 logit gap in the reference
    exceeds SLICE_GAP, and, where given, the share of confusion-matrix
    counts that moved."""
    latent, latent_ref = latent.float(), latent_ref.float()
    rel = ((latent - latent_ref).abs().max() / latent_ref.abs().max()).item()
    agree, agree_clear = pred_agreement(pred, pred_ref, logits_ref)
    msg = (f"  {what}: latent rel max|d| {rel:.3e} (bound {SLICE_LATENT_REL}); "
           f"pred agreement {agree:.3f}% (bound >= {SLICE_PRED_AGREE}%), "
           f"{agree_clear:.3f}% where the top-2 gap exceeds {SLICE_GAP} "
           f"(bound >= {clear_min}%)")
    ok = (rel <= SLICE_LATENT_REL and agree >= SLICE_PRED_AGREE
          and agree_clear >= clear_min)
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


# Phase 10: the dense and in-loop forms. A10's carried rollout: FORMS_A10
# windows at B=8, the drift of the int8 cell's state (B2-int8) from the
# exact cell's (B2) read at the windows of A10_REPORT. The bounds come from
# readings: this phase's first run on the H100 read at most 0.1187 (h)
# and 0.1562 (c, a few bf16 ulps of c's largest values) over 60 windows;
# the CPU test at 128x160 in f32 (tests/test_torch_int8_drift.py) reads
# 0.039 and 0.062.
FORMS_A10 = 60
A10_REPORT = (1, 20, 40, 60)
A10_H_BOUND = 0.2
A10_C_BOUND = 0.3
RECT_TILE_H = 24               # B3's tile height at 5 bins


def form_counts(*, b1: int = 0, b3: int = 0, exact: int = 0,
                int8: int = 0) -> tuple:
    """Launch counts (KERNEL_NAMES order) of one path of phase 10."""
    counts = [0] * len(KERNEL_NAMES)
    counts[0], counts[1], counts[2], counts[3] = b1, exact, int8, b3
    return tuple(counts)


def timed_forms_peak(what: str, calls: dict, windows: int) -> None:
    """Run each of ``calls`` (name -> a synchronized call) alternately,
    twice a turn, and print each one's windows/s and its peak device
    memory (``torch.cuda.max_memory_allocated`` over its own calls)."""
    names = list(calls)
    samples = {n: [] for n in names}
    peaks = {n: 0 for n in names}
    for name in names + names[::-1]:
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            samples[name].append(time.perf_counter() - t0)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
    for name in names:
        med = statistics.median(samples[name])
        log(f"{what} ({name}): {windows / med:.2f} windows/s, median "
            f"{1e3 * med:.1f} ms over {len(samples[name])} calls "
            f"{[round(1e3 * t, 1) for t in samples[name]]}; peak device "
            f"memory {peaks[name] / 2 ** 30:.3f} GiB")


def grid_agreement(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max |a - b| where both normalized grids are nonzero, the cells
    zero in one only): + and - deposits that cancel exactly in one sum
    order leave a residue in another, and the nonzero normalization moves
    such a cell by the grid's mean over its std."""
    both = (a != 0) & (b != 0)
    return (a - b)[both].abs().max().item(), zero_pattern(a, b)


def forms_in_loop(dev, kern_rows) -> None:
    """Phase 10, part 1: the eval and train steps with ``precompute=False``
    (each window voxelized just before its step) against the precomputed
    form on the same batch, on the band wire (B1) and the tile wire (B3)."""
    pipe = bench.make_pipeline()
    mods, _ = bench.build_eval(8, dev)
    evals = {pre: make_eval_step(mods, pipe, precompute=pre)
             for pre in (True, False)}
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    hook = mods.head.register_forward_hook(keep_logits)
    cfg = bench.make_cfg(8)
    trains = {}
    for pre in (True, False):
        mods_t = build_modules(cfg, device=dev)
        init_params(mods_t, torch.Generator().manual_seed(0))
        trains[pre] = (mods_t, builder.init_state(mods_t),
                       make_train_step(mods_t, pipe, precompute=pre))
    batches = {"band": make_batch(11, 8, dev, ignore_rows=20),
               "tile": make_batch(11, 8, dev, ignore_rows=20, wire="tile")}
    for wire, batch in batches.items():
        vox = "b1" if wire == "band" else "b3"
        outs, losses = {}, {}
        for pre in (True, False):
            reset_counts()
            out = evals[pre](batch)
            counts = read_counts()
            need_counts(counts, form_counts(
                exact=3 * WINDOWS, **{vox: 1 if pre else WINDOWS}))
            outs[pre] = (out, logits[0])
            form = "precomputed" if pre else "in-loop"
            log(f"{form} eval step B=8 T={WINDOWS}, {wire} wire: launches "
                f"{show_counts(counts)}, loss {float(out['loss']):.6f}")
            if not pre:
                add_launches(kern_rows, f"in_loop_eval_{wire}", counts)
            mods_t, state, step = trains[pre]
            reset_counts()
            losses[pre] = float(step(state, batch, AugmentParams())["loss"])
            counts = read_counts()
            need_counts(counts, form_counts(
                int8=3 * WINDOWS, **{vox: 1 if pre else WINDOWS}))
            log(f"{form} train step B=8 T={WINDOWS} (int8 cell), {wire} "
                f"wire: launches {show_counts(counts)}, loss "
                f"{losses[pre]:.6f}")
            if not pre:
                add_launches(kern_rows, f"in_loop_train_{wire}", counts)
        (got, _), (ref, ref_logits) = outs[False], outs[True]
        slice_agreement(f"in-loop eval vs precomputed, {wire} wire",
                        got["latent8"], ref["latent8"], got["pred"],
                        ref["pred"], ref_logits, got["cm"], ref["cm"])
        rel = abs(losses[False] - losses[True]) / abs(losses[True])
        # the train rollout's final latent, both forms, the same weights
        recon = trains[True][0].recon_train
        fn = pipe.make_window_fn(AugmentParams(), offsets_kind=(
            "band" if wire == "band" else "tile"))
        lats = []
        with torch.no_grad():
            for _ in range(2):
                windows, _ = pipe.build_all(batch,
                                            out_dtype=recon.model.dtype)
                lats.append(recon.rollout(windows, decode=False)[2][8]
                            .float())
                del windows
            for _ in range(2):
                lats.append(recon.rollout_events(batch, fn, decode=False)[2][8]
                            .float())
        rel_of = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
        lat_rel = rel_of(lats[2], lats[0])
        log(f"  in-loop train step vs precomputed, {wire} wire: loss "
            f"relative difference {rel:.3e} (bound {TRAIN_LOSS_REL}); the "
            f"int8 rollout's latent8 rel max|d| {lat_rel:.3e} (bound "
            f"{TRAIN_LATENT_REL}); spread: precomputed vs precomputed "
            f"{rel_of(lats[1], lats[0]):.3e}, in-loop vs in-loop "
            f"{rel_of(lats[3], lats[2]):.3e}, second in-loop vs first "
            f"precomputed {rel_of(lats[3], lats[0]):.3e}; mean |d| "
            f"{(lats[2] - lats[0]).abs().mean().item():.3e} over mean |x| "
            f"{lats[0].abs().mean().item():.3e}")
        if not (rel <= TRAIN_LOSS_REL and lat_rel <= TRAIN_LATENT_REL):
            raise AssertionError(f"in-loop train step disagrees ({wire})")
    hook.remove()
    batch = batches["band"]
    del batches, outs, got, ref, lats
    calls = {f"{form}, {what}": fn for form, pre in (("precomputed", True),
                                                     ("in-loop", False))
             for what, fn in (
                 ("eval", lambda pre=pre: float(evals[pre](batch)["loss"])),
                 ("train", lambda pre=pre: float(trains[pre][2](
                     trains[pre][1], batch, AugmentParams())["loss"])))}
    timed_forms_peak(f"B=8 T={WINDOWS} band wire", calls, 8 * WINDOWS)
    torch.cuda.empty_cache()


def forms_rectify(dev, kern_rows) -> None:
    """Phase 10, part 2: raw sensor-coordinate windows of phase 9's
    recording rectified on the card (``make_pipeline(rectify_map=)``, B3
    with the tile sort on the card) through the eval step, against the
    host-rectified tile wire of the same events (``ingest_rectify_bin``)."""
    store, rmap, _, _ = make_recording(5)
    b, n = 8, EVENTS
    starts = (np.arange(b)[:, None] * (WINDOWS * n + n)
              + np.arange(WINDOWS)[None] * n)
    ev = {"x": store.x, "y": store.y, "t": store.t, "p": store.p}
    t0 = time.perf_counter()
    host = [native.ingest_rectify_bin(ev, starts[i], starts[i] + n, n, rmap,
                                      tile_h=RECT_TILE_H) for i in range(b)]
    host_ms = 1e3 * (time.perf_counter() - t0) / (b * WINDOWS)
    rng = np.random.default_rng(13)
    label = rng.integers(0, CLASSES, (b, SENSOR_H - CROP, SENSOR_W))
    label[:, -20:] = 255
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    raw = np.stack([h[0] for h in host])
    tile = {"ev_x": raw[..., 0], "ev_y": raw[..., 1], "ev_t": raw[..., 2],
            "ev_p": raw[..., 3], "ev_valid": np.stack([h[1] for h in host]),
            "ev_tile_offsets": np.stack([h[2] for h in host]),
            "label": label}
    tile = {k: to_dev(v) for k, v in tile.items()}
    idx = starts[..., None] + np.arange(n)
    sensor = {"ev_x": store.x[idx].astype(np.float32),
              "ev_y": store.y[idx].astype(np.float32),
              "ev_t": (store.t[idx] - store.t[starts][..., None]).astype(
                  np.float32),
              "ev_p": store.p[idx].astype(np.float32),
              "ev_valid": np.ones(idx.shape, bool), "label": label}
    sensor = {k: to_dev(v) for k, v in sensor.items()}
    del raw, idx
    kept = int(tile["ev_valid"].sum())
    log(f"device rectification: {b} x {WINDOWS} windows of {n} raw "
        f"events at sensor coordinates (window-relative times); the host "
        f"ingest kept {kept} of {b * WINDOWS * n} (the map's image lies in "
        f"the frame), {host_ms:.3f} ms a window on one thread")
    if kept != b * WINDOWS * n:
        raise AssertionError("the host ingest dropped events")
    pipe_host = bench.make_pipeline()
    pipe_dev = builder.make_pipeline(bench.make_cfg(8, None), train=False,
                                     rectify_map=rmap, device=dev)
    if not (pipe_dev.cfg.rectify and pipe_dev.rectify_map.device == dev):
        raise AssertionError("make_pipeline did not keep the map on the "
                             "card")
    mods, _ = bench.build_eval(8, dev)
    steps = {"device rectify, raw wire": (make_eval_step(mods, pipe_dev),
                                          sensor),
             "host rectify, tile wire": (make_eval_step(mods, pipe_host),
                                         tile)}
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    hook = mods.head.register_forward_hook(keep_logits)
    outs = {}
    for name, (step, batch) in steps.items():
        reset_counts()
        out = step(batch)
        counts = read_counts()
        need_counts(counts, form_counts(b3=1, exact=3 * WINDOWS))
        log(f"eval step B=8 T={WINDOWS}, {name}: launches "
            f"{show_counts(counts)}, loss {float(out['loss']):.6f}")
        if name.startswith("device"):
            add_launches(kern_rows, "rectify_eval", counts)
        outs[name] = (out, logits[0])
    hook.remove()
    (got, _), (ref, ref_logits) = outs.values()
    slice_agreement("device rectify vs host rectify, eval step",
                    got["latent8"], ref["latent8"], got["pred"], ref["pred"],
                    ref_logits, got["cm"], ref["cm"])
    with torch.no_grad():
        g_dev, _ = pipe_dev.build_all(sensor)
        g_host, _ = pipe_host.build_all(tile)
        d_host = grid_agreement(g_dev, g_host)
        del g_host
        with plain_versions():
            g_plain, _ = pipe_dev.build_all(sensor)
        d_plain = grid_agreement(g_dev, g_plain)
        del g_dev, g_plain
    log(f"  rectified grids (normalized, 160 windows), max|d| where both "
        f"are nonzero and cells zero in one grid only: B3 vs its plain "
        f"version {d_plain[0]:.3e}, {d_plain[1]}; device vs host "
        f"rectification {d_host[0]:.3e}, {d_host[1]} (bounds {VOXEL_ATOL}, "
        f"{VOXEL_PATTERN_MAX})")
    if not all(e <= VOXEL_ATOL and n <= VOXEL_PATTERN_MAX
               for e, n in (d_plain, d_host)):
        raise AssertionError("rectified grids disagree")
    step_dev = steps["device rectify, raw wire"][0]
    xs = sensor["ev_x"].view(-1)
    ys = sensor["ev_y"].view(-1)
    gather_ms = cuda_ms(lambda: batch_voxel.rectify_events(
        xs, ys, pipe_dev.rectify_map), 5)
    step_ms = cuda_ms(lambda: step_dev(sensor), 2)
    log(f"  the rectify gather of a step ({xs.numel()} events): "
        f"{gather_ms:.3f} ms device time, {100 * gather_ms / step_ms:.2f} % "
        f"of the eval step's {step_ms:.1f} ms ({bench.card()})")
    timed_forms_peak(f"eval step B=8 T={WINDOWS}", {
        name: (lambda st=st, bt=bt: float(st(bt)["loss"]))
        for name, (st, bt) in steps.items()}, 8 * WINDOWS)
    del steps, sensor, tile, outs, got, ref
    torch.cuda.empty_cache()


def forms_dense(dev, kern_rows) -> None:
    """Phase 10, part 3: ``EventPipeline.__call__`` -> the dense
    ``{"events"}`` batch through the eval, train and UDA train steps,
    each against the same steps on the raw wire of the same events."""
    rng = np.random.default_rng(14)
    raw, valid = bench.make_raw(rng, 8)
    label = rng.integers(0, CLASSES, (8, SENSOR_H - CROP, SENSOR_W))
    label[:, -20:] = 255
    raw_t = torch.from_numpy(raw).to(dev)
    soa = {k: raw_t[..., i].contiguous()
           for i, k in enumerate(("ev_x", "ev_y", "ev_t", "ev_p"))}
    soa["ev_valid"] = torch.from_numpy(valid).to(dev)
    soa["label"] = torch.from_numpy(label).to(dev)
    pipe = bench.make_pipeline()
    reset_counts()
    dense = pipe({"raw_events": raw_t, "valid": soa["ev_valid"],
                  "label": soa["label"]})
    counts = read_counts()
    need_counts(counts, form_counts(b3=1))
    add_launches(kern_rows, "dense_build", counts)
    del raw_t
    ev = dense["events"]
    log(f"EventPipeline.__call__: events {tuple(ev.shape)} "
        f"{ev.dtype} ({ev.numel() * 4 / 2 ** 30:.2f} GiB) in one B3 launch")
    if tuple(ev.shape) != (8, WINDOWS, SENSOR_H - CROP, SENSOR_W, BINS):
        raise AssertionError("dense events have the wrong shape")

    mods, step = bench.build_eval(8, dev)
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    hook = mods.head.register_forward_hook(keep_logits)
    outs = {}
    for name, batch, want in (("dense", dense, form_counts(exact=3 * WINDOWS)),
                              ("raw wire", soa, form_counts(
                                  b3=1, exact=3 * WINDOWS))):
        reset_counts()
        outs[name] = (step(batch), logits[0])
        counts = read_counts()
        need_counts(counts, want)
        log(f"eval step B=8 T={WINDOWS}, {name}: launches "
            f"{show_counts(counts)}, loss {float(outs[name][0]['loss']):.6f}")
        if name == "dense":
            add_launches(kern_rows, "dense_eval", counts)
    hook.remove()
    (got, _), (ref, ref_logits) = outs["dense"], outs["raw wire"]
    slice_agreement("dense eval vs raw wire", got["latent8"], ref["latent8"],
                    got["pred"], ref["pred"], ref_logits, got["cm"],
                    ref["cm"])
    timed_forms_peak(f"eval step B=8 T={WINDOWS}", {
        "dense": lambda: float(step(dense)["loss"]),
        "raw wire": lambda: float(step(soa)["loss"])}, 8 * WINDOWS)
    del mods, step, outs, got, ref

    cfg = bench.make_cfg(8)
    losses = {}
    for name, batch, want in (("dense", dense, form_counts(int8=3 * WINDOWS)),
                              ("raw wire", soa, form_counts(
                                  b3=1, int8=3 * WINDOWS))):
        _, state, step = bench.build_train(cfg, dev)
        reset_counts()
        losses[name] = float(step(state, batch, AugmentParams())["loss"])
        counts = read_counts()
        need_counts(counts, want)
        log(f"train step B=8 T={WINDOWS} (int8 cell), {name}: launches "
            f"{show_counts(counts)}, loss {losses[name]:.6f}")
        if name == "dense":
            add_launches(kern_rows, "dense_train", counts)
        del state, step
    rel = abs(losses["dense"] - losses["raw wire"]) / abs(losses["raw wire"])
    log(f"  dense train step vs raw wire: loss relative difference "
        f"{rel:.3e} (bound {TRAIN_LOSS_REL})")
    if not rel <= TRAIN_LOSS_REL:
        raise AssertionError("dense train step disagrees")

    image = {"image_a": torch.from_numpy(rng.normal(
                 size=(8, 1, SENSOR_H - CROP, SENSOR_W)).astype(np.float32)
             ).to(dev), "label_a": soa["label"]}
    n_exact, n_int8 = int8_cells(8, SENSOR_H - CROP, SENSOR_W)
    uda_out = {}
    for name, batch, b3 in (("dense", {"events_b": ev, **image}, 0),
                            ("raw wire", {**{k: v for k, v in soa.items()
                                             if k.startswith("ev_")},
                                          **image}, 1)):
        _, state, step = bench.build_uda(bench.make_uda_cfg(8), dev)
        reset_counts()
        uda_out[name] = {k: float(v) for k, v in step(state, batch).items()}
        counts = read_counts()
        need_counts(counts, form_counts(b3=b3, exact=n_exact * WINDOWS,
                                        int8=n_int8 * WINDOWS))
        log(f"UDA train step B=8 T={WINDOWS}, {name}: launches "
            f"{show_counts(counts)}, loss {uda_out[name]['loss']:.6f}")
        if name == "dense":
            add_launches(kern_rows, "dense_uda_train", counts)
        del state, step
    rels = {k: abs(uda_out["dense"][k] - v) / max(abs(v), 1e-12)
            for k, v in uda_out["raw wire"].items()}
    log("  dense UDA train step vs raw wire, relative difference: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rels.items()))
        + f" (bound on loss {TRAIN_LOSS_REL})")
    if not (sorted(uda_out["dense"]) == UDA_LOSS_KEYS
            and rels["loss"] <= TRAIN_LOSS_REL):
        raise AssertionError("dense UDA train step disagrees")
    del dense, ev, soa, image
    torch.cuda.empty_cache()


def moving_bars(seed: int, b: int, t_dim: int, n: int, dev) -> dict:
    """(B, T, N) raw event columns on the card, made there: 80 % on the
    leading (positive) and trailing (negative) edges of six bars moving
    across the 480x640 frame, 20 % uniform noise; 1/64-pixel lattice
    coordinates in the frame, sorted window-relative times (as
    tests/test_torch_int8_drift.py makes them at 128x160)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    k, shape = 6, (b, t_dim, n)
    y0, x0 = u(b, k) * (SENSOR_H - 80), u(b, k) * (SENSOR_W - 80)
    bh, bw = 20 + 60 * u(b, k), 20 + 60 * u(b, k)
    vx, vy = 6 * (u(b, k) - 0.5), 2 * (u(b, k) - 0.5)
    pick = (u(*shape) * k).long().view(b, -1)
    at = lambda v: torch.gather(v, 1, pick).view(shape)
    tau = u(*shape).sort(-1).values
    lead = u(*shape) < 0.5
    step = torch.arange(t_dim, device=dev).view(1, -1, 1) + tau
    x = at(x0) + at(bw) * lead + at(vx) * step
    y = at(y0) + u(*shape) * at(bh) + at(vy) * step
    noise = u(*shape) < 0.2
    x = torch.where(noise, u(*shape) * SENSOR_W, torch.remainder(x, SENSOR_W))
    y = torch.where(noise, u(*shape) * SENSOR_H, torch.remainder(y, SENSOR_H))
    lattice = lambda v, hi: torch.clamp(torch.round(v * 64) / 64, 0, hi - 1)
    return {"ev_x": lattice(x, SENSOR_W), "ev_y": lattice(y, SENSOR_H),
            "ev_t": tau * 5e4,
            "ev_p": torch.where(noise, u(*shape) < 0.5, lead).float(),
            "ev_valid": torch.ones(shape, dtype=torch.bool, device=dev)}


def forms_a10(dev, kern_rows) -> None:
    """Phase 10, part 4: A10 on the card, ``rollout_events`` over
    FORMS_A10 carried windows at B=8 on the exact cell (B2) and on the
    int8 cell (B2-int8), one window a call with the state carried in."""
    soa = moving_bars(15, 8, FORMS_A10, EVENTS, dev)
    mods = build_modules(bench.make_cfg(8), device=dev)
    init_params(mods, torch.Generator().manual_seed(0))
    fn = bench.make_pipeline().make_window_fn(AugmentParams())
    n_exact, n_int8 = int8_cells(8, SENSOR_H - CROP, SENSOR_W)
    if n_int8 != 3:
        raise AssertionError("the int8 rule leaves a cell exact at B=8")
    states = {"exact": mods.recon_val.init_state(8, dev),
              "int8": mods.recon_train.init_state(8, dev)}
    drifts = []
    reset_counts()
    with torch.no_grad():
        for i in range(FORMS_A10):
            one = {k: v[:, i:i + 1] for k, v in soa.items()}
            for name, recon in (("exact", mods.recon_val),
                                ("int8", mods.recon_train)):
                states[name] = recon.rollout_events(
                    one, fn, states[name], decode=False)[1]
            pairs = list(zip(states["int8"], states["exact"]))
            drifts.append(tuple(
                max((a[j].float() - b[j].float()).abs().max().item()
                    for a, b in pairs) for j in (0, 1)))
    counts = read_counts()
    need_counts(counts, form_counts(b3=2 * FORMS_A10, exact=3 * FORMS_A10,
                                    int8=3 * FORMS_A10))
    add_launches(kern_rows, "a10_rollout", counts)
    finite = all(torch.isfinite(t.float()).all()
                 for st in states.values() for lvl in st for t in lvl)
    for w in A10_REPORT:
        dh, dc = drifts[w - 1]
        log(f"A10 drift, window {w} of {FORMS_A10} (B=8, 440x640, bf16, "
            f"int8 cell vs exact cell, max over the three levels): max|dh| "
            f"{dh:.4f}, max|dc| {dc:.4f}")
    h_max = max(d[0] for d in drifts)
    c_max = max(d[1] for d in drifts)
    log(f"A10 drift over all {FORMS_A10} windows: max|dh| {h_max:.4f} "
        f"(bound {A10_H_BOUND}), max|dc| {c_max:.4f} (bound {A10_C_BOUND});"
        f" launches {show_counts(counts)} ({bench.card()})")
    if not (finite and h_max <= A10_H_BOUND and c_max <= A10_C_BOUND
            and min(d[0] for d in drifts) > 0):
        raise AssertionError("A10: the int8 rollout drifts past its bound")
    del soa, states
    torch.cuda.empty_cache()


def phase_forms(dev, kern_rows) -> None:
    """Phase 10: the dense and in-loop forms of the steps (module
    docstring)."""
    t_phase = time.perf_counter()
    forms_in_loop(dev, kern_rows)
    forms_rectify(dev, kern_rows)
    forms_dense(dev, kern_rows)
    forms_a10(dev, kern_rows)
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")


# Phase 11: the voxelizer pins at the bench shape. The stack and raw forms
# build the standard windows bit for bit (the same cells, normalized in f32
# and cast last, in the same memory layout), so their steps' outputs equal
# the default's bit for bit. The int8 planes move each corner weight by up
# to ~1/127 (the JAX package's int8 path), a quantization of the input as
# the packed wire's 1/64-px coordinates are: the eval step is held to the
# slice bounds against the default but for the argmax where the top-2 gap
# exceeds SLICE_GAP, held to the packed wire's PACKED_PRED_AGREE_CLEAR
# (98.89 % read on NVIDIA H100 80GB HBM3 at 700 W, the packed wire
# 98.30-98.35 %; PERF.md); the train steps' losses to TRAIN_LOSS_REL; the
# int8 train rollout's latent8 is reported (any input change moves it by
# ~10 % on seeded weights, PERF.md). The s2d branch (``windows_s2d``) is
# held to the slice bounds and its bits reported. DDD17's raw form (the
# width resize on the raw accumulator) is held to phase 5c's bounds
# against its default.
PIN_PIPES = {"default": {}, "stack": {"stack_windows": True},
             "raw": {"raw_windows": True}, "int8": {"voxel_oh_dtype": "int8"}}
PIN_VOXELIZER = {"default": "B1", "stack": "B1-stack", "raw": "B1-raw",
                 "int8": "B1-int8", "s2d": "B1"}


def pin_pipeline(base, form: str):
    """``base`` with the pipeline pin of ``form`` (PIN_PIPES) set."""
    changes = PIN_PIPES.get(form, {})
    return (EventPipeline(dataclasses.replace(base.cfg, **changes),
                          base.rectify_map) if changes else base)


def legacy_batch(seed: int, b: int, dev) -> dict:
    """``bench.make_batch``'s events binned on the full-width band wire
    (B3-legacy: one record group a band, ``x_slots=False``)."""
    rng = np.random.default_rng(seed)
    raw, valid = make_raw(rng, b)
    recs, vals, offs = zip(*(voxel_folded.host_band_bin_folded(
        raw[i], valid[i], height=SENSOR_H, width=SENSOR_W, bins=BINS,
        x_slots=False) for i in range(b)))
    cap = max(r.shape[1] for r in recs)
    pad = lambda a: np.pad(a, [(0, 0), (0, cap - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2))
    recs = np.stack([pad(r) for r in recs])
    host = {"ev_x": recs[..., 0], "ev_y": recs[..., 1], "ev_t": recs[..., 2],
            "ev_p": recs[..., 3], "ev_valid": np.stack([pad(v) for v in vals]),
            "ev_band_offsets": np.stack(offs),
            "label": rng.integers(0, CLASSES, (b, SENSOR_H - CROP,
                                               SENSOR_W))}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in host.items()}


def pins_steps(dev, kern_rows) -> None:
    """Phase 11, part 1: the DSEC eval step (exact cell) and train step
    (int8 cell, flips) at B=8 on each form, against the default on one
    batch and one set of draws; the eval step on the full-width band wire
    with raw windows and the int8 planes (B3-legacy's forms); the UDA
    train step at B=2 with raw windows; each form's windows/s and peak
    memory, alternated."""
    from ess_tpu_torch.train import supervised

    base = bench.make_pipeline()
    forms = {f: (pin_pipeline(base, f), f == "s2d")
             for f in ("default", "stack", "raw", "int8", "s2d")}
    batch = make_batch(23, 8, dev, ignore_rows=20)
    flips = AugmentParams(flip=torch.arange(8) % 2 == 0)
    mods, _ = bench.build_eval(8, dev)
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    hook = mods.head.register_forward_hook(keep_logits)
    evals = {f: make_eval_step(mods, p, windows_s2d=s2d)
             for f, (p, s2d) in forms.items()}
    outs = {}
    for f, step in evals.items():
        pipe, s2d = forms[f]
        branch = supervised.rollout_form(mods.recon_val, batch, pipe,
                                         train=False, windows_s2d=s2d)
        reset_counts()
        out = step(batch)
        counts = read_counts()
        log(f"pins eval step B=8 T={WINDOWS} ({f}, branch {branch}): "
            f"launches {show_counts(counts)}, loss {float(out['loss']):.6f}")
        need_counts(counts, by_name({PIN_VOXELIZER[f]: 1,
                                     "B2": 3 * WINDOWS}))
        if branch != {"default": "standard", "int8": "standard"}.get(f, f):
            raise AssertionError(f"eval ({f}) took the {branch} branch")
        add_launches(kern_rows, f"pins_eval_{f}", counts)
        outs[f] = (out, logits[0])
    ref, ref_logits = outs["default"]
    for f in ("stack", "raw", "s2d"):
        got = outs[f][0]
        diff = {k: same_bits(got[k], ref[k])
                for k in ("loss", "latent8", "pred", "cm", "img_fake")}
        log(f"  eval, {f} vs default: elements that differ "
            + ", ".join(f"{k} {n}" for k, n in diff.items()))
        if f != "s2d" and any(diff.values()):
            raise AssertionError(f"eval ({f}) differs from the default")
        if f == "s2d":
            slice_agreement("eval, s2d vs default", got["latent8"],
                            ref["latent8"], got["pred"], ref["pred"],
                            ref_logits, got["cm"], ref["cm"])
    got = outs["int8"][0]
    slice_agreement("eval, int8 planes vs default", got["latent8"],
                    ref["latent8"], got["pred"], ref["pred"], ref_logits,
                    got["cm"], ref["cm"], clear_min=PACKED_PRED_AGREE_CLEAR)
    del outs, got, ref, ref_logits

    # the full-width band wire (B3-legacy): raw windows and the int8 planes
    legacy = legacy_batch(23, 8, dev)
    outs = {}
    for f in ("default", "raw", "int8"):
        reset_counts()
        out = make_eval_step(mods, forms[f][0])(legacy)
        counts = read_counts()
        name = "B3-legacy" + ("" if f == "default" else f"-{f}")
        log(f"pins eval step B=8 T={WINDOWS}, full-width band wire ({f}): "
            f"launches {show_counts(counts)}")
        need_counts(counts, by_name({name: 1, "B2": 3 * WINDOWS}))
        add_launches(kern_rows, f"pins_eval_legacy_{f}", counts)
        outs[f] = (out, logits[0])
    hook.remove()
    ref, ref_logits = outs["default"]
    diff = {k: same_bits(outs["raw"][0][k], ref[k])
            for k in ("loss", "latent8", "pred", "cm", "img_fake")}
    log("  eval, full-width bands, raw vs default: elements that differ "
        + ", ".join(f"{k} {n}" for k, n in diff.items()))
    if any(diff.values()):
        raise AssertionError("eval (full-width bands, raw) differs")
    got = outs["int8"][0]
    slice_agreement("eval, full-width bands, int8 planes vs default",
                    got["latent8"], ref["latent8"], got["pred"], ref["pred"],
                    ref_logits, got["cm"], ref["cm"],
                    clear_min=PACKED_PRED_AGREE_CLEAR)
    del outs, got, ref, ref_logits, legacy

    cfg = bench.make_cfg(8)
    trains, results = {}, {}
    for f, (pipe, s2d) in forms.items():
        mods_t = build_modules(cfg, device=dev)
        init_params(mods_t, torch.Generator().manual_seed(0))
        state = builder.init_state(mods_t)
        trains[f] = (state, make_train_step(mods_t, pipe, windows_s2d=s2d))
        seen = {}

        def keep_latent(mod, args, seen=seen):
            seen.setdefault("latent8", args[0][8].clone())

        hook = state.head.register_forward_pre_hook(keep_latent)
        before = [p.detach().clone() for p in state.head.parameters()]
        reset_counts()
        loss = trains[f][1](state, batch, flips)["loss"]
        counts = read_counts()
        hook.remove()
        update = torch.cat([(p.detach() - q).reshape(-1).float() for p, q in
                            zip(state.head.parameters(), before)])
        log(f"pins train step B=8 T={WINDOWS} (int8 cell, flips; {f}): "
            f"launches {show_counts(counts)}, loss {float(loss):.6f}")
        need_counts(counts, by_name({PIN_VOXELIZER[f]: 1,
                                     "B2-int8": 3 * WINDOWS}))
        add_launches(kern_rows, f"pins_train_{f}", counts)
        results[f] = (loss, seen["latent8"], update)
    l0, z0, u0 = results["default"]
    for f in ("stack", "raw", "s2d", "int8"):
        loss, lat, upd = results[f]
        diff = {"loss": same_bits(loss, l0), "latent8": same_bits(lat, z0),
                "head update": same_bits(upd, u0)}
        rel = abs(float(loss) - float(l0)) / abs(float(l0))
        lat_rel = ((lat.float() - z0.float()).abs().max()
                   / z0.float().abs().max()).item()
        log(f"  train, {f} vs default: elements that differ "
            + ", ".join(f"{k} {n}" for k, n in diff.items())
            + f"; loss relative difference {rel:.3e} (bound "
            f"{TRAIN_LOSS_REL}), latent8 rel max|d| {lat_rel:.3e}")
        if f in ("stack", "raw") and any(diff.values()):
            raise AssertionError(f"train ({f}) differs from the default")
        if not rel <= TRAIN_LOSS_REL:
            raise AssertionError(f"train ({f}) loss moved by {rel:.3e}")
    del results

    # the UDA train step with raw windows (the UDA ladder's rung)
    b = 2
    cfg_u = bench.make_uda_cfg(b)
    uda_batch = bench.make_uda_batch(3, b, dev, ignore_rows=20)
    n_exact, n_int8 = int8_cells(b, SENSOR_H - CROP, SENSOR_W)
    losses = {}
    for f in ("default", "raw"):
        mods_u = build_modules(cfg_u, device=dev)
        init_params(mods_u, torch.Generator().manual_seed(0))
        step = uda.make_train_step(mods_u, pin_pipeline(base, f))
        reset_counts()
        losses[f] = step(builder.init_state(mods_u), uda_batch)
        counts = read_counts()
        log(f"pins UDA train step B={b} ({f}): launches "
            f"{show_counts(counts)}")
        need_counts(counts, by_name({PIN_VOXELIZER[f]: 1,
                                     "B2": n_exact * WINDOWS,
                                     "B2-int8": n_int8 * WINDOWS}))
        add_launches(kern_rows, f"pins_uda_{f}", counts)
    diff = {k: same_bits(v, losses["default"][k])
            for k, v in losses["raw"].items()}
    log("  UDA train, raw vs default: losses that differ "
        f"{sum(1 for n in diff.values() if n)} of {len(diff)}; total loss "
        f"{float(losses['raw']['loss']):.6f}")
    if any(diff.values()):
        raise AssertionError("UDA train (raw) differs from the default")
    del losses

    calls = {}
    for f in forms:
        calls[f"eval {f}"] = lambda f=f: float(evals[f](batch)["loss"])
        calls[f"train {f}"] = lambda f=f: float(trains[f][1](
            trains[f][0], batch, flips)["loss"])
    timed_forms_peak(f"pins B=8 T={WINDOWS} band wire", calls, 8 * WINDOWS)
    del calls, evals, trains, mods
    torch.cuda.empty_cache()


def pins_ddd17(dev, kern_rows) -> None:
    """Phase 11, part 2: the DDD17 supervised train step (B=16, the width
    resize folded onto the raw accumulator) with raw windows against its
    default on one batch and the same draws (phase 5c's bounds), and the
    raw form's windows against the default's."""
    from ess_tpu_torch.ops.conv_s2d import space_to_depth
    from ess_tpu_torch.train import supervised

    b = DDD17_B
    batch = bench.make_ddd17_batch(3, b, dev)
    cfg = bench.make_ddd17_cfg("ess_supervised", b, "pallas_int8")
    base = builder.make_pipeline(cfg)
    n_exact, n_int8 = int8_cells(b, *bench.DDD17_RESIZED)
    res = {}
    for f in ("default", "raw"):
        pipe = pin_pipeline(base, f)
        mods = build_modules(cfg, device=dev)
        init_params(mods, torch.Generator().manual_seed(0))
        branch = supervised.rollout_form(mods.recon_train, batch, pipe,
                                         train=True)
        step = make_train_step(mods, pipe)
        reset_counts()
        loss = float(step(builder.init_state(mods), batch)["loss"])
        counts = read_counts()
        log(f"pins DDD17 supervised train step B={b} ({f}, branch {branch})"
            f": launches {show_counts(counts)}, loss {loss:.6f}")
        need_counts(counts, by_name({PIN_VOXELIZER[f]: 1,
                                     "B2": n_exact * WINDOWS,
                                     "B2-int8": n_int8 * WINDOWS}))
        if branch != ("raw" if f == "raw" else "standard"):
            raise AssertionError(f"DDD17 train ({f}) took {branch}")
        add_launches(kern_rows, f"pins_ddd17_train_{f}", counts)
        res[f] = (loss, mods, pipe)
    rel = abs(res["raw"][0] - res["default"][0]) / abs(res["default"][0])
    aug = draw_augment(res["raw"][2], cfg.seed, 0, b)    # the steps' draws
    with torch.no_grad():
        built, _, window_map = res["raw"][2].build_all_raw(batch, aug=aug)
        got = torch.stack([window_map(built["raw"][i], None)
                           for i in range(WINDOWS)])
        std, _ = base.build_all(batch, aug=aug)
        want = torch.stack([space_to_depth(w) for w in std])
    d = (got - want).abs().max().item()
    log(f"  DDD17 raw vs default: loss relative difference {rel:.3e} "
        f"(bound {TRAIN_LOSS_REL}); windows max|d| {d:.3e} (the width "
        f"resize on the raw accumulator's extent; bound {VOXEL_ATOL})")
    if not (rel <= TRAIN_LOSS_REL and d <= VOXEL_ATOL):
        raise AssertionError("DDD17 raw windows disagree with the default")
    del res, built, got, std, want
    torch.cuda.empty_cache()


def pins_stream(dev, kern_rows) -> None:
    """Phase 11, part 3: streaming at B=8 on the tile wire with the int8
    planes (B3-int8), 40 windows, against the plain path (B3's plain int8
    version: the same grids) under the streaming bounds, against the f32
    planes (what moved), and both rates alternated."""
    from ess_tpu_torch.train.streaming import make_streaming_steps

    b = 8
    mods, steps_f32 = bench.build_stream(b, dev)
    steps = make_streaming_steps(mods, pin_pipeline(bench.make_pipeline(),
                                                    "int8"))
    windows = bench.make_stream(7, b, dev, "tile", windows=STREAM_WINDOWS,
                                resets=((0, 1.0), (STREAM_WINDOWS // 2, 0.5)))
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    hook = mods.head.register_forward_hook(keep_logits)
    reset_counts()
    state, cm = bench.run_stream(steps, mods.recon_val.init_state(b, dev),
                                 windows)
    counts = read_counts()
    log(f"pins stream B={b}, tile wire, int8 planes, {STREAM_WINDOWS} "
        f"windows: launches {show_counts(counts)}")
    need_counts(counts, by_name({"B3-int8": STREAM_WINDOWS,
                                 "B2": 3 * STREAM_WINDOWS}))
    add_launches(kern_rows, "pins_stream_int8", counts)
    got = (state[-1][0].float(), logits[0])
    with plain_versions():
        state_p, cm_p = bench.run_stream(
            steps, mods.recon_val.init_state(b, dev), windows)
    ref = (state_p[-1][0].float(), logits[0])
    slice_agreement("stream int8 planes, kernel vs plain path", got[0],
                    ref[0], got[1].argmax(1), ref[1].argmax(1), ref[1], cm,
                    cm_p)
    state_f, cm_f = bench.run_stream(
        steps_f32, mods.recon_val.init_state(b, dev), windows)
    lat_f = state_f[-1][0].float()
    rel = ((got[0] - lat_f).abs().max() / lat_f.abs().max()).item()
    moved = 100.0 * float((cm - cm_f).abs().sum()) / (2 * float(cm_f.sum()))
    log(f"  stream int8 vs f32 planes: final latent rel max|d| {rel:.3e}, "
        f"confusion matrix {moved:.3f}% moved (reported)")
    hook.remove()
    timed = windows[:bench.WINDOWS_PER_SCORE]
    rates = {"int8": [], "f32": []}
    for name in ("f32", "int8", "int8", "f32"):
        rates[name].append(bench.stream_windows_per_sec(
            mods, steps if name == "int8" else steps_f32, timed, 3))
    for name, r in rates.items():
        log(f"pins streaming B={b} ({name} planes): "
            f"{statistics.median(r):.2f} windows/s (runs "
            f"{[round(v, 1) for v in r]})")
    del mods, steps, steps_f32, windows, state, state_p, state_f
    torch.cuda.empty_cache()


def phase_pins(dev, kern_rows) -> None:
    """Phase 11: the voxelizer pins (module docstring)."""
    t_phase = time.perf_counter()
    pins_steps(dev, kern_rows)
    pins_ddd17(dev, kern_rows)
    pins_stream(dev, kern_rows)
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")


KEEP_RULE = 0.02    # a form more than 2 % slower is not the port's default


def seeded(cfg, dev, **forms):
    """Modules of ``cfg`` at seed 0 (``bench.build_*``'s weights) with the
    builder's form keywords."""
    mods = build_modules(cfg, device=dev, **forms)
    init_params(mods, torch.Generator().manual_seed(0))
    return mods


def keep_rule(what: str, calls: dict, windows: int, reps: int = 3) -> dict:
    """Time ``calls`` {"form": call, "standard": call} (each synchronized)
    alternately, ``reps`` calls a turn in the order form, standard,
    standard, form; print the medians, the form's cost over the standard
    one and what the keep rule makes of it. Returns the medians (s)."""
    samples = {n: [] for n in calls}
    for name in ("form", "standard", "standard", "form"):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            samples[name].append(time.perf_counter() - t0)
    med = {n: statistics.median(v) for n, v in samples.items()}
    cost = med["form"] / med["standard"] - 1.0
    log(f"keep rule, {what}: form {1e3 * med['form']:.2f} ms "
        f"({windows / med['form']:.2f} windows/s), standard "
        f"{1e3 * med['standard']:.2f} ms ({windows / med['standard']:.2f} "
        f"windows/s), medians of {len(samples['form'])} calls alternated; "
        f"the form costs {100.0 * cost:+.2f}% -> "
        + ("keep the standard form as the port's default"
           if cost > KEEP_RULE else "the form may be the port's default")
        + f" (runs form {[round(1e3 * t, 1) for t in samples['form']]}, "
        f"standard {[round(1e3 * t, 1) for t in samples['standard']]})")
    return med


def model_quad(dev, kern_rows) -> None:
    """Phase 12, part 1: the quad-block rollout (s4d windows) through the
    eval and train steps at B=8 on the library block convs and on B4 /
    B4-int8, and 20 streamed windows at B=8, against the default
    block-space rollout; launch counts, the branch, both rates alternated."""
    from ess_tpu_torch.train import supervised
    from ess_tpu_torch.train.streaming import make_streaming_steps

    pipe = bench.make_pipeline()
    batch = make_batch(24, 8, dev, ignore_rows=20)
    flips = AugmentParams(flip=torch.arange(8) % 2 == 0)
    n = WINDOWS
    cfg_e = bench.make_cfg(8, None)
    evals = {"default": seeded(cfg_e, dev),
             "quad": seeded(cfg_e, dev, quad_block=True)}
    evals["quad B4"] = builder.with_block_conv_impl(evals["quad"], "pallas")
    logits = [None]

    def keep_logits(mod, args, out):
        logits[0] = out[1].float()

    outs, steps = {}, {}
    for f, mods in evals.items():
        branch = supervised.rollout_form(mods.recon_val, batch, pipe,
                                         train=False)
        hook = mods.head.register_forward_hook(keep_logits)
        steps[f] = make_eval_step(mods, pipe)
        reset_counts()
        out = steps[f](batch)
        counts = read_counts()
        hook.remove()
        log(f"model eval step B=8 T={n} ({f}, branch {branch}): launches "
            f"{show_counts(counts)}, loss {float(out['loss']):.6f}")
        want = {"B1": 1, "B2": 3 * n}
        if f == "quad B4":
            want["B4"] = 3 * n
        need_counts(counts, by_name(want))
        if branch != ("standard" if f == "default" else "s4d"):
            raise AssertionError(f"eval ({f}) took the {branch} branch")
        add_launches(kern_rows, f"model_eval_{f.replace(' ', '_')}", counts)
        outs[f] = (out, logits[0])
    ref, ref_logits = outs["default"]
    for f in ("quad", "quad B4"):
        got = outs[f][0]
        slice_agreement(f"eval, {f} vs default", got["latent8"],
                        ref["latent8"], got["pred"], ref["pred"], ref_logits,
                        got["cm"], ref["cm"])
    del outs, ref, ref_logits, got

    cfg_t = bench.make_cfg(8)
    trains, res = {}, {}
    for f in ("default", "quad", "quad B4"):
        mods = seeded(cfg_t, dev, quad_block=f != "default")
        if f == "quad B4":
            mods = builder.with_block_conv_impl(mods, "pallas", "pallas_int8")
        state = builder.init_state(mods)
        trains[f] = (state, make_train_step(mods, pipe))
        before = [p.detach().clone() for p in state.head.parameters()]
        reset_counts()
        loss = float(trains[f][1](state, batch, flips)["loss"])
        counts = read_counts()
        log(f"model train step B=8 T={n} (int8 cell, flips; {f}): launches "
            f"{show_counts(counts)}, loss {loss:.6f}")
        want = {"B1": 1, "B2-int8": 3 * n}
        if f == "quad B4":
            want["B4-int8"] = 3 * n
        need_counts(counts, by_name(want))
        add_launches(kern_rows, f"model_train_{f.replace(' ', '_')}", counts)
        res[f] = (loss, torch.cat([(p.detach() - q).reshape(-1).float()
                                   for p, q in zip(state.head.parameters(),
                                                   before)]))
    for f in ("quad", "quad B4"):
        rel = abs(res[f][0] - res["default"][0]) / abs(res["default"][0])
        u, u0 = res[f][1], res["default"][1]
        urel = ((u - u0).abs().max() / u0.abs().max()).item()
        log(f"  train, {f} vs default: loss relative difference {rel:.3e} "
            f"(bound {TRAIN_LOSS_REL}), head update rel max|d| {urel:.3e} "
            "(reported)")
        if not rel <= TRAIN_LOSS_REL:
            raise AssertionError(f"train ({f}) loss moved by {rel:.3e}")
    calls = {}
    for f in evals:
        calls[f"eval {f}"] = lambda f=f: float(steps[f](batch)["loss"])
        calls[f"train {f}"] = lambda f=f: float(trains[f][1](
            trains[f][0], batch, flips)["loss"])
    timed_forms_peak(f"model B=8 T={n} band wire", calls, 8 * n)
    del calls, trains, steps

    # streaming: 20 windows at B=8 on the tile wire, one labeled
    b = 8
    windows = bench.make_stream(9, b, dev, "tile",
                                windows=bench.WINDOWS_PER_SCORE,
                                resets=((0, 1.0),))
    runs = {}
    for f in ("default", "quad"):
        mods = evals[f]
        stream_steps = make_streaming_steps(mods, pipe)
        hook = mods.head.register_forward_hook(keep_logits)
        reset_counts()
        state, cm = bench.run_stream(stream_steps,
                                     mods.recon_val.init_state(b, dev),
                                     windows)
        counts = read_counts()
        hook.remove()
        log(f"model stream B={b}, tile wire, {len(windows)} windows ({f}): "
            f"launches {show_counts(counts)}; level-0 state "
            f"{tuple(state[0][0].shape)}")
        need_counts(counts, by_name({"B3": len(windows),
                                     "B2": 3 * len(windows)}))
        add_launches(kern_rows, f"model_stream_{f}", counts)
        runs[f] = (state[-1][0].float(), logits[0], cm, stream_steps)
    got, ref = runs["quad"], runs["default"]
    slice_agreement("stream, quad vs default", got[0], ref[0],
                    got[1].argmax(1), ref[1].argmax(1), ref[1], got[2],
                    ref[2])
    rates = {f: [] for f in runs}
    for f in ("default", "quad", "quad", "default"):
        rates[f].append(bench.stream_windows_per_sec(evals[f], runs[f][3],
                                                     windows, 1))
    for f, r in rates.items():
        log(f"model streaming B={b} ({f}): {statistics.median(r):.2f} "
            f"windows/s (runs {[round(v, 1) for v in r]})")
    del evals, runs, windows
    torch.cuda.empty_cache()


def model_forms(dev, kern_rows) -> None:
    """Phase 12, part 2: JAX's default forms against the standard ones in
    the same run, agreement and the keep-rule timings (KEEP_RULE): the
    fused-final head in the supervised train step, the blocked stem and
    the fused-final head in the UDA train step, the blocked decoder conv on
    the eval step's decode, ``head_conv_impl='auto'`` on a standard-layout
    eval rollout."""
    pipe = bench.make_pipeline()
    batch = make_batch(25, 8, dev, ignore_rows=20)
    flips = AugmentParams(flip=torch.arange(8) % 2 == 0)
    n = WINDOWS

    def train_pair(cfg, make, step_batch, what, path, form, standard):
        """(form, standard) steps of ``make`` (builder keywords ``form``
        and ``standard``) from one seeded state each: first-step losses
        compared, launch counts booked; returns the timed calls."""
        out, runs = {}, {}
        for name, kw in (("form", form), ("standard", standard)):
            mods = seeded(cfg, dev, **kw)
            state = builder.init_state(mods)
            step = make(mods, pipe)
            reset_counts()
            losses = step(state, *step_batch)
            counts = read_counts()
            add_launches(kern_rows, f"{path}_{name}", counts)
            out[name] = {k: float(v) for k, v in losses.items()
                         if v.ndim == 0}
            runs[name] = lambda step=step, state=state: float(
                step(state, *step_batch)["loss"])
            log(f"model {what} ({name}): launches {show_counts(counts)}, "
                f"loss {out[name]['loss']:.6f}")
        rel = {k: abs(out["form"][k] - v) / max(abs(v), 1e-12)
               for k, v in out["standard"].items()}
        log(f"  {what}, form vs standard: loss relative difference "
            f"{rel['loss']:.3e} (bound {TRAIN_LOSS_REL}); the largest of "
            f"{len(rel)} losses {max(rel.values()):.3e} (reported)")
        if not rel["loss"] <= TRAIN_LOSS_REL:
            raise AssertionError(f"{what}: the forms disagree")
        return runs

    cfg_t = bench.make_cfg(8)
    runs = train_pair(cfg_t, make_train_step, (batch, flips),
                      "supervised train step B=8, fused-final head",
                      "model_fused_train", {"fused_final": True},
                      {"fused_final": False})
    keep_rule("the fused-final head in the supervised train step", runs,
              8 * n)
    cfg_u = bench.make_uda_cfg(8)
    uda_batch = bench.make_uda_batch(4, 8, dev, ignore_rows=20)
    for what, path, key, values in (
            ("the blocked stem", "model_uda_stem", "stem_impl",
             ("auto", "xla")),
            ("the fused-final head", "model_uda_fused", "fused_final",
             (True, False))):
        runs = train_pair(cfg_u, uda.make_train_step, (uda_batch,),
                          f"UDA train step B=8, {what}", path,
                          {key: values[0]}, {key: values[1]})
        keep_rule(f"{what} in the UDA train step", runs, 8 * n)
    del runs

    cfg_e = bench.make_cfg(8, None)
    for what, path, form, key in (
            ("the blocked decoder conv on the eval step's decode",
             "model_decoder", None, "decoder_conv_impl"),
            ("head_conv_impl='auto' on a standard-layout eval rollout",
             "model_head_conv", "standard", "head_conv_impl")):
        calls, outs = {}, {}
        for name in ("form", "standard"):
            impl = "auto" if name == "form" else "xla"
            if key == "head_conv_impl":   # the config key
                mods = seeded(cfg_e.replace(model=dataclasses.replace(
                    cfg_e.model, head_conv_impl=impl)), dev)
            else:
                mods = seeded(cfg_e, dev, **{key: impl})
            mods = bench.apply_form(mods, form)
            step = make_eval_step(mods, pipe)
            reset_counts()
            outs[name] = step(batch)
            counts = read_counts()
            add_launches(kern_rows, f"{path}_{name}", counts)
            log(f"model eval step B=8 ({what}; {name}): launches "
                f"{show_counts(counts)}, loss "
                f"{float(outs[name]['loss']):.6f}")
            calls[name] = lambda step=step: float(step(batch)["loss"])
        d = (outs["form"]["img_fake"] - outs["standard"]["img_fake"]).abs()
        rel = abs(float(outs["form"]["loss"]) - float(
            outs["standard"]["loss"])) / abs(float(outs["standard"]["loss"]))
        log(f"  {what}: image max|d| {d.max().item():.3e}, loss relative "
            f"difference {rel:.3e} (bound {TRAIN_LOSS_REL})")
        if not rel <= TRAIN_LOSS_REL:
            raise AssertionError(f"{what}: the forms disagree")
        keep_rule(what, calls, 8 * n)
        del calls, outs
    torch.cuda.empty_cache()


def phase_model_pins(dev, kern_rows) -> None:
    """Phase 12: the model's forms (module docstring)."""
    t_phase = time.perf_counter()
    model_quad(dev, kern_rows)
    model_forms(dev, kern_rows)
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")


# The JAX package's last library surface (phase 13) at E2VID-lightweight's
# full width (base 32, 3 encoders, 2 residual blocks), bf16, on B2 and B4.
# Each window of RECON13_EVENTS events is voxelized on its own through
# voxelize_window_soa (B3), then Reconstructor(normalize, flip,
# standardize).rollout_all decodes every window. Bounds, stated before the
# first run on the card:
# - the kernel path against the same path on the plain versions (B3, the
#   cell, the block convs), both bf16: frames in 8-bit levels after
#   standardize, at most RECON13_FRAME_BOUND[0] levels apart and at most
#   RECON13_FRAME_BOUND[1] of the values more than one level apart. Sized
#   from bf16 against f32 on the CPU (the same seeded model at 96x128, 20
#   windows: at most 2 levels, 1.6 % of the values more than one apart);
#   the kernels differ from their plain versions in summation order only;
# - no_recurrent: every rollout_all frame equals one step from zero state
#   on its window, and rollout's frame the last of them, bit for bit (the
#   same launches on the same inputs);
# - bf16 against f32 on the card for the UNet family, where no kernel
#   differs: an image in [0, 1] within UNET_BF16_ABS, task logits within
#   TASK_BF16_REL of their absmax, the tanh rollout's image within
#   TANH_BF16_ABS after TANH_WINDOWS carried windows;
# - voxel_grid_temporal against the host voxelizer (the same f32 tent,
#   another time normalization expression) within HOST_GRID_ATOL per cell,
#   event_histogram against numpy's counts exactly.
RECON13_HW = (480, 640)
RECON13_DAVIS = (260, 346)
RECON13_B, RECON13_T = 8, 20
RECON13_EVENTS = 100_000
RECON13_FRAME_BOUND = (6, 0.02)
UNET_BF16_ABS = 0.03
TASK_BF16_REL = 0.05
TANH_BF16_ABS = 0.05
TANH_WINDOWS = 5
HOST_GRID_ATOL = 1e-5
HOT_PIXELS = 100
RECON13_OPTS = dict(normalize=True, flip=True, standardize=True)


def seeded_net(cls, dev, dtype, seed: int, **kw):
    """A seeded net of ``cls`` (every conv drawn as ``nn.Conv2d`` does from
    a generator seeded ``seed``, transposed convs from torch's seeded
    default, then doubled as phase 5f's checkpoint) on ``dev``."""
    from ess_tpu_torch.cli import reconstruct

    torch.manual_seed(seed)
    model = cls(**kw, dtype=dtype, device="cpu")
    reconstruct.seeded_init(model, seed=seed)
    with torch.no_grad():
        for prm in model.parameters():
            prm.mul_(2)
    return model.to(dev).requires_grad_(False)


def recon13_columns(dev, b: int, t_dim: int, h: int, w: int, seed: int):
    """(T, B, N) event columns x, y, t, p made on the card: uniform
    coordinates over the sensor, sorted times, random polarity."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (t_dim, b, RECON13_EVENTS)
    rand = lambda: torch.rand(shape, generator=g, device=dev)  # noqa: E731
    x, y = rand() * (w - 1), rand() * (h - 1)
    t = torch.sort(rand() * 5e4, dim=-1).values
    return x, y, t, (rand() < 0.5).float()


def recon13_windows(cols, h: int, w: int) -> torch.Tensor:
    """(T, B, 5, H, W) grids, one voxelizer call (B3) a window."""
    x, y, t, p = cols
    valid = torch.ones_like(x[0], dtype=torch.bool)
    return torch.stack([batch_voxel.voxelize_window_soa(
        x[i], y[i], t[i], p[i], valid, num_bins=BINS, height=h, width=w,
        normalize=False) for i in range(x.shape[0])])


def frames8(imgs: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(imgs.float(), 0.0, 1.0) * 255.0).to(torch.int16)


def recon13_rollout_all(dev, kern_rows, model, hw, b: int, seed: int):
    """(a): per-window voxelization and rollout_all with the options on,
    kernel path against plain path (the first call of each checked, then
    both timed alternately); returns the kernel path's windows."""
    h, w = hw
    cols = recon13_columns(dev, b, RECON13_T, h, w, seed)
    rec = Reconstructor(model=model, height=h, width=w, **RECON13_OPTS)
    g = rec.geometry

    def run(path):
        ctx = plain_versions() if path == "plain" else contextlib.nullcontext()
        with ctx, torch.no_grad():
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wins = recon13_windows(cols, h, w)
            imgs, _ = rec.rollout_all(wins)
            torch.cuda.synchronize()
            return wins, imgs, read_counts(), time.perf_counter() - t0

    out = {}
    for path in ("kernel", "plain"):
        wins, imgs, counts, _ = run(path)
        out[path] = (wins, imgs)
        log(f"  rollout_all {h}x{w}, B={b} ({path}, first call): launches "
            f"{show_counts(counts)}")
        if path == "kernel":
            need_counts(counts, by_name({"B3": RECON13_T,
                                         "B2": 3 * RECON13_T,
                                         "B4": 2 * RECON13_T}))
            add_launches(kern_rows, f"recon13_rollout_all_{h}x{w}", counts)
        else:
            need_counts(counts, ())
    walls = {"kernel": [], "plain": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        walls[path].append(run(path)[3])
    for path, ts in walls.items():
        wall = statistics.median(ts)
        log(f"  rollout_all {h}x{w} (padded {g.padded_height}x"
            f"{g.padded_width}), B={b}, T={RECON13_T} ({path}): "
            f"{RECON13_T * b / wall:.1f} windows/s ({1e3 * wall:.1f} ms a "
            f"call, voxelizer included; calls "
            f"{[round(1e3 * t, 1) for t in ts]} ms, alternated)")
    want_shape = (RECON13_T, b, 1, g.padded_height, g.padded_width)
    k8, p8 = frames8(out["kernel"][1]), frames8(out["plain"][1])
    if tuple(k8.shape) != want_shape or not torch.isfinite(
            out["kernel"][1]).all():
        raise AssertionError(f"rollout_all: frames {tuple(k8.shape)}")
    d = (k8 - p8).abs()
    worst, over = int(d.max()), float((d > 1).float().mean())
    spread = float(k8.float().std())
    lo, hi = (float(v) for v in out["kernel"][1].aminmax())
    log(f"  frames kernel vs plain: max {worst} levels, "
        f"{100 * over:.3f} % of the values more than one level apart, "
        f"{100 * float((d > 0).float().mean()):.2f} % apart at all (bound "
        f"{RECON13_FRAME_BOUND[0]} levels, {100 * RECON13_FRAME_BOUND[1]} "
        f"%); standardized range [{lo:.4f}, {hi:.4f}], frame std "
        f"{spread:.1f} levels")
    if (worst > RECON13_FRAME_BOUND[0] or over > RECON13_FRAME_BOUND[1]
            or spread < 2 or lo != 0.0 or abs(hi - 1.0) > 1e-3):
        raise AssertionError("rollout_all: the kernel path's frames "
                             "disagree with the plain path's or are flat")
    return out["kernel"][0]


def recon13_no_recurrent(dev, kern_rows, model, wins) -> None:
    """(b): no_recurrent's rollout_all frames against single steps from
    zero state, bit for bit; rollout steps the last window only."""
    b = wins.shape[1]
    h, w = wins.shape[-2:]
    rec = Reconstructor(model=model, height=h, width=w, no_recurrent=True,
                        **RECON13_OPTS)
    with torch.no_grad():
        reset_counts()
        imgs, state = rec.rollout_all(wins)
        counts = read_counts()
        need_counts(counts, by_name({"B2": 3 * RECON13_T,
                                     "B4": 2 * RECON13_T}))
        add_launches(kern_rows, "recon13_no_recurrent", counts)
        same = [torch.equal(rec.step(wins[i], rec.init_state(b, dev))[0],
                            imgs[i]) for i in range(RECON13_T)]
        reset_counts()
        last = rec.rollout(wins)[0]
        counts = read_counts()
    need_counts(counts, by_name({"B2": 3, "B4": 2}))
    zero = not any(bool(t.any()) for pair in state for t in pair)
    log(f"  no_recurrent: rollout_all frames equal to one step from zero "
        f"state on {sum(same)} of {RECON13_T} windows, bit for bit; the "
        f"final state zero {zero}; rollout's frame the last one "
        f"{torch.equal(last, imgs[-1])}, with launches "
        f"{show_counts(counts)} (the last window only)")
    if not (all(same) and zero and torch.equal(last, imgs[-1])):
        raise AssertionError("no_recurrent: frames differ from single steps")


def recon13_postprocess(dev, kern_rows, model, wins) -> None:
    """(c): hot pixels zeroed on sample 0's grids, its rollout_all, then
    the auto-HDR rescaler, the unsharp mask, the host bilateral filter and
    the display's composed frame, ms a frame for each stage."""
    from ess_tpu_torch.recon.display import ImageDisplay
    from ess_tpu_torch.recon.postprocess import (
        IntensityRescaler, bilateral_filter, unsharp_mask, zero_hot_pixels)

    h, w = wins.shape[-2:]
    rng = np.random.default_rng(13)
    hot = np.stack([rng.integers(0, w, HOT_PIXELS),
                    rng.integers(0, h, HOT_PIXELS)], 1)
    ms = {k: [] for k in ("hot pixels", "rollout", "rescale", "unsharp",
                          "bilateral", "compose")}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0))
        return res

    with torch.no_grad():
        grids = timed("hot pixels", zero_hot_pixels, wins[:, 0], hot)
        if grids[:, :, hot[:, 1], hot[:, 0]].any():
            raise AssertionError("zero_hot_pixels left a hot pixel")
        rec = Reconstructor(model=model, height=h, width=w, **RECON13_OPTS)
        reset_counts()
        imgs, _ = timed("rollout", rec.rollout_all, grids[:, None])
        counts = read_counts()
        need_counts(counts, by_name({"B2": 3 * RECON13_T,
                                     "B4": 2 * RECON13_T}))
        add_launches(kern_rows, "recon13_postprocess", counts)
        rescaler = IntensityRescaler(auto_hdr=True)
        shown = ImageDisplay(show_events=True)
        for i in range(RECON13_T):
            f = timed("rescale", rescaler, imgs[i])
            f = timed("unsharp", unsharp_mask, f)
            host = f[0, 0].float().cpu().numpy()
            host = timed("bilateral", bilateral_filter, host, 1.0)
            frame = timed("compose", shown.compose,
                          (np.clip(host, 0, 1) * 255).astype(np.uint8),
                          grids[i].cpu().numpy())
            if (frame.shape != (h, 2 * w, 3) or not np.isfinite(host).all()
                    or host.min() < 0 or host.max() > 1):
                raise AssertionError(f"post-processing frame {i}: "
                                     f"{frame.shape}")
    per = {k: (statistics.median(v) if k not in ("hot pixels", "rollout")
               else v[0] / RECON13_T) for k, v in ms.items()}
    log(f"  post-processing on {RECON13_T} frames at {h}x{w} (B=1), ms a "
        f"frame: " + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
        + f" (host clock, synchronized; hot pixels and rollout the whole "
        f"stack over {RECON13_T}); auto-HDR bounds now "
        f"[{statistics.median(rescaler._mins):.4f}, "
        f"{statistics.median(rescaler._maxs):.4f}]")


def recon13_unets(dev, kern_rows, wins) -> None:
    """(d): UNet at B=8, UNetDecoder and UNetTaskDecoder on the rollout's
    final latent, and a transposed-conv, tanh RecurrentUNet rollout: bf16
    against f32 on the card, with times."""
    from ess_tpu_torch import models

    b = wins.shape[1]
    h, w = wins.shape[-2:]
    x = normalize_nonzero(wins[-1])
    nets = {dt: seeded_net(models.UNet, dev, dt, 31)
            for dt in (torch.bfloat16, torch.float32)}
    with torch.no_grad():
        got, want = (nets[dt](x) for dt in (torch.bfloat16, torch.float32))
        t_bf, t_f = (cuda_ms(lambda dt=dt: nets[dt](x), 3)
                     for dt in (torch.bfloat16, torch.float32))
    e = float((got - want).abs().max())
    log(f"  UNet B={b} {h}x{w}: bf16 {t_bf:.2f} ms, f32 {t_f:.2f} ms; "
        f"bf16 vs f32 max|d| {e:.3e} (bound {UNET_BF16_ABS})")
    if not (torch.isfinite(got).all() and e <= UNET_BF16_ABS):
        raise AssertionError("UNet bf16 disagrees with f32")

    model = seeded_net(models.RecurrentUNet, dev, torch.bfloat16, 32,
                       lstm_impl="pallas", block_conv_impl="pallas")
    rec = Reconstructor(model=model, height=h, width=w, **RECON13_OPTS)
    with torch.no_grad():
        reset_counts()
        _, _, latent = rec.rollout(wins)
        counts = read_counts()
    need_counts(counts, by_name({"B2": 3 * RECON13_T,
                                 "B4": 2 * RECON13_T}))
    add_launches(kern_rows, "recon13_latent", counts)
    lat32 = {k: v.float() for k, v in latent.items()}
    for name, cls, kw in (("UNetDecoder", models.UNetDecoder, {}),
                          ("UNetTaskDecoder", models.UNetTaskDecoder,
                           {"num_classes": CLASSES})):
        decs = {dt: seeded_net(cls, dev, dt, 33, **kw)
                for dt in (torch.bfloat16, torch.float32)}
        with torch.no_grad():
            got = decs[torch.bfloat16](latent)
            want = decs[torch.float32](lat32)
            t_bf = cuda_ms(lambda: decs[torch.bfloat16](latent), 3)
            t_f = cuda_ms(lambda: decs[torch.float32](lat32), 3)
        if isinstance(got, dict):
            got, want = got[1], want[1]
            e = float((got - want).abs().max() / want.abs().max())
            ok = e <= TASK_BF16_REL
            what = f"logits rel max|d| {e:.3e} (bound {TASK_BF16_REL})"
        else:
            e = float((got - want).abs().max())
            ok = e <= UNET_BF16_ABS
            what = f"max|d| {e:.3e} (bound {UNET_BF16_ABS})"
        log(f"  {name} on the final latent (B={b}): bf16 {t_bf:.2f} ms, "
            f"f32 {t_f:.2f} ms; bf16 vs f32 {what}; out "
            f"{tuple(got.shape)}")
        if not (ok and torch.isfinite(got).all()):
            raise AssertionError(f"{name} bf16 disagrees with f32")

    kw = dict(use_upsample_conv=False, final_activation="tanh")
    tanh = {"bf16": seeded_net(models.RecurrentUNet, dev, torch.bfloat16, 34,
                               lstm_impl="pallas", block_conv_impl="pallas",
                               **kw),
            "f32": seeded_net(models.RecurrentUNet, dev, torch.float32, 34,
                              lstm_impl="xla", block_conv_impl="xla", **kw)}
    outs = {}
    with torch.no_grad():
        for name, net in tanh.items():
            rec = Reconstructor(model=net, height=h, width=w, normalize=True)
            reset_counts()
            t0 = time.perf_counter()
            outs[name] = rec.rollout(wins[:TANH_WINDOWS])[0]
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            counts = read_counts()
            if name == "bf16":
                need_counts(counts, by_name({"B2": 3 * TANH_WINDOWS,
                                             "B4": 2 * TANH_WINDOWS}))
                add_launches(kern_rows, "recon13_tanh_rollout", counts)
            else:
                need_counts(counts, ())
            log(f"  transposed-conv tanh RecurrentUNet rollout ({name}), "
                f"B={b}, {TANH_WINDOWS} windows: {wall:.1f} ms, launches "
                f"{show_counts(counts)}")
    e = float((outs["bf16"] - outs["f32"]).abs().max())
    lo, hi = (float(v) for v in outs["f32"].aminmax())
    log(f"  tanh rollout bf16 (kernels) vs f32 (plain): max|d| {e:.3e} "
        f"(bound {TANH_BF16_ABS}), f32 image in [{lo:.3f}, {hi:.3f}]")
    if not (e <= TANH_BF16_ABS and -1 <= lo and hi <= 1):
        raise AssertionError("tanh rollout bf16 disagrees with f32")


def recon13_voxel_ops(dev) -> None:
    """(e): voxel_grid_temporal and event_histogram of one window on the
    card against the host voxelizer and numpy's counts."""
    from ess_tpu_torch.ops.voxel import (
        EventWindow, event_histogram, voxel_grid_temporal)

    h, w = RECON13_HW
    x, y, t, p = (c[0, 0] for c in recon13_columns(dev, 1, 1, h, w, 17))
    ev = EventWindow.from_arrays(x, y, t, p, device=dev)
    raw = torch.stack([x, y, t, p], -1).cpu().numpy()[None]
    valid = np.ones(raw.shape[:2], bool)
    for sep in (False, True):
        kw = dict(num_bins=BINS, height=h, width=w, separate_pol=sep)
        got = voxel_grid_temporal(ev, **kw)
        t_dev = cuda_ms(lambda: voxel_grid_temporal(ev, **kw), 10)
        t0 = time.perf_counter()
        want = native.voxelize_host(raw, valid, **kw)[0]
        t_host = 1e3 * (time.perf_counter() - t0)
        e = float(np.abs(got.cpu().numpy() - want).max())
        log(f"  voxel_grid_temporal (separate_pol {sep}) of "
            f"{RECON13_EVENTS} events at {h}x{w}: {t_dev:.3f} ms on the "
            f"card, voxelize_host {t_host:.2f} ms; max|d| {e:.2e} (bound "
            f"{HOST_GRID_ATOL})")
        if not e <= HOST_GRID_ATOL:
            raise AssertionError("voxel_grid_temporal disagrees with the "
                                 "host voxelizer")
    got = event_histogram(ev, height=h, width=w).cpu().numpy()
    t_dev = cuda_ms(lambda: event_histogram(ev, height=h, width=w), 10)
    xi, yi = raw[0, :, 0].astype(np.int64), raw[0, :, 1].astype(np.int64)
    want = np.zeros((2, h, w), np.float32)
    np.add.at(want, ((raw[0, :, 3] > 0).astype(np.int64), yi, xi), 1.0)
    log(f"  event_histogram: {t_dev:.3f} ms on the card, equal to numpy's "
        f"counts {np.array_equal(got, want)} ({int(got.sum())} events)")
    if not np.array_equal(got, want):
        raise AssertionError("event_histogram disagrees with numpy")


def recon13_level_rule(dev, kern_rows) -> None:
    """(f): B5 declines below JAX's size rule and launches above it, held
    against its plain version as phase 3 holds it."""
    ushape, ch, u_s2d = LEVEL_ODD
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(50, ushape, ch,
                                                        u_s2d, dev)
    n_below = h0.numel()
    reset_counts()
    below = level.encoder_level_int8(u, (h0, c0.clone(
        memory_format=torch.channels_last)), ek, eb, gk, gb, u_s2d=u_s2d)
    counts = read_counts()
    if level.fuses(n_below) or below is not None or any(counts):
        raise AssertionError("B5 took an h_prev below the size rule")
    ushape, ch, u_s2d = LEVEL_SHAPES[-1]
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(51, ushape, ch,
                                                        u_s2d, dev)
    prep = level.prepare_level_weights(ek, eb, gk, gb)
    reset_counts()
    h_k, (_, c_k) = level.encoder_level_int8(
        u, (h0, c0.clone(memory_format=torch.channels_last)), ek, eb, gk, gb,
        u_s2d=u_s2d, prepared=prep)
    counts = read_counts()
    need_counts(counts, by_name({"B5": 1}))
    add_launches(kern_rows, "recon13_level", counts)
    th = conv_lstm.pick_row_tile(h0.shape[2])
    h_p, c_p = level.level_int8_ref(u, h0, c0, prep, u_s2d=u_s2d, th=th)[:2]
    bad = sum(ulp_report(g, p)[0] for g, p in ((h_k, h_p), (c_k, c_p)))
    log(f"  B5 size rule: h_prev of {n_below} elements "
        f"(below {level.FUSE_MIN_ELEMENTS}) -> None, no launch; "
        f"{h0.numel()} elements -> {show_counts(counts)}, {bad} values of "
        f"h', c' beyond one bf16 ulp of the plain version (bound 0)")
    if bad:
        raise AssertionError("B5 disagrees with its plain version")


def phase_surface(dev, kern_rows) -> None:
    """Phase 13: the JAX package's last library surface (module
    docstring)."""
    from ess_tpu_torch.models.e2vid import RecurrentUNet

    t_phase = time.perf_counter()
    model = seeded_net(RecurrentUNet, dev, torch.bfloat16, 30,
                       lstm_impl="pallas", block_conv_impl="pallas")
    wins = recon13_rollout_all(dev, kern_rows, model, RECON13_HW, RECON13_B,
                               41)
    recon13_rollout_all(dev, kern_rows, model, RECON13_DAVIS, 1, 42)
    recon13_no_recurrent(dev, kern_rows, model, wins)
    recon13_postprocess(dev, kern_rows, model, wins)
    recon13_unets(dev, kern_rows, wins)
    del wins, model
    torch.cuda.empty_cache()
    recon13_voxel_ops(dev)
    recon13_level_rule(dev, kern_rows)
    if "cv2" in sys.modules:
        raise AssertionError("phase 13 imported cv2")
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    t_start = time.perf_counter()
    at = lambda name: log(f"{name} done at "
                          f"{time.perf_counter() - t_start:.1f} s")
    dev = phase_device()
    phase_build()
    rows = [check_voxelizer(dev), check_cells(dev, int8=False),
            check_cells(dev, int8=True), check_voxel_tiled(dev),
            check_conv3x3(dev), check_conv3x3_int8(dev), check_level(dev),
            check_cell_variants(dev), check_voxel_folded_legacy(dev),
            check_head_cmajor(dev)] + check_voxel_pins(dev)
    at("phases 1-3")
    phase_repeat(dev)
    at("phase 3b")
    for name, phase in (("phase 4", phase_slice), ("phase 5", phase_train),
                        ("phase 5b", phase_uda), ("phase 5c", phase_ddd17)):
        phase(dev, rows)
        at(name)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = ddd17_tree(tmp, np.random.default_rng(14))
        log(f"DDD17 tree of {sum(CLI_MASKS.values())} masks in 7 folders "
            f"written in {time.perf_counter() - t0:.1f} s")
        cli_run = phase_cli(dev, rows, tmp, root)
        at("phase 5d")
        phase_uda_cli(dev, rows, tmp, root)
        at("phase 5e")
        phase_reconstruct(dev, rows, tmp)
        at("phase 5f")
        phase_options(dev, rows, tmp, root)
        at("phase 5g")
        phase_dp(dev, rows, tmp, cli_run)
        at("phase 5h")
    for name, phase in (("phase 6", phase_stream), ("phase 9", phase_data),
                        ("phase 7", phase_block), ("phase 8", phase_tools),
                        ("phase 8b", phase_tools_measure),
                        ("phase 10", phase_forms), ("phase 11", phase_pins),
                        ("phase 12", phase_model_pins),
                        ("phase 13", phase_surface)):
        phase(dev, rows)
        at(name)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
