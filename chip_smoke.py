"""Drive the PyTorch + CUDA port's DSEC eval and train paths once on one
NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, the CUDA toolkit (``nvcc``) and ``g++``; it never
imports JAX or the JAX package. Phases, in order (any failure raises and
exits non-zero, with no result line):

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for the f32 plain versions;
2. build: compile the CUDA kernels of ``ess_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel) and the host binning library from the
   checkout's sources;
3. kernels: each kernel (B1 voxelizer, B2 exact ConvLSTM cell, B2-int8
   ConvLSTM cell) against its plain PyTorch version on the card at the DSEC
   shapes of the eval and train paths, with kernel and plain times (CUDA
   events);
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
   plain versions, and its peak device memory.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ess_tpu_torch import bench, kernels  # noqa: E402
from ess_tpu_torch.bench import (  # noqa: E402
    BINS, CROP, SENSOR_H, SENSOR_W, make_batch, make_raw)
from ess_tpu_torch.data import native  # noqa: E402
from ess_tpu_torch.data.pipeline import AugmentParams  # noqa: E402
from ess_tpu_torch.models import layers  # noqa: E402
from ess_tpu_torch.ops import batch_voxel, conv_lstm, voxel_folded  # noqa: E402
from ess_tpu_torch.ops.voxel import masked_time_norm, normalize_from_stats  # noqa: E402
from ess_tpu_torch.train.builder import build_modules, init_params  # noqa: E402
from ess_tpu_torch.train.supervised import make_eval_step  # noqa: E402

WINDOWS, EVENTS, CLASSES = bench.WINDOWS, bench.EVENTS_PER_WINDOW, bench.NUM_CLASSES
CELL_SHAPES = [(2, 64, 220, 320), (2, 128, 110, 160), (2, 256, 55, 80)]

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
# Train slice, int8-kernel path vs plain path on the first step.
TRAIN_LATENT_REL = 0.05    # latent8 relative max |d|
TRAIN_LOSS_REL = 0.02      # loss relative difference


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_cell(x, h, c, w, b, *, impl="pallas", prepared=None):
    """The plain version of the cell ``impl`` names."""
    fn = (conv_lstm.conv_lstm_int8_ref if impl == "pallas_int8"
          else conv_lstm.conv_lstm_ref)
    return fn(x, h, c, w, b)


@contextlib.contextmanager
def plain_versions():
    """Route the eval and train paths through the kernels' plain PyTorch
    versions (on the same device tensors) for the comparison runs."""
    saved = (batch_voxel.voxelize_folded, layers.conv_lstm_cell)
    batch_voxel.voxelize_folded = voxel_folded.voxelize_folded_ref
    layers.conv_lstm_cell = plain_cell
    try:
        yield
    finally:
        batch_voxel.voxelize_folded, layers.conv_lstm_cell = saved


def reset_counts() -> None:
    voxel_folded.launches = 0
    conv_lstm.launches = 0
    conv_lstm.launches_int8 = 0


def read_counts() -> tuple:
    torch.cuda.synchronize()
    return voxel_folded.launches, conv_lstm.launches, conv_lstm.launches_int8


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
    log(f"built host binning in {time.perf_counter() - t0:.1f} s total")


def check_voxelizer(dev):
    n_win = 2 * WINDOWS
    rng = np.random.default_rng(1)
    raw, valid = make_raw(rng, 2)
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
    grid_k, stats_k = voxel_folded.voxelize_folded(x, y, ts, pol, offs, **kw)
    grid_p, stats_p = voxel_folded.voxelize_folded_ref(x, y, ts, pol, offs,
                                                       **kw)
    err_raw = (grid_k - grid_p).abs().max().item()
    err = (normalize_from_stats(grid_k, stats_k)
           - normalize_from_stats(grid_p, stats_p)).abs().max().item()
    log(f"B1 voxel_folded: max|d| raw grid {err_raw:.3e}, normalized grid "
        f"{err:.3e} (bound {VOXEL_ATOL})")
    if not err <= VOXEL_ATOL:
        raise AssertionError(f"B1 disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: voxel_folded.voxelize_folded(x, y, ts, pol, offs,
                                                      **kw), 20)
    plain_ms = cuda_ms(lambda: voxel_folded.voxelize_folded_ref(
        x, y, ts, pol, offs, **kw), 5)
    log(f"B1 time for {n_win} windows: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms")
    return {"name": "voxel_folded", "route": "cuda",
            "source": "ess_tpu_torch/csrc/voxel_folded.cu",
            "replaces": "ess_tpu/ops/voxel_pallas.py:334",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_conv_lstm(dev):
    g = torch.Generator().manual_seed(2)
    cl = torch.channels_last
    err_h = err_c = ms = plain_ms = 0.0
    for b, ch, hh, ww in CELL_SHAPES:
        mk = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale
        x = mk(b, ch, hh, ww).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)
        h = torch.tanh(mk(b, ch, hh, ww)).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)
        c = mk(b, ch, hh, ww).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)
        w = mk(4 * ch, 2 * ch, 3, 3, scale=(18 * ch) ** -0.5).to(dev)
        bias = mk(4 * ch, scale=0.1).to(dev)
        prep = conv_lstm.prepare_gate_weights(w)
        h_p, c_p = conv_lstm.conv_lstm_ref(x, h, c, w, bias)
        h_k, c_k = conv_lstm.conv_lstm_cell(x, h, c.clone(), w, bias,
                                            prepared=prep)
        eh = (h_k.float() - h_p.float()).abs().max().item()
        ec = (c_k.float() - c_p.float()).abs().max().item()
        err_h, err_c = max(err_h, eh), max(err_c, ec)
        cw = c.clone()
        t_k = cuda_ms(lambda: conv_lstm.conv_lstm_cell(
            x, h, cw, w, bias, prepared=prep), 20)
        t_p = cuda_ms(lambda: conv_lstm.conv_lstm_ref(x, h, c, w, bias), 5)
        ms, plain_ms = ms + t_k, plain_ms + t_p
        flop = 2.0 * b * hh * ww * 9 * 2 * ch * 4 * ch
        log(f"B2 conv_lstm B={b} C={ch} {hh}x{ww}: max|dh| {eh:.3e} "
            f"(bound {LSTM_H_ATOL}), max|dc| {ec:.3e} (bound {LSTM_C_ATOL}); "
            f"kernel {t_k:.3f} ms ({flop / t_k / 1e9:.1f} TFLOP/s), plain "
            f"{t_p:.3f} ms")
        if not (eh <= LSTM_H_ATOL and ec <= LSTM_C_ATOL):
            raise AssertionError(f"B2 disagrees with its plain version: "
                                 f"dh {eh}, dc {ec}")
    log(f"B2 time for the three encoder cells (one window, B=2): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"name": "conv_lstm", "route": "cuda",
            "source": "ess_tpu_torch/csrc/conv_lstm.cu",
            "replaces": "ess_tpu/ops/conv_lstm_pallas.py:132",
            "max_abs_err": max(err_h, err_c), "ms": ms, "plain_ms": plain_ms}


def check_conv_lstm_int8(dev):
    g = torch.Generator().manual_seed(5)
    cl = torch.channels_last
    err = ms = plain_ms = 0.0
    for b, ch, hh, ww in CELL_SHAPES:
        mk = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale
        x = (torch.relu(mk(b, ch, hh, ww)) * 2).to(dev, torch.bfloat16) \
            .contiguous(memory_format=cl)
        h = torch.tanh(mk(b, ch, hh, ww)).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)
        c = mk(b, ch, hh, ww).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)
        w = mk(4 * ch, 2 * ch, 3, 3, scale=(18 * ch) ** -0.5).to(dev)
        bias = mk(4 * ch, scale=0.05).to(dev)
        prep = conv_lstm.prepare_gate_weights(w, torch.float32)
        h_p, c_p = conv_lstm.conv_lstm_int8_ref(x, h, c, w, bias)
        h_k, c_k = conv_lstm.conv_lstm_cell(x, h, c.clone(), w, bias,
                                            impl="pallas_int8", prepared=prep)
        bad, unequal, e = 0, 0, 0.0
        for got, want in ((h_k, h_p), (c_k, c_p)):
            d = (got.float() - want.float()).abs()
            bad += int((d > bf16_ulp(got, want) + INT8_ULP_SLACK).sum())
            unequal += int((got != want).sum())
            e = max(e, d.max().item())
        err = max(err, e)
        h_e, c_e = conv_lstm.conv_lstm_ref(x, h, c, w, bias)
        dh = (h_k.float() - h_e.float()).abs()
        dc = (c_k.float() - c_e.float()).abs()
        cw = c.clone()
        t_k = cuda_ms(lambda: conv_lstm.conv_lstm_cell(
            x, h, cw, w, bias, impl="pallas_int8", prepared=prep), 20)
        t_p = cuda_ms(lambda: conv_lstm.conv_lstm_int8_ref(x, h, c, w, bias),
                      3)
        ms, plain_ms = ms + t_k, plain_ms + t_p
        ops = 2.0 * b * hh * ww * 9 * 2 * ch * 4 * ch
        log(f"B2-int8 conv_lstm_int8 B={b} C={ch} {hh}x{ww}: vs plain int8 "
            f"max|d| {e:.3e}, {unequal} of {2 * h_k.numel()} values not "
            f"bit-identical, {bad} beyond one bf16 ulp (bound 0); "
            f"vs exact plain max|dh| {dh.max().item():.3e} mean|dh| "
            f"{dh.mean().item():.3e} max|dc| {dc.max().item():.3e} (JAX int8 "
            f"bounds on its test cell: {JAX_INT8_DH_MAX}, {JAX_INT8_DH_MEAN}, "
            f"{JAX_INT8_DC_MAX}); kernel {t_k:.3f} ms "
            f"({ops / t_k / 1e9:.1f} TOP/s, quantization prep included), "
            f"plain {t_p:.3f} ms")
        if bad:
            raise AssertionError(f"B2-int8 disagrees with its plain version "
                                 f"at {bad} values (max |d| {e})")
    log(f"B2-int8 time for the three encoder cells (one window, B=2): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"name": "conv_lstm_int8", "route": "cuda",
            "source": "ess_tpu_torch/csrc/conv_lstm_int8.cu",
            "replaces": "ess_tpu/ops/conv_lstm_pallas.py:137",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    n_b1, n_b2, n_i8 = read_counts()
    log(f"eval slice B=2 T={WINDOWS} {SENSOR_H}x{SENSOR_W} -> "
        f"{SENSOR_H - CROP}x{SENSOR_W}, "
        f"{EVENTS} events/window, {CLASSES} classes: {steps} eval steps, "
        f"launches B1 {n_b1}, B2 {n_b2}, B2-int8 {n_i8}")
    if n_b1 != steps or n_b2 != steps * 3 * WINDOWS or n_i8:
        raise AssertionError(f"launch counts B1 {n_b1} (want {steps}), "
                             f"B2 {n_b2} (want {steps * 3 * WINDOWS}), "
                             f"B2-int8 {n_i8} (want 0)")
    for row, n in zip(kern_rows, (n_b1, n_b2, n_i8)):
        row["launches_by_path"] = {"eval": n}
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


def phase_train(dev, kern_rows):
    steps, b = 3, 2
    mods, state, step = bench.build_train(bench.make_cfg(b), dev)
    batch = make_batch(3, b, dev, ignore_rows=20)
    head0 = {k: v.clone() for k, v in mods.head.state_dict().items()}
    e2vid0 = {k: v.clone() for k, v in mods.e2vid.state_dict().items()}

    reset_counts()
    losses = [step(state, batch)["loss"] for _ in range(steps)]
    n_b1, n_b2, n_i8 = read_counts()
    losses = [float(v) for v in losses]
    log(f"train slice B={b} T={WINDOWS}, {steps} train steps (train rollout "
        f"on the int8 cell): launches B1 {n_b1}, B2 {n_b2}, B2-int8 {n_i8}; "
        f"losses {[round(v, 6) for v in losses]}")
    if n_b1 != steps or n_i8 != steps * 3 * WINDOWS or n_b2:
        raise AssertionError(f"launch counts B1 {n_b1} (want {steps}), "
                             f"B2-int8 {n_i8} (want {steps * 3 * WINDOWS}), "
                             f"B2 {n_b2} (want 0)")
    for row, n in zip(kern_rows, (n_b1, n_b2, n_i8)):
        row["launches_by_path"]["train"] = n
        row["launches"] = sum(row["launches_by_path"].values())
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

    def timed(name: str, reps: int) -> list[float]:
        state8, step8 = runs[name]
        ctx = (plain_versions() if name == "plain versions"
               else contextlib.nullcontext())
        times = []
        with ctx:
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(step8(state8, batch8)["loss"])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        return times

    torch.cuda.reset_peak_memory_stats()
    timed("int8 kernels", 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed("exact-bf16 kernels", 1)
    timed("plain versions", 1)
    samples = {name: [] for name in runs}
    for name, reps in (("plain versions", 1), ("int8 kernels", 2),
                       ("exact-bf16 kernels", 2), ("exact-bf16 kernels", 2),
                       ("int8 kernels", 2), ("plain versions", 1)):
        samples[name] += timed(name, reps)
    for name, ts in samples.items():
        med = statistics.median(ts)
        log(f"train step B=8 T={WINDOWS} ({name}): "
            f"{8 * WINDOWS / med:.2f} windows/s, median {1e3 * med:.1f} ms "
            f"over {len(ts)} steps {[round(1e3 * t, 1) for t in ts]}")
    log(f"peak device memory of the int8-kernel train step at B=8: "
        f"{peak:.2f} GiB")


def main() -> None:
    dev = phase_device()
    phase_build()
    rows = [check_voxelizer(dev), check_conv_lstm(dev),
            check_conv_lstm_int8(dev)]
    phase_slice(dev, rows)
    phase_train(dev, rows)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
