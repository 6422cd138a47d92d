"""The voxelizers alone at one step's 160 windows of 100k DSEC events, over
the scatter plan's variants, with a repeat check.

Counterpart of the JAX package's ``tools/bench_kernel.py``, which times its
Pallas voxelizer at 160 x 100k events over its tile grouping (K) and chunk
length (CHUNK). The port's voxelizers share one scatter core
(``csrc/voxel_scatter.cuh``) whose plan (``ops/voxel_scatter.py::
scatter_plan``) offers one choice, the block size (256 or 512 threads);
those are the variants here. Cases: B3 on the tile wire (host
tile-sorted events, the JAX tool's shape), B1 on the x-slot band wire and
B3-legacy on the full-width band wire (host ghost-folded records), all
from ``bench.make_raw``'s seeded windows::

    python -m ess_tpu_torch.tools.bench_kernel [--windows N] [--calls N]
        [--repeat N] [--quick] [--steps]

Device ms a call: ``tools/bench_voxel.py``'s timing (CUDA events behind a
spin kernel, best of three runs of ``--calls`` calls). The bound: each
event or record read once (16 B), the offsets, the grid and B1's stats
written once, over 3.35 TB/s. ``--repeat N`` launches each case N times on
one input and says whether every launch's grid (and stats) equal the
first's bit for bit: the core adds fixed-point cells, so they must.
``--quick`` times the plan's own choice only. ``--steps`` also reads the
eval and train step rates at ``bench.py``'s shape (B=8, T=20; windows/s of
``bench.windows_per_sec``), so that a change to the core can be read end
to end; to compare two trees, run this file from each (an earlier tree
unpacked with ``git archive``, this file and ``bench_voxel.py`` copied into
its ``ess_tpu_torch/tools/``), alternately, in one call. One JSON line a
case and variant, with the card's name and power limit.

On the CPU (``main(argv, device="cpu", shape=...)``) it runs the plain
versions at the small ``shape`` (windows, events, height, width) given, on
the host clock: a check of the tool, not a measurement.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Optional

import numpy as np
import torch

WINDOWS = 160
CASES = ("B3", "B1", "B3-legacy")
HBM_BYTES_PER_S = 3.35e12


def binned(windows: int, events: int, height: int, width: int,
           bins: int = 5, seed: int = 0) -> dict:
    """name -> the host binning of ``windows`` windows of ``events`` made by
    ``bench.make_raw``'s recipe (uniform coordinates, sorted times, random
    polarity): (records or events (W, N, 4), valid, offsets) of B3's tile
    wire, B1's x-slot band wire and B3-legacy's full-width band wire."""
    from ess_tpu_torch.ops import voxel_folded, voxel_tiled

    rng = np.random.default_rng(seed)
    shape = (windows, events)
    raw = np.zeros(shape + (4,), np.float32)
    raw[..., 0] = rng.uniform(0, width - 1, shape)
    raw[..., 1] = rng.uniform(0, height - 1, shape)
    raw[..., 2] = np.sort(rng.uniform(0, 5e4, shape), axis=-1)
    raw[..., 3] = rng.integers(0, 2, shape)
    valid = np.ones(shape, bool)
    out = {"B3": voxel_tiled.host_tile_bin(raw, valid, height=height,
                                           width=width, bins=bins)}
    for name, x_slots in (("B1", True), ("B3-legacy", False)):
        out[name] = voxel_folded.host_band_bin_folded(
            raw, valid, height=height, width=width, bins=bins,
            x_slots=x_slots)
    return out


def make_cases(device, windows: int, events: int, height: int, width: int,
               bins: int = 5, seed: int = 0) -> dict:
    """name -> (voxelizer, its columns on ``device``, keywords, records
    read, offsets read, stats floats a window) of :func:`binned`'s
    windows."""
    from ess_tpu_torch.ops import voxel_folded, voxel_tiled
    from ess_tpu_torch.ops.voxel import masked_time_norm

    th = voxel_folded.tile_h_for_bins(bins)
    kw = dict(bins=bins, height=-(-height // th) * th,
              width=-(-width // 128) * 128)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def columns(r, v, o, signed):
        x, y, t, p = (to_dev(r[..., i]) for i in range(4))
        vd = to_dev(v)
        if signed:                      # raw events: +-1 polarity
            p = torch.where(p > 0, 1.0, -1.0)
        return (x, y, masked_time_norm(t, vd, bins).contiguous(),
                torch.where(vd, p, torch.zeros_like(p)).contiguous(),
                to_dev(o))

    cases = {}
    for name, (r, v, o) in binned(windows, events, height, width, bins,
                                  seed).items():
        tile = name == "B3"
        cases[name] = (voxel_tiled.voxelize_tiled if tile
                       else voxel_folded.voxelize_folded,
                       columns(r, v, o, tile), kw, int(o[:, -1].sum()),
                       o.size, 0 if tile else 3)
    return cases


def outputs(fn, cols, kw) -> tuple:
    out = fn(*cols, **kw)
    return out if isinstance(out, tuple) else (out,)


def repeat_check(fn, cols, kw, n: int) -> dict:
    """``n`` launches on one input: whether every launch's outputs equal
    the first's bit for bit, and how many elements differ at most."""
    first = outputs(fn, cols, kw)
    worst = 0
    for _ in range(n - 1):
        for a, b in zip(first, outputs(fn, cols, kw)):
            worst = max(worst, int((a.view(torch.int32)
                                    != b.view(torch.int32)).sum()))
    return {"launches": n, "bit_for_bit": worst == 0,
            "max_elements_differing": worst}


def step_rates(device, iters: int) -> list:
    """Eval and train (int8 cell) windows/s at ``bench.py``'s shape."""
    from ess_tpu_torch import bench

    batch = bench.make_batch(0, bench.BATCH, device)
    _, eval_step = bench.build_eval(bench.BATCH, device)
    rows = [("eval", bench.windows_per_sec(eval_step, None, batch, iters))]
    del eval_step
    _, state, train_step = bench.build_train(bench.make_cfg(bench.BATCH),
                                             device)
    rows.append(("train", bench.windows_per_sec(train_step, state, batch,
                                                iters)))
    return [{"step": name, "windows_per_sec": round(wps, 2),
             "ms_per_step": round(
                 1e3 * bench.BATCH * bench.WINDOWS / wps, 3)}
            for name, wps in rows]


def main(argv=None, device: Optional[str] = None,
         shape: Optional[tuple] = None) -> dict:
    """Run the tool; returns {case: [its lines]} (and ``"steps"`` with
    ``--steps``). ``shape`` (windows, events, height, width) replaces the
    DSEC shape (the CPU tests' tiny one)."""
    from ess_tpu_torch import resolve_device
    from ess_tpu_torch.ops import voxel_scatter
    from ess_tpu_torch.tools import device_line, time_best

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    windows, events, height, width = shape or (args.windows, 100_000, 480,
                                               640)
    print(device_line(dev), flush=True)
    card = None
    if cuda:
        from ess_tpu_torch.bench import card as card_name
        from ess_tpu_torch.tools.bench_voxel import device_ms
        card = card_name()
    cases = make_cases(dev, windows, events, height, width)
    variants = [{}] if args.quick or not cuda else (
        [{}] + [{"threads": t} for t in voxel_scatter.THREADS])
    out = {}
    for name in CASES:
        fn, cols, kw, records, n_offs, stats = cases[name]
        n_out = windows * kw["bins"] * kw["height"] * kw["width"] \
            + windows * stats
        bound_ms = 1e3 * (16.0 * records + 4.0 * n_offs + 4.0 * n_out) \
            / HBM_BYTES_PER_S
        lines = []
        for var in variants:
            orig = voxel_scatter.scatter_plan
            if var:
                voxel_scatter.scatter_plan = functools.partial(orig, **var)
            try:
                plan = orig(kw["bins"], kw["height"], kw["width"], windows,
                            mode="band" if name == "B3-legacy" else "tile",
                            **var)
                run_one = lambda: fn(*cols, **kw)
                ms = (device_ms(run_one, args.calls) if cuda
                      else time_best(run_one, dev))
                rep = repeat_check(fn, cols, kw, args.repeat)
            finally:
                voxel_scatter.scatter_plan = orig
            line = {"kernel": name, "windows": windows, "records": records,
                    "threads": plan.threads, "plan": "default" if not var
                    else "forced", "blocks_per_sm": plan.blocks_per_sm,
                    ("device_ms" if cuda else "host_ms"): round(ms, 4),
                    "bound_ms": round(bound_ms, 4),
                    "share_of_bound": round(bound_ms / ms, 4) if cuda
                    else None,
                    "repeat": rep, "device": card or str(dev)}
            print(json.dumps(line), flush=True)
            lines.append(line)
        out[name] = lines
    if args.steps:
        if not cuda:
            raise ValueError("bench_kernel --steps: the step rates are "
                             "read on the card only")
        out["steps"] = step_rates(dev, args.iters)
        for line in out["steps"]:
            print(json.dumps({**line, "device": card}), flush=True)
    return out


if __name__ == "__main__":
    main()
