"""Device time of the voxelizers at their paths' shapes.

B1 (the fold-free x-slot voxelizer, ``ops.voxel_folded.voxelize_folded``)
over one eval or train step's 160 windows (B=8 x T=20) and over 40;
B3-legacy (the same entry on the full-width band wire, records of
``host_band_bin_folded(x_slots=False)``) over the same 160 and 40
windows; B3 (the halo-tiled voxelizer, ``ops.voxel_tiled.voxelize_tiled``)
over one streaming call's 8 windows (B=8) and 1 window (B=1). Inputs are
seeded DSEC windows of 100k events on 480x640 (``bench.make_raw``), binned
on the host as the paths bin them, so that two trees can be compared in one
call:

    python ess_tpu_torch/tools/bench_voxel.py [--root DIR] [--calls N]
        [--variants] [--attribute]

``--root`` imports ``ess_tpu_torch`` from another checkout (an earlier tree
unpacked with ``git archive``; default: the checkout that holds this file).
Device ms per call: CUDA events over ``--calls`` calls after a warm-up, the
best of three such runs, each behind a spin kernel that holds the stream
while the host enqueues the calls, so the host's cost does not enter the
reading. Host us per call: the wall time of each of 2,000 calls (wrapper,
plan, allocation, launch) enqueued while a longer spin kernel holds the
card, its median and its 10th percentile (the host is shared, so bursts of
other work inflate some calls; the low percentile reads the call's own
cost). The bound is the least time for
the bytes (each event or record read once, the offsets, the grid and B1's
stats written once) over 3.35 TB/s. On a tree with the scatter core (``ops/voxel_scatter.py``),
``--variants`` also times both block sizes of its plan, and
``--attribute`` builds the core with parts left out (the neighbours'
gathers, the deposits, the tile stores: ``VOXEL_SCATTER_SKIP`` of
``csrc/voxel_scatter.cuh``) and times each build at the default plans.
One JSON line per kernel, shape and variant, with the card's name and
power limit.
"""

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import time

SPIN_CYCLES = 50_000_000   # ~25 ms of a spin kernel at the H100's clocks
HOST_SPIN_CYCLES = 200_000_000   # ~100 ms: longer than 500 calls' enqueue
HOST_CALLS = 2_000
HBM_BYTES_PER_S = 3.35e12
# VOXEL_SCATTER_SKIP values: bit 1 the neighbours' gathers, 2 the
# deposits, 4 the tile stores
ATTRIBUTION = {0: "full", 1: "no gathers", 2: "no deposits",
               4: "no stores", 6: "no deposits, no stores"}


def attribution_libs(kernels) -> dict:
    """The two voxelizer sources built once per ``ATTRIBUTION`` value, all
    at once, into the build directory; ctypes libraries by value."""
    srcs = [os.path.join(kernels.CSRC, f) for f in ("voxel_folded.cu",
                                                    "voxel_tiled.cu")]
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    paths = {k: os.path.join(kernels.BUILD_DIR, f"attr_voxel_{k}.so")
             for k in ATTRIBUTION}
    procs = {k: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
         f"-DVOXEL_SCATTER_SKIP={k}", *srcs, "-o", path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, path in paths.items()}
    libs = {}
    for k, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for VOXEL_SCATTER_SKIP={k}:\n"
                               + err)
        lib = ctypes.CDLL(paths[k])
        kernels.voxel_argtypes(lib)
        libs[k] = lib
    return libs


def device_ms(run_one, calls: int) -> float:
    """Device ms a call of ``run_one``: CUDA events over ``calls`` calls
    after three warm-up calls, the best of three such runs, each behind a
    spin kernel that holds the stream while the host enqueues the calls, so
    the host's cost does not enter the reading."""
    import torch

    for _ in range(3):
        run_one()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        for _ in range(calls):
            run_one()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / calls)
    return best


def host_call_us(run_one) -> tuple:
    """(median, 10th percentile) host us of a call of ``run_one`` over
    HOST_CALLS calls enqueued while a longer spin kernel holds the card."""
    import torch

    host = []
    for _ in range(HOST_CALLS // 500):
        torch.cuda._sleep(HOST_SPIN_CYCLES)
        for _ in range(500):
            t0 = time.perf_counter()
            run_one()
            host.append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    host.sort()
    return statistics.median(host), host[len(host) // 10]


def main(argv=None) -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--attribute", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_voxel: no CUDA device")
    from ess_tpu_torch import bench, kernels
    from ess_tpu_torch.ops import voxel_folded, voxel_tiled
    from ess_tpu_torch.ops.voxel import masked_time_norm

    dev = torch.device("cuda", 0)
    card = bench.card()
    h, w, bins = bench.SENSOR_H, bench.SENSOR_W, bench.BINS
    th = voxel_folded.tile_h_for_bins(bins)
    hp = -(-h // th) * th
    rng = np.random.default_rng(0)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def columns(r, v, o, signed):
        x, y, t, p = (to_dev(r[..., i]) for i in range(4))
        vd = to_dev(v)
        ts = masked_time_norm(t, vd, bins).contiguous()
        if signed:        # raw events: +-1 polarity
            p = torch.where(p > 0, 1.0, -1.0)
        pol = torch.where(vd, p, torch.zeros_like(p)).contiguous()
        return x, y, ts, pol, to_dev(o)

    raw, valid = bench.make_raw(rng, 8)
    raw = raw.reshape(-1, *raw.shape[2:])
    valid = valid.reshape(-1, valid.shape[-1])
    folded = voxel_folded.host_band_bin_folded(raw, valid, height=h,
                                               width=w, bins=bins)
    bands = voxel_folded.host_band_bin_folded(raw, valid, height=h,
                                              width=w, bins=bins,
                                              x_slots=False)
    tiled = voxel_tiled.host_tile_bin(raw[:8], valid[:8], height=h,
                                      width=w, bins=bins)
    kw = dict(bins=bins, height=hp, width=w)
    cases = []
    for n_win in (160, 40):
        r, v, o = (a[:n_win] for a in folded)
        cases.append(("B1", n_win, voxel_folded.voxelize_folded,
                      columns(r, v, o, False), o, 3))
    for n_win in (160, 40):
        r, v, o = (a[:n_win] for a in bands)
        cases.append(("B3-legacy", n_win, voxel_folded.voxelize_folded,
                      columns(r, v, o, False), o, 3))
    for n_win in (8, 1):
        r, v, o = (a[:n_win] for a in tiled)
        cases.append(("B3", n_win, voxel_tiled.voxelize_tiled,
                      columns(r, v, o, True), o, 0))

    def timed(fn, cols):
        run_one = lambda: fn(*cols, **kw)
        return (device_ms(run_one, args.calls), *host_call_us(run_one))

    try:
        from ess_tpu_torch.ops import voxel_scatter
    except ImportError:          # a tree from before the scatter core
        voxel_scatter = None
    variants = [{}]
    if voxel_scatter is not None and args.variants:
        variants += [{"threads": t} for t in voxel_scatter.THREADS]
    if voxel_scatter is not None and args.attribute:
        libs = attribution_libs(kernels)
        variants += [{"skip": k} for k in ATTRIBUTION]
    own_lib = kernels.get_lib
    for name, n_win, fn, cols, o, stats in cases:
        n_out = n_win * bins * hp * w + n_win * stats
        nbytes = 16.0 * int(o[:, -1].sum()) + 4.0 * o.size + 4.0 * n_out
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        for var in variants:
            orig = voxel_scatter.scatter_plan if voxel_scatter else None
            if "threads" in var:
                voxel_scatter.scatter_plan = functools.partial(
                    orig, threads=var["threads"])
            if "skip" in var:
                kernels.get_lib = lambda: libs[var["skip"]]
            try:
                ms, host_us, host_p10 = timed(fn, cols)
            finally:
                if voxel_scatter is not None:
                    voxel_scatter.scatter_plan = orig
                kernels.get_lib = own_lib
            line = {"root": root, "kernel": name, "windows": n_win,
                    "records": int(o[:, -1].sum()), **var}
            if "skip" in var:
                line["build"] = ATTRIBUTION[var["skip"]]
            line.update(device_ms_per_call=round(ms, 4),
                        host_us_per_call=round(host_us, 2),
                        host_us_per_call_p10=round(host_p10, 2),
                        bound_ms=round(bound_ms, 4),
                        share_of_bound=round(bound_ms / ms, 4), device=card)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
