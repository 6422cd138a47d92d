"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. Everything is
found by name: the cell ``benchmark/workloads/<cell>.json`` names its
configuration (``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``, whose ``step`` picks the driver
``benchmark/drivers/<step>.py``, which also counts a request's windows and
work) and the limits of its check; each metric ``BENCHMARK.json`` gives the
cell is read by ``benchmark/metrics/<name>.py``.

A run: loads the program's kernels (built once per checkout into its
``build/`` directory) and makes seeded weights and traffic; drives the
program through its checked requests and warms up the cell's shapes (all
of this is ``setup_s``); serves requests one after another for
``--seconds``; with ``--trace 1`` then traces a few more requests; frees the
program's state and compares what the window's path produced with the
plain reference (``benchmark/reference``). The last lines on standard
error, and the ``checks`` key that ends the result line, give each number
compared beside its limit. The run fails, printing no result, without a
CUDA device or with fewer than the cell asks for, for a cell that states no
limits, and if JAX, flax or the JAX package (``ess_tpu``) is loaded after
set-up or once everything after the window (the reference, the comparison,
the metric reads) is done.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time
from types import SimpleNamespace
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ess_tpu")


def process_seconds() -> float:
    """Seconds since this process started (the kernel's start time of the
    process against the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's, flax's or the
    JAX package's (``ess_tpu_torch`` is not ``ess_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def refuse_forbidden() -> None:
    """End the run, with no result, where a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: forbidden modules loaded: {found}")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(workload: str) -> SimpleNamespace:
    """The cell, its configuration and its traffic, by name."""
    cell = load_json(HERE, "workloads", workload + ".json")
    return SimpleNamespace(
        name=workload, cell=cell,
        conf=load_json(HERE, "configs", cell["config"] + ".json"),
        traffic=load_json(HERE, "traffic", cell["traffic"] + ".json"))


def metric_names(workload: str, trace: bool) -> list:
    """The cell's metrics in ``BENCHMARK.json``: its end-to-end ones, or
    with ``trace`` its per-layer ones."""
    bench = load_json(ROOT, "BENCHMARK.json")
    key = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in bench[key]
            if workload in m.get("workloads", [workload])]


def cache_dirs() -> None:
    """Fixed cache directories inside the checkout for the libraries that
    compile on first use."""
    base = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device, metrics: list, start_s: float = 0.0,
        files: Optional[SimpleNamespace] = None) -> dict:
    """One run of ``workload`` on ``device``; ``start_s`` the seconds the
    process had run before. Tests pass ``files``, a small cell as
    :func:`cell_files` gives it. Returns the result line's fields and the
    checks."""
    import torch

    from benchmark import check
    from benchmark import trace as tracing
    from benchmark.reference.precision import f32_matmuls

    t0 = time.perf_counter()
    files = files or cell_files(workload)
    limits = files.cell.get("limits")
    if not limits:
        raise SystemExit(f"benchmark: the cell {workload!r} states no "
                         f"limits for its check")
    step = files.traffic["step"]
    drivers = importlib.import_module(f"benchmark.drivers.{step}")
    per_request = drivers.Driver.windows_per_request(files.conf,
                                                     files.traffic)
    layers = drivers.Driver.work(files.conf, files.traffic)
    driver = drivers.Driver(files.conf, files.traffic, device)
    driver.prepare(seed & (2 ** 63 - 1))
    for _ in range(files.traffic.get("warmup", 1)):
        driver.request()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    refuse_forbidden()
    setup_s = start_s + time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    latencies = []
    failed_before = driver.failed
    w0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        driver.request()
        te = time.perf_counter()
        latencies.append(te - ts)
        if te - w0 >= seconds:
            break
    elapsed = te - w0
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = SimpleNamespace(
        cell=files.cell, conf=files.conf, traffic=files.traffic,
        setup_s=setup_s, work=layers,
        window={"latencies_s": latencies, "seconds": elapsed,
                "windows": len(latencies) * per_request,
                "seconds_per_request": elapsed / len(latencies),
                "peak_bytes": peak_window},
        trace=None)
    if trace:
        ctx.trace = tracing.summarize(tracing.profile(
            driver.request, files.traffic.get("traced", 3)))
    failed = driver.failed - failed_before
    driver.release()
    with f32_matmuls():
        numbers = driver.compare(driver.program_outputs(),
                                 driver.reference())
    correct = check.judge(numbers, limits) and driver.failed == 0
    values = {}
    for name in metrics:
        v = importlib.import_module(f"benchmark.metrics.{name}").read(ctx)
        if v is not None:
            values[name] = v
    units = {m["name"]: m["unit"]
             for key in ("end_to_end", "per_layer")
             for m in load_json(ROOT, "BENCHMARK.json")[key]}
    out = {"correct": bool(correct), "attempted": len(latencies),
           "failed": failed,
           "metrics": {k: {"value": v, "unit": units.get(k, "")}
                       for k, v in values.items()},
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": (torch.cuda.get_device_name(device) if cuda
                               else "cpu"),
                      "count": 1,
                      "memory_peak_bytes": max(peak_setup, peak_window)}}
    if trace:
        out["device"]["busy_s"] = ctx.trace["busy_s"]
        out["device"]["window_s"] = ctx.trace["window_s"]
        out["breakdown"] = ctx.trace["breakdown"]
    out["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                          else str(numbers[k]), "limit": lim}
                     for k, lim in limits.items()}
    refuse_forbidden()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: the cell needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              device=torch.device("cuda", 0),
              metrics=metric_names(args.workload, bool(args.trace)),
              start_s=process_seconds())
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
