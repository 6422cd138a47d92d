"""The traced stretch of a ``--trace 1`` run and what is read from it.

``torch.profiler`` traces a few requests after the window: one warm-up
request under the profiler (right after the tracer starts, the card's first
launches can go unrecorded), then ``active`` requests, each closed by a
profiler step. From the Chrome trace:

- busy time: the union of the kernel, copy and set intervals (the port's
  ``bench.py::trace_summary`` arithmetic), within the active requests'
  host span, which is the traced window;
- a layer's device time, for every folder ``benchmark/kernels/<layer>/``:
  the kernels whose names match the layer's patterns (every file of the
  folder). Where the
  profiler dropped launches, a request records fewer of the layer's
  launches than another: the layer's time a request is its mean time a
  recorded launch times the most launches any traced request recorded;
- the breakdown: the device operations that took most time, and the idle
  gaps by the host operation that ran across each gap's middle.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
from typing import Callable, List, Optional

import torch

KERNELS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kernels")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_layers() -> List[str]:
    """The layers that ``benchmark/kernels/`` names, one a folder."""
    return sorted(d for d in os.listdir(KERNELS_DIR)
                  if os.path.isdir(os.path.join(KERNELS_DIR, d)))


def layer_patterns(layer: str) -> List[re.Pattern]:
    """The union of the pattern files of ``kernels/<layer>/`` (one regular
    expression a line; ``#`` starts a comment)."""
    folder = os.path.join(KERNELS_DIR, layer)
    out = []
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    out.append(re.compile(line))
    return out


def profile(request: Callable[[], None], active: int) -> dict:
    """Trace one warm-up and ``active`` requests; returns the Chrome
    trace's events (written to and read back from a temporary file)."""
    from torch.profiler import ProfilerActivity, profile as prof_, schedule

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=active,
                                     repeat=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(path)
                   ) as prof:
            for _ in range(1 + active):
                request()
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _union(spans) -> list:
    """The intervals' union as sorted disjoint intervals."""
    spans = sorted(spans)
    cur_s = cur_e = None
    merged = []
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
    return merged


def summarize(events: list, top: int = 10) -> dict:
    """Busy and window seconds, each layer's device seconds a request (the
    launch-count guard of the module docstring), the breakdown, and the
    traced window's device and host events (``device``, ``host``) for the
    metrics that read more."""
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and str(e.get("name", "")).startswith("ProfilerStep#"))
    if not steps:
        raise RuntimeError("the trace holds no profiler steps")
    w0, w1 = steps[0][0], steps[-1][1]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) <= w1]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    merged = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in dev)
    busy = sum(e - s for s, e in merged)
    layer_s = {}
    for layer in kernel_layers():
        pats = layer_patterns(layer)
        mine = [e for e in dev if any(p.search(e["name"]) for p in pats)]
        if not mine:
            continue
        counts = [sum(1 for e in mine if s <= float(e["ts"]) <= t)
                  for s, t in steps]
        per_launch = sum(float(e["dur"]) for e in mine) / len(mine)
        layer_s[layer] = per_launch * max(counts) / 1e6
    by_op = collections.Counter()
    for e in dev:
        by_op[e["name"]] += float(e["dur"]) / 1e6
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "cuda_runtime", "python_function")
            and w0 <= float(e["ts"]) <= w1]
    gaps = collections.Counter()
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_at(host, 0.5 * (a + b))] += (b - a) / 1e6
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "requests": len(steps), "layer_s": layer_s,
            "device": dev, "host": host,
            "breakdown": {"device_ops": [[n[:200], s] for n, s in
                                         by_op.most_common(top)],
                          "idle_gaps": [[n, s] for n, s in
                                        gaps.most_common(top)]}}


def _host_at(host: list, t: float) -> str:
    """The innermost host operation running at ``t``."""
    best: Optional[dict] = None
    for e in host:
        s = float(e["ts"])
        if s <= t <= s + float(e["dur"]):
            if best is None or float(e["dur"]) < float(best["dur"]):
                best = e
    return "host: no recorded op" if best is None else str(best["name"])[:200]


def layer_share(ctx, layer: str, work=None) -> Optional[float]:
    """A layer's roofline share in %: the least time of its work a request
    (``work``, by default the driver's count for the layer) over its device
    time a request; None where the trace holds none of its kernels."""
    t = ctx.trace["layer_s"].get(layer)
    if not t:
        return None
    if work is None:
        if layer not in ctx.work:
            raise KeyError(f"the step kind counts no work for {layer!r}")
        work = ctx.work[layer]
    return 100.0 * work.least_seconds() / t
