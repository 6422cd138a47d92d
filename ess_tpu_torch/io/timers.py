"""Region timers and profiler hooks.

Counterpart of ``ess_tpu/io/timers.py``: context managers that accumulate
per-region wall times and report their means at exit. ``sync`` waits for
the device before the clock stops (``torch.cuda.synchronize`` of the device
a tensor lies on; nothing on the CPU), and :func:`trace` records a
``torch.profiler`` Chrome trace under ``log_dir``.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import torch

_ACCUM: Dict[str, list] = defaultdict(list)
_PROFILER: Optional[Any] = None
_PROFILE_DIR: Optional[str] = None


def _cuda_devices(tree: Any, found: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (tensors, or dicts,
    lists and tuples of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def synchronize(tree: Any) -> None:
    """Wait for every CUDA device a tensor of ``tree`` lies on."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock region timer: ``with Timer('voxelize'): ...``.

    Pass ``sync=x`` (a tensor, or a dict, list or tuple of them) to wait
    for the device before stopping the clock."""

    def __init__(self, name: str, sync: Any = None):
        self.name = name
        self.sync = sync

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            synchronize(self.sync)
        _ACCUM[self.name].append(time.perf_counter() - self.t0)
        return False


@contextlib.contextmanager
def timed_scope(name: str) -> Iterator[None]:
    with Timer(name):
        yield


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace of the CPU and, where there is
    one, the CUDA device; :func:`stop_trace` writes it to
    ``log_dir/trace.json``."""
    global _PROFILER, _PROFILE_DIR
    from torch.profiler import ProfilerActivity, profile

    if _PROFILER is not None:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _PROFILER = profile(activities=activities)
    _PROFILE_DIR = log_dir
    _PROFILER.__enter__()


def stop_trace() -> str:
    """Stop the running trace and write it; returns the trace's path."""
    global _PROFILER, _PROFILE_DIR
    prof, log_dir = _PROFILER, _PROFILE_DIR
    if prof is None:
        raise RuntimeError("no trace is running")
    _PROFILER = _PROFILE_DIR = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written under ``log_dir``
    (open ``trace.json`` in Perfetto or ``chrome://tracing``)."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def timer_report() -> Dict[str, float]:
    """Mean seconds per region."""
    return {k: sum(v) / len(v) for k, v in _ACCUM.items() if v}


def reset_timers() -> None:
    _ACCUM.clear()


@atexit.register
def _print_report() -> None:
    rep = timer_report()
    if rep:
        print("== ess-tpu timing report ==")
        for name, mean_s in sorted(rep.items()):
            n = len(_ACCUM[name])
            print(f"  {name}: {1000 * mean_s:.2f} ms (n={n})")
