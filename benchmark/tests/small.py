"""Small cells for the CPU tests: the DDD17 configuration (the smallest
sensor the program's pipelines take) at a few windows and events."""

from __future__ import annotations

import copy
from types import SimpleNamespace

from benchmark.run import cell_files


def small_files(workload: str, *, config: str = "ess_ddd17", batch: int = 2,
                windows: int = 2, events: int = 2000) -> SimpleNamespace:
    files = cell_files(workload)
    conf = copy.deepcopy(cell_files("ddd17_sup_train_b16").conf
                         if config == "ess_ddd17" else files.conf)
    conf.update(batch=batch, windows=windows, events_per_window=events)
    traffic = dict(files.traffic, warmup=0)
    if "streams" in traffic:
        traffic.update(streams=batch, windows_per_segment=windows)
    return SimpleNamespace(name=workload, cell=copy.deepcopy(files.cell),
                           conf=conf, traffic=traffic)
