"""Process-group initialization and cross-process host utilities.

Counterpart of ``ess_tpu/parallel/multihost.py``. Usage, one process per
device (the launcher of :mod:`ess_tpu_torch.parallel.launch`, or
``torchrun --nproc_per_node N``, which sets the environment read here):

    from ess_tpu_torch.parallel import make_group, multihost
    multihost.initialize()              # init_process_group
    group = make_group()                # every rank's device

With one process per device each rank keeps its own rows of a batch
(``data/loader.py``'s ``replica``). :func:`global_batch_from_local` is the
JAX package's assembly of the global batch from every process's local
rows: where JAX builds one array sharded over the mesh, each rank here
gets the whole global batch, every leaf's rows all-gathered and
concatenated in rank order on the rank's device.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ess_tpu_torch import resolve_device
from ess_tpu_torch.parallel import dp

TIMEOUT = timedelta(minutes=10)   # of a collective that waits on a rank


def from_torchrun() -> bool:
    """The process was started by ``torchrun`` (or sets its variables)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: str = "gloo") -> None:
    """``init_process_group`` with ``backend`` from the explicit arguments
    (``init_method`` such as ``file://...`` or ``tcp://host:port``,
    ``world_size``, ``rank``), else from ``torchrun``'s environment; a
    no-op without either, or when a process group exists. Explicit
    arguments that fail to join raise: a run asked for a topology must not
    go on as a single process."""
    if dist.is_initialized():
        return
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if not explicit and not from_torchrun():
        return
    if explicit and None in (init_method, world_size, rank):
        raise ValueError("initialize: give init_method, world_size and rank "
                         "together")
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size if explicit else -1,
        rank=rank if explicit else -1, timeout=TIMEOUT)


def process_shard() -> tuple[int, int]:
    """(rank, world size) of this process: its share of the data, as the
    JAX package's (process index, process count)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def all_reduce_host(value: np.ndarray) -> np.ndarray:
    """Sum a small host array (e.g. a confusion matrix) over the ranks of
    the active data-parallel group."""
    return dp.host_sum(value)


def _gather(t: torch.Tensor, group: dp.Group) -> torch.Tensor:
    """Every rank's ``t`` (all the same shape) concatenated in rank order
    (through the host where gloo meets a CUDA tensor)."""
    src = t.cpu() if group.backend == "gloo" and t.is_cuda else t
    parts = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(parts, src.contiguous(), group=group.pg)
    return torch.cat(parts).to(t.device)


def global_batch_from_local(local_batch: Any, device=None) -> Any:
    """The global batch from every rank's local rows: each leaf (a numpy
    array or tensor, in nested dicts, lists and tuples) of ``local_batch``
    as a tensor on ``device`` (None: the active group's, else the first
    CUDA device), its rows all-gathered from the ranks of the active
    data-parallel group and concatenated in rank order. Every rank passes
    leaves of the same shapes. On a world of one it is the local batch on
    that device."""
    group = dp.active()
    if device is None and group is not None:
        device = group.device
    dev = resolve_device(device)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        t = torch.as_tensor(x).to(dev)
        return t if dp.world() == 1 else _gather(t, group)

    return put(local_batch)
