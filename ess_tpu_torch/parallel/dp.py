"""Data parallel over ``torch.distributed``, one process per device.

Counterpart of ``ess_tpu/parallel/dp.py``. The JAX package replicates the
train state over a 1-D mesh and shards every batch on its leading axis;
GSPMD then makes every reduction over the batch axis global. Here each
device is one process, a rank, that holds a replica of the state and its
rows ``[r*B/N, (r+1)*B/N)`` of each global batch of B rows, and the steps
make their batch-wide reductions global through the collectives below:

- :func:`all_sum`: the loss sums and counts and the batch-norm statistics;
- :func:`all_max`: the int8 cells' and convs' x absmax;
- :func:`average_gradients`: the parameter gradients before each update;
- :func:`global_shape`: the global batch's shape, which the int8 size rule
  (``ops/conv_lstm.py::int8_route``), the losses' means and the batch
  norm's counts read.

A global batch splits evenly over the ranks, as the JAX package's mesh
requires (its ``shard_batch`` raises on a batch that does not divide):
:func:`check_divides`, :func:`shard_batch` and the loaders raise
otherwise, so a rank's B/N rows give the global shape with no
collective.

:func:`make_group` makes the process's data-parallel group and activates
it; the collectives act on the active group. The group is state of the
process, as ``torch.distributed``'s default group is: the layers that
reduce (the losses, the image front's batch norm, the int8 cells and
convs) read it here instead of through every module's arguments. Without
a group, or on a world of one, the collectives are identities and run no
collective, so a world of one computes what one device computes, bit for
bit.

Gradients: every rank computes the same (replicated) loss from the global
sums, and the backward of :func:`all_sum` sums the upstream gradients over
the ranks, so a rank's gradient of a parameter is N times its rows' share
of the global batch's gradient, and :func:`average_gradients` turns the N
shares into that gradient on every rank. (A sum-backward is what a
statistic used by rank-local layers needs, such as a batch-norm mean: the
loss depends on it through every rank's rows.)

NCCL moves CUDA tensors, gloo CPU tensors; a gloo group given CUDA tensors
(ranks that share one card) stages them through the host. Host arrays (a
confusion matrix, embeddings) go through a gloo group in every case, so
they never wait on the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class Group:
    """A data-parallel group: this process's ``rank`` of ``world``, its
    ``device``, the collective ``backend`` and the process groups (``pg``
    for device tensors, ``host_pg``, gloo, for host arrays)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    pg: object
    host_pg: object


_ACTIVE: Optional[Group] = None


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_size(num_devices: int, device=None) -> int:
    """The number of ranks ``num_devices`` asks for: -1 is every visible
    CUDA device. With no ``device`` each rank takes a CUDA device of its
    own, and asking for more than exist raises (a quietly smaller world
    would "pass" a multi-device run on one device); a named ``device``
    (``"cpu"``, or one card that gloo ranks share) takes any positive
    count, and -1 raises there."""
    if num_devices == 0 or num_devices < -1:
        raise ValueError(f"num_devices={num_devices}: data parallel takes "
                         "N >= 1 ranks, or -1 for every CUDA device")
    if device is not None:
        if num_devices == -1:
            raise ValueError(
                f"num_devices=-1 counts CUDA devices; on device {device} "
                "name the number of ranks")
        return num_devices
    n = torch.cuda.device_count()
    if num_devices == -1:
        if n == 0:
            raise ValueError("num_devices=-1 but no CUDA device exists")
        return n
    if num_devices > n:
        raise ValueError(
            f"requested {num_devices} data-parallel devices but only {n} "
            f"CUDA device(s) exist; pass device='cpu' to run CPU ranks")
    return num_devices


def make_group(num_devices: int = -1, *, device=None,
               backend: Optional[str] = None) -> Group:
    """The data-parallel group over the ranks of the initialized default
    process group (``multihost.initialize``, or the launcher), activated
    for the collectives of this module: the counterpart of JAX's
    ``make_mesh``, and :func:`row_range` of its ``batch_sharding``. ``num_devices`` must be -1 or the
    world size. Each rank runs on ``cuda:<LOCAL_RANK>`` (the rank on one
    host) unless ``device`` names a device for every rank; ``backend``
    defaults to NCCL on CUDA and gloo on the CPU, and ranks that share one
    card need gloo."""
    global _ACTIVE
    if not dist.is_initialized():
        raise RuntimeError("make_group needs torch.distributed initialized "
                           "(parallel.multihost.initialize)")
    rank, world = dist.get_rank(), dist.get_world_size()
    if num_devices not in (-1, world):
        raise ValueError(f"num_devices={num_devices} but the process group "
                         f"has {world} ranks")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"rank {rank} needs CUDA device {local} but only "
                f"{torch.cuda.device_count()} exist")
        device = torch.device("cuda", local)
        shared = False
    else:
        device = torch.device(device)
        shared = device.type == "cuda" and world > 1
    got = dist.get_backend()
    if backend is not None and backend != got:
        raise ValueError(f"backend {backend!r} asked for, but the process "
                         f"group runs {got!r}")
    if shared and got == "nccl":
        raise ValueError(f"{world} ranks share {device}: NCCL needs a device "
                         "a rank; pass backend='gloo'")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    host_pg = (dist.group.WORLD if got == "gloo"
               else dist.new_group(backend="gloo"))
    _ACTIVE = Group(rank, world, device, got, dist.group.WORLD, host_pg)
    return _ACTIVE


def release() -> None:
    """Deactivate the group and destroy the process group."""
    global _ACTIVE
    _ACTIVE = None
    if dist.is_initialized():
        dist.destroy_process_group()


def active() -> Optional[Group]:
    return _ACTIVE


def world() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.world


def rank() -> int:
    return 0 if _ACTIVE is None else _ACTIVE.rank


def _reduce_(t: torch.Tensor, op) -> torch.Tensor:
    """All-reduce ``t`` in place over the active group (a copy through the
    host where gloo meets a CUDA tensor)."""
    g = _ACTIVE
    if g.backend == "gloo" and t.is_cuda:
        host = t.cpu()
        dist.all_reduce(host, op=op, group=g.pg)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=g.pg)
    return t


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _reduce_(x.detach().clone(), dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_(grad.clone(), dist.ReduceOp.SUM)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (``x`` itself on a world of one);
    differentiable, its backward sums the upstream gradients (module
    docstring)."""
    if world() == 1:
        return x
    return _AllSum.apply(x)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (``x`` itself on a
    world of one); no gradient."""
    if world() == 1:
        return x
    return _reduce_(x.detach().clone(), dist.ReduceOp.MAX)


def average_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each gradient, in one all-reduce of a
    flat buffer; the gradients themselves on a world of one."""
    grads = list(grads)
    if world() == 1 or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    _reduce_(flat, dist.ReduceOp.SUM)
    flat /= world()
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


def host_sum(value: np.ndarray) -> np.ndarray:
    """A host array summed over the ranks (through the gloo group); the
    array itself on a world of one."""
    if world() == 1:
        return value
    t = torch.from_numpy(np.ascontiguousarray(value)).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_ACTIVE.host_pg)
    return t.numpy()


def row_range(global_rows: int, r: Optional[int] = None,
              n: Optional[int] = None) -> Tuple[int, int]:
    """Rank ``r``'s rows ``[r*B/N, (r+1)*B/N)`` of a global batch of B
    rows (this rank of the active group by default)."""
    r = rank() if r is None else r
    n = world() if n is None else n
    return r * global_rows // n, (r + 1) * global_rows // n


def check_divides(batch_size: int, n: Optional[int] = None,
                  what: str = "batch size") -> None:
    """Raise unless a global batch of ``batch_size`` rows splits evenly
    over ``n`` ranks (the active group's by default)."""
    n = world() if n is None else n
    if batch_size % n:
        raise ValueError(f"{what} {batch_size} does not divide over {n} "
                         f"data-parallel ranks")


def global_shape(shape) -> tuple:
    """The shape over the whole global batch of a batch-leading local
    ``shape``: its leading dimension times the world size (``shape``
    itself on a world of one)."""
    shape = tuple(shape)
    return (shape[0] * world(),) + shape[1:]


def shard_batch(batch: dict) -> dict:
    """This rank's rows of a global batch: every array or tensor value
    sliced on its leading axis (other values unchanged)."""
    if world() == 1:
        return batch
    rows = {len(v) for v in batch.values()
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim}
    if len(rows) != 1:
        raise ValueError(f"batch leaves disagree on their rows: {rows}")
    n = rows.pop()
    check_divides(n)
    lo, hi = row_range(n)
    return {k: v[lo:hi] if isinstance(v, (np.ndarray, torch.Tensor))
            and v.ndim else v for k, v in batch.items()}


def barrier() -> None:
    if world() > 1:
        dist.barrier(group=_ACTIVE.host_pg)


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (through the host group)."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_ACTIVE.host_pg)
    return box[0]


def gather_rows(local: np.ndarray) -> np.ndarray:
    """Every rank's rows of a host array, concatenated in rank order
    (through the host group); ``local`` itself on a world of one."""
    if world() == 1:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t, group=_ACTIVE.host_pg)
    return torch.cat(parts).numpy()
