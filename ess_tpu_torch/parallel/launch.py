"""Start N data-parallel ranks, one process each.

:func:`spawn` starts ``world`` processes with the spawn start method. Each
one joins a process group through a ``file://`` store in a fresh
directory (no TCP port to collide with another run), makes the
data-parallel group (``dp.make_group``), runs ``fn(*args)`` and saves what
it returns; ``spawn`` returns the ranks' results in rank order. A rank
that fails stops the others, and ``spawn`` raises with its traceback.
``fn`` must be importable by name in a new interpreter: a module-level
function of a module, as the train CLI's rank worker and
:func:`ess_tpu_torch.parallel.steps.run_steps` are, or of the running
script, which each child imports again (so it must guard its entry point
with ``if __name__ == "__main__"`` and not be read from stdin). A world of one runs
in the calling process, its group a world of one of the same backend.

Ranks on the CPU share the parent's torch threads: each takes
``max(1, threads // world)``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp

from ess_tpu_torch.parallel import dp, multihost


def _rank_main(rank: int, world: int, store: str, backend: str, device,
               threads: Optional[int], fn: Callable, args: Sequence,
               out_dir: str) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    multihost.initialize(f"file://{store}", world, rank, backend)
    try:
        dp.make_group(world, device=device, backend=backend)
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        # no rank tears the group down before every rank is done: a gloo
        # rank that closes its connections while another still completes
        # the last collective can abort that one
        dp.barrier()
    finally:
        dp.release()


def spawn(fn: Callable, world: int, args: Sequence = (), *, device=None,
          backend: Optional[str] = None) -> list:
    """Run ``fn(*args)`` on ``world`` ranks and return their results.
    ``device`` None gives rank r ``cuda:r``; a named device (``"cpu"``,
    or one card for gloo ranks) is every rank's. ``backend`` defaults to
    NCCL on CUDA and gloo on the CPU."""
    dev = None if device is None else torch.device(device)
    backend = backend or dp.default_backend(dev or torch.device("cuda"))
    threads = (max(1, torch.get_num_threads() // world)
               if dev is not None and dev.type == "cpu" else None)
    tmp = tempfile.mkdtemp(prefix="ess_dp_")
    try:
        if world == 1:   # a world of one runs in this process
            multihost.initialize(f"file://{tmp}/store", 1, 0, backend)
            try:
                dp.make_group(1, device=device, backend=backend)
                return [fn(*args)]
            finally:
                dp.release()
        mp.start_processes(
            _rank_main, nprocs=world, start_method="spawn", join=True,
            args=(world, os.path.join(tmp, "store"), backend, device,
                  threads, fn, tuple(args), tmp))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
