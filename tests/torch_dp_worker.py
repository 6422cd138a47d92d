"""What the data-parallel tests' ranks run (spawned by
``parallel.launch.spawn``; this module imports no JAX, so a rank starts
fast)."""

from typing import List

from ess_tpu_torch.ops import conv_lstm
from ess_tpu_torch.parallel import dp
from ess_tpu_torch.parallel.steps import run_steps


def int8_routes(cases: List[tuple]) -> List[str]:
    """``conv_lstm.int8_route(impl, shape)`` of each ``(impl, shape)``: a
    local NCHW ``shape`` routed as this rank's cells and block convs route
    it (by the global shape)."""
    assert dp.world() > 1
    return [conv_lstm.int8_route(impl, shape) for impl, shape in cases]


def run_specs(specs: List[dict], routes: List[tuple] = ()) -> tuple:
    """``run_steps`` of each spec in turn, and :func:`int8_routes` of
    ``routes``: one launch for many."""
    return [run_steps(s) for s in specs], int8_routes(list(routes))


def global_batches(local_batches: List[dict]) -> dict:
    """``multihost.global_batch_from_local`` of this rank's entry of
    ``local_batches`` (one a rank)."""
    from ess_tpu_torch.parallel import multihost
    return multihost.global_batch_from_local(local_batches[dp.rank()])
