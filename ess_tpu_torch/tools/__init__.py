"""Attribution tools of the port: small programs that time one piece of the
rollout on the GPU, counterparts of the JAX package's ``tools/``.

- :mod:`ess_tpu_torch.tools.bench_level`: the fused encoder level beside the
  split path (library stride-2 conv, then the int8 ConvLSTM cell);
- :mod:`ess_tpu_torch.tools.bench_lstm_breakdown`: the ConvLSTM cell kernel
  with its pointwise, its transcendentals or its operand gather taken out;
- :mod:`ess_tpu_torch.tools.bench_head`: the head conv on a C-major window
  with its normalize fused (T1) beside the library conv after a relayout;
- :mod:`ess_tpu_torch.tools.sanity_train`: a supervised overfit of one
  label-correlated batch at the DSEC bench shape (the loss must fall);
- :mod:`ess_tpu_torch.tools.roofline`: the analytic bound of the DSEC
  supervised and UDA train steps (host arithmetic; ``--trace`` puts a
  profile's device time beside its rows);
- :mod:`ess_tpu_torch.tools.bench_kernel` and
  :mod:`ess_tpu_torch.tools.profile_kernel`: the voxelizers alone at 160
  windows over the scatter plan's variants, with a repeat check, and
  their profile;
- :mod:`ess_tpu_torch.tools.bench_lstm` and
  :mod:`ess_tpu_torch.tools.profile_lstm`: the library cell against the
  cell kernels at the three encoder shapes, and their profile;
- :mod:`ess_tpu_torch.tools.bench_increments` and
  :mod:`ess_tpu_torch.tools.bench_uda_increments`: ladders of the config
  levers on the DSEC supervised and UDA train steps.

Each runs on ``cuda:0`` unless called with ``device="cpu"``, where it runs
the kernels' plain versions at whatever small shape the caller passes and
its times are host times of those, not device times. This module holds what
the tools share: argument parsing, the carried chain, the timing and the
profile of one call.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

STEPS = 20     # steps of a carried chain
REPEATS = 3    # timed chains; the best is reported

Step = Callable[[torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor]]


def parse_args(argv: Optional[List[str]]) -> Dict[str, str]:
    """``--key=value`` arguments as a dictionary (the JAX tools' form)."""
    return dict(a.split("=", 1) for a in (argv or []) if "=" in a)


def parse_layers(args: Dict[str, str], n: int) -> List[int]:
    layers = [int(i) for i in args.get("--layers", "0,1,2").split(",")]
    if any(not 0 <= i < n for i in layers):
        raise ValueError(f"--layers {layers} not within 0..{n - 1}")
    return layers


def device_line(device: torch.device) -> str:
    """What the times of a run are times of."""
    if device.type != "cuda":
        return (f"device {device}: plain versions, host clock (no device "
                "time)")
    from ess_tpu_torch.bench import card
    return f"device {card()}: kernels, CUDA events"


def chain(step: Step, h0: torch.Tensor, c0: torch.Tensor, steps: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` carried applications of ``step`` from (h0, c0). The
    kernels update c in place, so the chain works on a copy of c0."""
    h, c = h0, c0.clone(memory_format=torch.preserve_format)
    for _ in range(steps):
        h, c = step(h, c)
    return h, c


def time_best(run: Callable[[], object], device: torch.device,
              repeats: int = REPEATS) -> float:
    """Best time in ms of ``run()`` over ``repeats`` runs after one warm-up
    run: CUDA events on a CUDA device, the host clock on the CPU."""
    cuda = device.type == "cuda"
    run()
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def time_chain(step: Step, h0: torch.Tensor, c0: torch.Tensor, steps: int,
               repeats: int = REPEATS) -> float:
    """Best time in ms of a ``steps``-step chain over ``repeats`` runs after
    one warm-up chain (:func:`time_best`)."""
    return time_best(lambda: chain(step, h0, c0, steps), h0.device, repeats)


def chain_line(name: str, ms: float, steps: int, note: str = "") -> str:
    return (f"  {name:9s}: {ms:7.2f} ms / {steps} steps "
            f"({ms / steps:6.3f} ms/step){note}")


def profile_top(run: Callable[[], object], device: torch.device,
                out_dir: str, name: str, top: int = 12) -> List[dict]:
    """Profile one call of ``run`` (after two warm-up calls) and print its
    top kernels: on a CUDA device ``bench.profile_call`` (device time by
    kernel from the Chrome trace it writes to ``out_dir``, and the idle
    share), on the CPU the profiler's host time by op. Returns the top
    entries (name, ms, calls)."""
    if device.type == "cuda":
        from ess_tpu_torch.bench import profile_call
        res = profile_call(run, out_dir, name, top)
        idle = 100 * res["idle_share"]
        print(f"  {name}: device busy {res['busy_ms']:.3f} ms of a "
              f"{res['span_ms']:.3f} ms span (idle {idle:.1f}%), trace "
              f"{res['trace']}", flush=True)
        rows = [{"name": k["name"], "ms": k["ms"], "calls": k["calls"]}
                for k in res["top"]]
    else:
        from torch.profiler import ProfilerActivity, profile
        for _ in range(2):
            run()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        avg = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        rows = [{"name": e.key, "ms": e.self_cpu_time_total / 1e3,
                 "calls": e.count} for e in avg[:top]]
        print(f"  {name}: host time by op (CPU run, no device)", flush=True)
    for r in rows:
        print(f"    {r['ms']:9.3f} ms {r['calls']:6d} x  {r['name'][:100]}",
              flush=True)
    return rows
