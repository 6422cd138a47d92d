"""Host cost of the ConvLSTM cell launches, and the streaming rate at B=1.

Streaming at B=1 is host-bound (PERF.md, section 5): the card idles while
the host issues the window's launches. This tool reads what one cell call
costs the host beside what it costs the card, and the B=1 streaming rate,
so that two trees can be compared in one call, run after run:

    python ess_tpu_torch/tools/bench_cell_host.py [--root DIR] [--calls N]
        [--rounds N]

``--root`` imports ``ess_tpu_torch`` from another checkout (an earlier tree
unpacked with ``git archive``; default: the checkout that holds this file).
Both trees must have ``models.layers.ConvLSTMCell`` and ``bench``'s
streaming helpers. First, in the fresh process as ``bench.py`` takes it,
the B=1 streaming rate of the default model (``bench.build_stream``,
``bench.stream_windows_per_sec`` over ``--rounds`` passes of 20 windows).
Then, for each encoder cell of a B=1 window (220x320x64, 110x160x128,
55x80x256), exact and int8, through the module a rollout calls
(``ConvLSTMCell.forward``, prepared weights cached):

- host us per call: ``--calls`` calls enqueued back to back after a sync,
  timed on the host clock without a sync (the card runs behind, so this is
  the issue cost alone);
- device ms per call: CUDA events over the same number of calls (where the
  host issues slower than the card runs, this is the host's time too).

One JSON line per reading; the first holds the card's name and power
limit.
"""

import argparse
import json
import os
import sys
import time

LEVELS = ((220, 320, 64), (110, 160, 128), (55, 80, 256))


def cell_times(torch, layers, dev, impl: str, calls: int):
    """(host us, device ms) per call of each encoder cell at B=1."""
    out = []
    g = torch.Generator().manual_seed(0)
    cl_ = torch.channels_last
    for hh, ww, c in LEVELS:
        cell = layers.ConvLSTMCell(c, c, device=dev)
        mk = lambda scale=1.0: (torch.randn(1, c, hh, ww, generator=g)
                                * scale).to(dev, torch.bfloat16).contiguous(
                                    memory_format=cl_)
        x, h, cst = torch.relu(mk()), torch.tanh(mk()), mk()
        state = [(h, cst)]

        def run(n):
            with torch.no_grad():
                for _ in range(n):
                    _, state[0] = cell(x, state[0], impl)

        run(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(calls)
        host_us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        run(calls)
        e1.record()
        torch.cuda.synchronize()
        out.append((f"{hh}x{ww}x{c}", host_us, e0.elapsed_time(e1) / calls))
    return out


def main(argv=None) -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_cell_host: no CUDA device")
    from ess_tpu_torch import bench
    from ess_tpu_torch.models import layers

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    windows = bench.make_stream(0, 1, dev)
    mods, steps = bench.build_stream(1, dev)
    wps = bench.stream_windows_per_sec(mods, steps, windows, args.rounds)
    print(json.dumps({"root": root, "metric": "stream_b1_windows_per_sec",
                      "value": round(wps, 2), "device": bench.card()}),
          flush=True)
    del mods, steps, windows
    # the int8 cell at every level (two of three DSEC levels at B=1 are
    # below the size rule of 'pallas_int8', which runs the exact cell there)
    for impl in ("pallas", "pallas_int8_interpret"):
        for level, host_us, dev_ms in cell_times(torch, layers, dev, impl,
                                                 args.calls):
            print(json.dumps({"root": root, "cell": impl, "level": level,
                              "host_us_per_call": round(host_us, 2),
                              "device_ms_per_call": round(dev_ms, 4)}),
                  flush=True)


if __name__ == "__main__":
    main()
