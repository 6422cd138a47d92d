"""Lever-by-lever attribution of the DSEC supervised train step: its rate
over a ladder of config levers, each rung adding one to the last.

Counterpart of the JAX package's ``tools/bench_increments.py``, at
``bench.py``'s shape (B=8 x T=20 windows of 100k events, 440x640), on
seeded weights and one batch's events:

  0. xla-cells          the library cell (``lstm_impl='xla'``: the gate
                        conv on cuDNN, the pointwise in ATen), tile wire
                        (B3 over the step's 160 windows)
  1. int8-cells         the int8 cell kernel (``lstm_impl_train=
                        'pallas_int8'``, B2-int8), tile wire
  2. +folded-voxel      the ghost-folded x-slot band wire (B1), the
                        default
  3. +raw-windows       ``raw_windows``: B1's raw band accumulator, each
                        window mapped to its blocks just before its step
  4. +stack-emit        ``stack_windows``: B1 emits the space-to-depth
                        window stack
  5. +voxel-int8        ``voxel_oh_dtype='int8'``: B1's int8 tent planes
  6. +block-conv        the head and first-encoder block convs on the fused
                        conv kernels (``block_conv_impl='pallas'``, B4-int8)

Rungs 3-5 are the JAX ladder's voxelizer pins, each alone over rung 2 as
JAX runs them::

    python -m ess_tpu_torch.tools.bench_increments [--iters=10]
        [--only=0,2]

One line a rung: ms a step, windows/s and the change from the previous
rung run (``bench.windows_per_sec``: steps enqueued back to back from one
state, one loss fetched at the end). On the CPU (``main(argv,
device="cpu", cfg=..., batches=...)``) the plain versions at the small
config and batches given, on the host clock: a check of the ladder, not a
measurement.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ess_tpu_torch import bench, resolve_device
from ess_tpu_torch.core.config import Config
from ess_tpu_torch.data.pipeline import EventPipeline
from ess_tpu_torch.tools import device_line, parse_args
from ess_tpu_torch.train import builder

# (name, model changes, batch wire, rollout form of bench.apply_form,
# pipeline changes); a model change named in builder.DEFAULT_FORMS goes to
# builder.build_modules (the image front's stem_impl, ...)
Rung = Tuple[str, Dict[str, object], str, Optional[str], Dict[str, object]]
LADDER: List[Rung] = [
    ("xla-cells", {"lstm_impl_train": None, "lstm_impl": "xla"}, "tile",
     None, {}),
    ("int8-cells", {}, "tile", None, {}),
    ("+folded-voxel (default)", {}, "band", None, {}),
    ("+raw-windows", {}, "band", None, {"raw_windows": True}),
    ("+stack-emit", {}, "band", None, {"stack_windows": True}),
    ("+voxel-int8", {}, "band", None, {"voxel_oh_dtype": "int8"}),
    ("+block-conv", {}, "band", "block_pallas", {}),
]


def rate(step: Callable, state, batch: Dict[str, torch.Tensor],
         iters: int) -> float:
    """Windows/s of ``step``: ``bench.windows_per_sec`` on the card, the
    same loop on the host clock on the CPU."""
    if batch["ev_x"].device.type == "cuda":
        return bench.windows_per_sec(step, state, batch, iters)
    float(step(state, batch)["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(state, batch)
    float(out["loss"])
    dt = (time.perf_counter() - t0) / iters
    return batch["ev_x"].shape[0] * batch["ev_x"].shape[1] / dt


def run_ladder(ladder: Sequence[Rung], cfg: Config,
               batches: Dict[str, Dict[str, torch.Tensor]],
               make_step: Callable, device, iters: int,
               only: Optional[Sequence[int]] = None) -> List[dict]:
    """Each rung of ``ladder`` (``only`` its indices): ``cfg`` with the
    rung's model changes (those named in ``builder.DEFAULT_FORMS`` as
    ``build_modules`` keywords), seeded modules (seed 0) in the rung's form,
    ``make_step(mods, pipeline)`` on the rung's batch, the pipeline with
    the rung's changes; prints and returns one line a rung."""
    base = builder.make_pipeline(cfg, train=False)
    lines, prev = [], None
    for i, (name, tweak, wire, form, pins) in enumerate(ladder):
        if only is not None and i not in only:
            continue
        forms = {k: v for k, v in tweak.items()
                 if k in builder.DEFAULT_FORMS}
        rung_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **{k: v for k, v in tweak.items() if k not in forms}))
        mods = builder.build_modules(rung_cfg, device=device, **forms)
        builder.init_params(mods, torch.Generator().manual_seed(0))
        mods = bench.apply_form(mods, form)
        state = builder.init_state(mods)
        pipeline = (EventPipeline(dataclasses.replace(base.cfg, **pins),
                                  base.rectify_map) if pins else base)
        wps = rate(make_step(mods, pipeline), state, batches[wire], iters)
        b, t = batches[wire]["ev_x"].shape[:2]
        delta = f"  ({wps - prev:+.1f} w/s vs prev rung)" if prev else ""
        print(f"[{i}] {name:24s} {1e3 * b * t / wps:8.2f} ms/step  "
              f"{wps:8.2f} windows/s{delta}", flush=True)
        lines.append({"rung": i, "name": name, "windows_per_sec": wps,
                      "ms_per_step": 1e3 * b * t / wps,
                      "delta": None if prev is None else wps - prev})
        prev = wps
        del mods, state
    return lines


def main(argv: Optional[List[str]] = None, *, device=None,
         cfg: Optional[Config] = None,
         batches: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
         ) -> List[dict]:
    """Run the ladder; ``cfg`` and ``batches`` (by wire, ``'tile'`` and
    ``'band'``, on the device) replace ``bench.py``'s shape."""
    from ess_tpu_torch.train.supervised import make_train_step

    args = parse_args(sys.argv[1:] if argv is None else argv)
    only = ([int(i) for i in args["--only"].split(",")]
            if "--only" in args else None)
    device = resolve_device(device)
    print(device_line(device), flush=True)
    cfg = cfg or bench.make_cfg(bench.BATCH)
    if batches is None:
        batches = {w: bench.make_batch(0, bench.BATCH, device, wire=w)
                   for w in ("tile", "band")}
    return run_ladder(LADDER, cfg, batches, make_train_step, device,
                      int(args.get("--iters", 10)), only)


if __name__ == "__main__":
    main()
