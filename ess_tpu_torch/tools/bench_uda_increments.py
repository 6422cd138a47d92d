"""Lever-by-lever attribution of the DSEC UDA train step (ESS UDA, the
flagship mode): its rate over a ladder of config levers.

Counterpart of the JAX package's ``tools/bench_uda_increments.py``, at
``bench_extra.py``'s UDA shape (B=8 images and B=8 x T=20 windows of 100k
events at 440x640), on the x-slot band wire:

  0. xla-cells          the library cell (``lstm_impl='xla'``), the
                        ResNet stem on the plain conv (``stem_impl='xla'``)
  1. int8-cells         the int8 cell kernel (B2-int8), the plain stem
  2. +blocked-stem      the ResNet stem and layer1 in space-to-depth block
                        space (``stem_impl='auto'``, JAX's default; the
                        port's is the plain stem, ``builder.DEFAULT_FORMS``)
  3. +raw-windows       ``raw_windows``: B1's raw band accumulator, each
                        window mapped to its blocks just before its step
  4. +block-conv        the head and first-encoder block convs on the fused
                        conv kernels (``block_conv_impl='pallas'``)

Rungs 3 and 4 build the front with the builder's default stem
(``builder.DEFAULT_FORMS``)::

    python -m ess_tpu_torch.tools.bench_uda_increments [--iters=8]
        [--only=0,2]

Timing and lines as :mod:`ess_tpu_torch.tools.bench_increments`. On the
CPU (``main(argv, device="cpu", cfg=..., batch=...)``) the plain versions
at the small config and batch given.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import torch

from ess_tpu_torch import bench, resolve_device
from ess_tpu_torch.core.config import Config
from ess_tpu_torch.tools import device_line, parse_args
from ess_tpu_torch.tools.bench_increments import Rung, run_ladder

LADDER: List[Rung] = [
    ("xla-cells", {"lstm_impl_train": None, "lstm_impl": "xla",
                   "stem_impl": "xla"}, "band", None, {}),
    ("int8-cells (default)", {"stem_impl": "xla"}, "band", None, {}),
    ("+blocked-stem", {"stem_impl": "auto"}, "band", None, {}),
    ("+raw-windows", {}, "band", None, {"raw_windows": True}),
    ("+block-conv", {}, "band", "block_pallas", {}),
]


def main(argv: Optional[List[str]] = None, *, device=None,
         cfg: Optional[Config] = None,
         batch: Optional[Dict[str, torch.Tensor]] = None) -> List[dict]:
    """Run the ladder; ``cfg`` and ``batch`` (on the device) replace
    ``bench_extra.py``'s UDA shape."""
    from ess_tpu_torch.train import uda

    args = parse_args(sys.argv[1:] if argv is None else argv)
    only = ([int(i) for i in args["--only"].split(",")]
            if "--only" in args else None)
    device = resolve_device(device)
    print(device_line(device), flush=True)
    cfg = cfg or bench.make_uda_cfg(bench.BATCH)
    if batch is None:
        batch = bench.make_uda_batch(0, bench.BATCH, device)
    return run_ladder(LADDER, cfg, {"band": batch}, uda.make_train_step,
                      device, int(args.get("--iters", 8)), only)


if __name__ == "__main__":
    main()
