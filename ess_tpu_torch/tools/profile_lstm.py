"""Profile of one encoder level's ConvLSTM chain: device time by kernel of
a 20-step carried chain of the library cell, B2 and B2-int8.

Counterpart of the JAX package's ``tools/profile_lstm.py`` (its XLA cell
against its fused Pallas cell over a 20-step scan), on ``bench_lstm``'s
inputs and cells::

    python -m ess_tpu_torch.tools.profile_lstm [--layers=0] [--out=DIR]

The Chrome traces go to ``DIR`` (default: a new temporary directory). On
the CPU (``main(argv, device="cpu", shapes=...)``) the plain versions at
the small shapes given, host time by op.
"""

from __future__ import annotations

import sys
import tempfile
from typing import Dict, List, Optional, Sequence

from ess_tpu_torch import resolve_device
from ess_tpu_torch.ops import conv_lstm
from ess_tpu_torch.tools import (
    STEPS, chain, device_line, parse_args, parse_layers, profile_top)
from ess_tpu_torch.tools.bench_lstm import CELLS, impls
from ess_tpu_torch.tools.bench_lstm_breakdown import SHAPES, make_inputs


def main(argv: Optional[List[str]] = None, *, device=None,
         shapes: Sequence[Sequence[int]] = SHAPES, steps: int = STEPS
         ) -> Dict[int, Dict[str, List[dict]]]:
    """Profile each cell's chain at the chosen layers (default 0); returns
    the top entries by layer and cell."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    layers = parse_layers({"--layers": args.get("--layers", "0")},
                          len(shapes))
    device = resolve_device(device)
    out_dir = args.get("--out") or tempfile.mkdtemp(prefix="profile_lstm_")
    print(device_line(device), flush=True)
    names = impls(device)
    out: Dict[int, Dict[str, List[dict]]] = {}
    for li in layers:
        b, c, hh, ww = shapes[li]
        x, h0, c0, weight, bias = make_inputs(li, shapes[li], device)
        print(f"L{li} (B{b} {hh}x{ww}x{c}), {steps}-step chains", flush=True)
        out[li] = {}
        for name in CELLS:
            prep = (conv_lstm.prepare_cell_weights(weight, names[name])
                    if device.type == "cuda" and name != "xla" else None)
            step = (lambda h, c_, impl=names[name], prep=prep:
                    conv_lstm.conv_lstm_cell(x, h, c_, weight, bias,
                                             impl=impl, prepared=prep))
            out[li][name] = profile_top(
                lambda step=step: chain(step, h0, c0, steps), device,
                out_dir, f"lstm_L{li}_{name}")
    return out


if __name__ == "__main__":
    main()
