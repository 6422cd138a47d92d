"""The ConvLSTM cell alone at the three DSEC encoder shapes: the library
cell against the cell kernels, one step and a 20-step carried chain.

Counterpart of the JAX package's ``tools/bench_lstm.py``, which times its
XLA cell, its fused Pallas cell and the Pallas int8 cell over a 20-step
scan at B=8 (220x320x64, 110x160x128, 55x80x256). Here the three cells
are the library cell (``conv_lstm_ref``: the gate conv on cuDNN, the LSTM
pointwise in ATen; ``lstm_impl='xla'``), B2 (``'pallas'``) and B2-int8
(``'pallas_int8'``), on the JAX tool's inputs (x normal, h0 tanh(normal),
c0 normal / 2, the gate weight at fan-in scale, bias normal x 0.05)::

    python -m ess_tpu_torch.tools.bench_lstm [--layers=0,1,2]

Per layer: one-step parity of B2 and B2-int8 against the library cell
(max |dh|, |dc|), whether two launches of each kernel on one input give
the same h' and c' bit for bit, and ms a step of a 20-step chain of each
cell (CUDA events, the best of three chains after a warm-up:
``tools.time_chain``). On the CPU (``main(argv, device="cpu",
shapes=...)``) it runs the plain versions at the small shapes given, on
the host clock, and the int8 cell's int8 math at every size.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import torch

from ess_tpu_torch import resolve_device
from ess_tpu_torch.ops import conv_lstm
from ess_tpu_torch.tools import (
    STEPS, chain_line, device_line, parse_args, parse_layers, time_chain)
from ess_tpu_torch.tools.bench_lstm_breakdown import SHAPES, make_inputs

CELLS = ("xla", "pallas", "int8")


def impls(device: torch.device) -> Dict[str, str]:
    """Cell name -> the resolved ``lstm_impl`` it runs: on the CPU the
    int8 cell's int8 math at every size (below JAX's size rule
    ``'pallas_int8'`` is the exact cell)."""
    return {"xla": "xla", "pallas": "pallas",
            "int8": ("pallas_int8" if device.type == "cuda"
                     else "pallas_int8_interpret")}


def main(argv: Optional[List[str]] = None, *, device=None,
         shapes: Sequence[Sequence[int]] = SHAPES, steps: int = STEPS
         ) -> Dict[int, Dict[str, dict]]:
    """Run the chosen layers and print the tool's lines; returns, by layer
    and cell, the one-step error against the library cell, the repeat
    check and ms a step."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    layers = parse_layers(args, len(shapes))
    device = resolve_device(device)
    print(device_line(device), flush=True)
    names = impls(device)
    results: Dict[int, Dict[str, dict]] = {}
    for li in layers:
        b, c, hh, ww = shapes[li]
        x, h0, c0, weight, bias = make_inputs(li, shapes[li], device)
        print(f"L{li} (B{b} {hh}x{ww}x{c})", flush=True)
        prepared = {k: (conv_lstm.prepare_cell_weights(weight, v)
                        if device.type == "cuda" and k != "xla" else None)
                    for k, v in names.items()}

        def cell(name, h, c_):
            return conv_lstm.conv_lstm_cell(x, h, c_, weight, bias,
                                            impl=names[name],
                                            prepared=prepared[name])

        h_ref, c_ref = cell("xla", h0, c0.clone())
        out = results[li] = {}
        for name in CELLS:
            runs = [cell(name, h0, c0.clone()) for _ in range(2)]
            h1, c1 = runs[0]
            dh = (h1.float() - h_ref.float()).abs().max().item()
            dc = (c1.float() - c_ref.float()).abs().max().item()
            same = all(torch.equal(a, b_) for a, b_ in zip(*runs))
            ms = time_chain(lambda h, c_, name=name: cell(name, h, c_), h0,
                            c0, steps)
            out[name] = {"dh": dh, "dc": dc, "repeat_bit_for_bit": same,
                         "ms_per_step": ms / steps}
            note = ("" if name == "xla" else
                    f"  one step vs xla |dh| {dh:.2e} |dc| {dc:.2e}; two "
                    f"launches {'bit for bit' if same else 'DIFFER'}")
            print(chain_line(name, ms, steps, note), flush=True)
    return results


if __name__ == "__main__":
    main()
