"""Attribute the ConvLSTM cell kernel's time: product vs operand gather vs
LSTM pointwise (transcendentals).

Counterpart of the JAX package's ``tools/bench_lstm_breakdown.py``. Runs
compile-time variants of the cell kernels (``csrc/conv_lstm.cu``,
``csrc/conv_lstm_int8.cu``) at the DSEC encoder geometries, a 20-step
carried chain each:

  full      - the cell itself (exact bf16 or int8)
  ptw_bf16  - gates rounded to bf16, sigmoid as tanh(v/2)/2 + 1/2, every
              pointwise operation in bf16
  ptw_mul   - transcendentals replaced by multiplies on the raw gates:
              c' = f*c + i*g, h' = o*c'
  no_ptw    - h' = gate i, c' = gate f (product + gather only)
  no_build  - as no_ptw with the A operand's copies skipped: the kernels
              stage a halo per chunk and read every tap from it, with no
              im2row buffer, so what is skipped is the TMA copy of the halo
              (the weight stages still stream) and the product runs on
              whatever the shared memory holds. Its output is undefined;
              it is timed and never compared.

The differences between the variants measure each stage: full - no_ptw the
pointwise, full - ptw_mul the transcendentals, no_ptw - no_build the
operand gather.

Usage: python -m ess_tpu_torch.tools.bench_lstm_breakdown [--layers=0,1,2]
       [--int8=0|1]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ess_tpu_torch import resolve_device
from ess_tpu_torch.ops import conv_lstm
from ess_tpu_torch.tools import (
    STEPS, chain_line, device_line, parse_args, parse_layers, time_chain)

MODES = conv_lstm.MODES
COMPARED = MODES[:4]       # no_build's output is undefined
# (B, C, H, W) of the three encoder cells of a 440x640 DSEC window, x and h
# both C channels
SHAPES = [(8, 64, 220, 320), (8, 128, 110, 160), (8, 256, 55, 80)]


def variant_pointwise(gates: torch.Tensor, c_prev: torch.Tensor, mode: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epilogue ``mode`` names on f32 gates (B, 4*CH, H, W; i, f, o,
    g): (h', c') before the cast to the state's dtypes."""
    if mode == "ptw_bf16":
        gates = gates.to(torch.bfloat16)
    i, f, o, g = torch.chunk(gates, 4, dim=1)
    if mode in ("no_ptw", "no_build"):
        return i, f
    cp = c_prev.to(gates.dtype)
    if mode == "ptw_mul":
        c_new = f * cp + i * g
        return o * c_new, c_new
    if mode == "ptw_bf16":
        sig = lambda v: torch.tanh(v * 0.5) * 0.5 + 0.5
    elif mode == "full":
        sig = torch.sigmoid
    else:
        raise ValueError(f"unknown cell mode {mode!r}; expected one of "
                         f"{MODES}")
    c_new = sig(f) * cp + sig(i) * torch.tanh(g)
    return sig(o) * torch.tanh(c_new), c_new


def cell_variant_ref(x: torch.Tensor, h_prev: torch.Tensor,
                     c_prev: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, mode: str, int8: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of a cell variant: the plain cell's gates
    (``gates_ref`` or ``gates_int8_ref``), then :func:`variant_pointwise`.
    ``'no_build'`` has nothing to skip here and gives ``'no_ptw'``'s
    result, which the kernel's does not equal."""
    gates = (conv_lstm.gates_int8_ref if int8 else conv_lstm.gates_ref)(
        x, h_prev, weight, bias)
    h_new, c_new = variant_pointwise(gates, c_prev, mode)
    return h_new.to(x.dtype), c_new.to(c_prev.dtype)


def cell_variant(x: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, *, mode: str,
                 int8: bool, prepared: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell step in variant ``mode``. CUDA tensors: the cell kernel
    compiled in that mode (``conv_lstm.launch_variant``; c' lands in
    ``c_prev``'s storage). CPU tensors: :func:`cell_variant_ref`."""
    if mode not in MODES:
        raise ValueError(f"unknown cell mode {mode!r}; expected one of "
                         f"{MODES}")
    if x.device.type == "cpu":
        return cell_variant_ref(x, h_prev, c_prev, weight, bias, mode=mode,
                                int8=int8)
    return conv_lstm.launch_variant(x, h_prev, c_prev, weight, bias,
                                    mode=mode, int8=int8, prepared=prepared)


def make_inputs(seed: int, shape: Sequence[int], device: torch.device):
    """Seeded x, h0, c0 (bf16, channels-last), gate weight (f32) and bias
    of one cell, the JAX tool's recipe."""
    b, c, hh, ww = shape
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)
    act = lambda t: t.to(device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    x = act(mk(b, c, hh, ww))
    h0 = act(torch.tanh(mk(b, c, hh, ww)))
    c0 = act(mk(b, c, hh, ww) * 0.5)
    weight = (mk(4 * c, 2 * c, 3, 3) * (18 * c) ** -0.5).to(device)
    bias = (mk(4 * c) * 0.05).to(device)
    return x, h0, c0, weight, bias


def main(argv: Optional[List[str]] = None, *, device=None,
         shapes: Sequence[Sequence[int]] = SHAPES, steps: int = STEPS
         ) -> Dict[int, Dict[str, float]]:
    """Time every mode at the chosen layers and print the tool's lines;
    returns ms per step by layer and mode."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    layers = parse_layers(args, len(shapes))
    int8 = args.get("--int8", "1") == "1"
    device = resolve_device(device)
    print(device_line(device), flush=True)
    results: Dict[int, Dict[str, float]] = {}
    for li in layers:
        b, c, hh, ww = shapes[li]
        x, h0, c0, weight, bias = make_inputs(li, shapes[li], device)
        prepared = (conv_lstm.prepare_cell_weights(
            weight, "pallas_int8" if int8 else "pallas")
            if device.type == "cuda" else None)
        print(f"L{li} (B{b} {hh}x{ww}x{c}) int8={int8}", flush=True)
        per_step = results[li] = {}
        for mode in MODES:
            step = lambda h, c_, mode=mode: cell_variant(
                x, h, c_, weight, bias, mode=mode, int8=int8,
                prepared=prepared)
            ms = time_chain(step, h0, c0, steps)
            per_step[mode] = ms / steps
            note = ("  (timed only: output undefined)"
                    if mode == "no_build" else "")
            print(chain_line(mode, ms, steps, note), flush=True)
        print(f"  pointwise {per_step['full'] - per_step['no_ptw']:+.3f}, "
              f"transcendentals {per_step['full'] - per_step['ptw_mul']:+.3f}"
              f", operand gather "
              f"{per_step['no_ptw'] - per_step['no_build']:+.3f} ms/step",
              flush=True)
    return results


if __name__ == "__main__":
    main()
