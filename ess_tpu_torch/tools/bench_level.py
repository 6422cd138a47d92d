"""Micro-benchmark: the fused encoder level beside the split path.

Counterpart of the JAX package's ``tools/bench_level.py``. Per DSEC encoder
level (L0 with a space-to-depth input, L1 and L2 with a full-resolution
input), at B=8 in bf16:

  split: the library's stride-2 5x5 conv + ReLU, then the int8 ConvLSTM
         cell (``conv_lstm_cell(impl='pallas_int8_interpret')``, the int8
         cell at every shape, as the fused level is: absmax reduce, weight
         re-quantization, quantize pre-pass, int8 GEMM; at the DSEC levels
         at B=8 it is what ``'pallas_int8'`` runs)
  fused: ``ops/level.py::encoder_level_int8``, the three kernels of
         ``csrc/level_int8.cu`` with the weights prepared once

First the single-step error of each against the f32 reference chain
(``encoder_level_ref`` on f32 copies of the inputs), then the time of a
20-step carried chain of each (CUDA events, best of three). With
``--profile=DIR`` each chain is also traced once with ``torch.profiler``
(traces in ``DIR``) and its device time is printed by kernel: the fused
level's three kernels (the group absmax of u, the conv, the gates), and
the split path's conv, elementwise and prep launches beside its cell. With
``--attribute=1`` the fused chain is timed again on builds of the level's
source with parts left out (``LEVEL_SKIP`` of ``csrc/level_int8.cu``: the
gate kernel's halo staging, its weight copies, its epilogue, the conv's
input copies and quantize, its streamed weight copies, its epilogue;
their outputs are undefined).

Usage: python -m ess_tpu_torch.tools.bench_level [--layers=0,1,2]
       [--profile=DIR] [--attribute=1]
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ess_tpu_torch import resolve_device
from ess_tpu_torch.ops import conv_lstm
from ess_tpu_torch.ops.conv_s2d import s2d_kernel_stride2
from ess_tpu_torch.ops.level import (
    encoder_level_int8, encoder_level_ref, prepare_level_weights)
from ess_tpu_torch.tools import (
    STEPS, chain, chain_line, device_line, parse_args, parse_layers,
    time_chain)

# (u shape NCHW: full resolution, or space-to-depth at output resolution;
#  hidden channels; u_s2d) of the three encoder levels of a 440x640 window
LAYERS = [((8, 128, 220, 320), 64, True),     # L0: the block-space head's out
          ((8, 64, 220, 320), 128, False),    # L1: h of L0
          ((8, 128, 110, 160), 256, False)]   # L2: h of L1


# LEVEL_SKIP values of the attribution builds
ATTRIBUTION = {0: "full", 1: "gates without halo staging",
               2: "gates without weight copies", 3: "gates without either",
               4: "gates without epilogue", 8: "conv without input staging",
               16: "conv without weight copies", 32: "conv without epilogue"}


def attribution_libs() -> Dict[int, ctypes.CDLL]:
    """The level's source (with ``voxel_folded.cu`` for the error strings)
    built once per ``ATTRIBUTION`` value, all at once, into the build
    directory; ctypes libraries by value."""
    from ess_tpu_torch import kernels

    srcs = [os.path.join(kernels.CSRC, f) for f in ("level_int8.cu",
                                                    "voxel_folded.cu")]
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    paths = {k: os.path.join(kernels.BUILD_DIR, f"attr_level_{k}.so")
             for k in ATTRIBUTION}
    procs = {k: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
         f"-DLEVEL_SKIP={k}", *srcs, "-o", path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, path in paths.items()}
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for k, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for LEVEL_SKIP={k}:\n" + err)
        lib = ctypes.CDLL(paths[k])
        lib.ess_level_int8.argtypes = [vp] * 10 + [ci] * 18 + [vp]
        lib.ess_level_int8.restype = ci
        lib.ess_error_string.argtypes = [ci]
        lib.ess_error_string.restype = ctypes.c_char_p
        libs[k] = lib
    return libs


def state_shape(ushape: Sequence[int], ch: int, u_s2d: bool
                ) -> Tuple[int, int, int, int]:
    b, _, hh, ww = ushape
    return (b, ch, hh, ww) if u_s2d else (b, ch, hh // 2, ww // 2)


def make_inputs(seed: int, ushape: Sequence[int], ch: int, u_s2d: bool,
                device: torch.device):
    """Seeded u, h0, c0 (bf16, channels-last) and the level's f32
    parameters (encoder conv 5x5, gate conv 3x3), the JAX tool's recipe."""
    cin = ushape[1] // 4 if u_s2d else ushape[1]
    sshape = state_shape(ushape, ch, u_s2d)
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)
    act = lambda t: t.to(device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    u = act(torch.relu(mk(*ushape)))
    h0 = act(torch.tanh(mk(*sshape)))
    c0 = act(mk(*sshape) * 0.5)
    ek = (mk(ch, cin, 5, 5) * (25 * cin) ** -0.5).to(device)
    eb = (mk(ch) * 0.1).to(device)
    gk = (mk(4 * ch, 2 * ch, 3, 3) * (18 * ch) ** -0.5).to(device)
    gb = torch.zeros(4 * ch, device=device)
    return u, h0, c0, ek, eb, gk, gb


def make_steps(u, ek, eb, gk, gb, u_s2d: bool):
    """The two ``(h, c) -> (h', c')`` steps on a fixed input u, with what
    does not depend on the state prepared once."""
    cl = torch.channels_last
    w_lib = (s2d_kernel_stride2(ek) if u_s2d else ek).to(u.dtype).contiguous(
        memory_format=cl)
    b_lib = eb.to(u.dtype)[None, :, None, None]
    gate_prep = (conv_lstm.prepare_gate_weights(gk, torch.float32)
                 if u.device.type == "cuda" else None)
    level_prep = prepare_level_weights(ek, eb, gk, gb)

    def split_step(h, c):
        x = F.conv2d(u, w_lib, stride=1 if u_s2d else 2,
                     padding=1 if u_s2d else 2)
        x = torch.relu(x + b_lib).contiguous(memory_format=cl)
        return conv_lstm.conv_lstm_cell(x, h, c, gk, gb,
                                        impl="pallas_int8_interpret",
                                        prepared=gate_prep)

    def fused_step(h, c):
        out = encoder_level_int8(u, (h, c), ek, eb, gk, gb, u_s2d=u_s2d,
                                 prepared=level_prep)
        if out is None:
            raise RuntimeError(f"encoder_level_int8 does not take u "
                               f"{tuple(u.shape)} with state "
                               f"{tuple(h.shape)}")
        return out[1]

    return {"split": split_step, "fused": fused_step}


def main(argv: Optional[List[str]] = None, *, device=None,
         layers: Sequence = LAYERS, steps: int = STEPS
         ) -> Dict[int, Dict[str, Dict[str, float]]]:
    """Run the chosen levels and print the tool's lines; returns, by level
    and path, the single-step errors against the f32 chain (``dh_max``,
    ``dh_mean``, ``dc_max``) and ``ms_per_step``."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    which = parse_layers(args, len(layers))
    device = resolve_device(device)
    print(device_line(device), flush=True)
    libs = attribution_libs() if args.get("--attribute") == "1" else {}
    results: Dict[int, Dict[str, Dict[str, float]]] = {}
    for li in which:
        ushape, ch, u_s2d = layers[li]
        u, h0, c0, ek, eb, gk, gb = make_inputs(li, ushape, ch, u_s2d, device)
        step_fns = make_steps(u, ek, eb, gk, gb, u_s2d)
        h_ref, c_ref = encoder_level_ref(u.float(), h0.float(), c0.float(),
                                         ek, eb, gk, gb, u_s2d=u_s2d)
        res = results[li] = {}
        for name, step in step_fns.items():
            h1, c1 = step(h0, c0.clone(memory_format=torch.preserve_format))
            dh = (h1.float() - h_ref).abs()
            dc = (c1.float() - c_ref).abs()
            res[name] = {"dh_max": dh.max().item(),
                         "dh_mean": dh.mean().item(),
                         "dc_max": dc.max().item()}
            print(f"L{li} {name}: single-step |dh| vs f32 ref = "
                  f"{res[name]['dh_max']:.3e} (mean "
                  f"{res[name]['dh_mean']:.3e}, |dc| "
                  f"{res[name]['dc_max']:.3e})", flush=True)
        del h_ref, c_ref
        for name, step in step_fns.items():
            ms = time_chain(step, h0, c0, steps)
            res[name]["ms_per_step"] = ms / steps
            print(chain_line(name, ms, steps), flush=True)
        if "--profile" in args:
            for name, step in step_fns.items():
                print_profile(args["--profile"], f"L{li}_{name}",
                              lambda: chain(step, h0, c0, steps))
        if libs:
            from ess_tpu_torch import kernels

            own = kernels.get_lib
            try:
                for k, lib in libs.items():
                    kernels.get_lib = lambda lib=lib: lib
                    ms = time_chain(step_fns["fused"], h0, c0, steps)
                    res[f"fused [{ATTRIBUTION[k]}]"] = {
                        "ms_per_step": ms / steps}
                    print(chain_line("fused", ms, steps,
                                     f"  [{ATTRIBUTION[k]}]"), flush=True)
            finally:
                kernels.get_lib = own
    return results


def print_profile(out_dir: str, name: str, fn) -> None:
    """Trace one call of ``fn`` and print its device time by kernel."""
    from ess_tpu_torch.bench import profile_call
    prof = profile_call(fn, out_dir, name, top=12)
    print(f"  {name} profile: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms over a {prof['span_ms']:.2f} ms span, "
          f"device idle share {100.0 * prof['idle_share']:.1f}%", flush=True)
    for k in prof["top"]:
        print(f"    {k['ms']:.3f} ms {100.0 * k['share']:.1f}% "
              f"x{k['calls']} {k['name'][:90]}", flush=True)


if __name__ == "__main__":
    main()
