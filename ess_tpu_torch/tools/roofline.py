"""Analytic bound of the DSEC supervised train step and of the DSEC UDA
train step on one NVIDIA H100.

Counterpart of the JAX package's ``tools/roofline.py``. For every part of
the step at ``bench.py``'s shape (B=8 x T=20 windows of 100k events,
440x640, 5 bins, 11 classes, E2VID base 32 with three encoders) it derives

- FLOPs from the conv shapes: the same work as the JAX tool's rows,
  whatever implements it (the head conv is counted as the 5x5 5 -> 32
  conv, not the 3x3 20 -> 128 block conv the port runs over 2x2
  space-to-depth blocks, which does extra work on zero taps);
- the least device-memory traffic of the port's dataflow and dtypes (B1
  writes an f32 grid at the 480x640 sensor, which torch normalizes, crops
  and casts to the bf16 window; a row whose bytes differ from the JAX
  tool's says why in its description);
- the bound: the larger of FLOPs over the peak of their type and bytes
  over the memory rate, against the H100 datasheet peaks that ``PERF.md``
  section 6 uses: 3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOP/s int8.

Rows the step does not run are kept and marked (the supervised step rolls
out with ``decode=False``, so its residual blocks and decoders never run);
the total bound sums the rows the step runs. Pure host arithmetic: no
device, no model::

    python -m ess_tpu_torch.tools.roofline [--step supervised|uda]
        [--measured KEY=MS ...] [--trace FILE] [--json]

``--measured`` puts a measured time beside a row or a group of rows
(:data:`GROUPS`). ``--trace`` reads a ``torch.profiler`` Chrome trace (the
``*_trace.json`` that ``python -m ess_tpu_torch.bench --profile DIR``
writes) or a JSON holding ``bench.trace_summary``'s result, maps each
kernel's device time onto a group by its name (:data:`KERNEL_GROUPS`) and
puts what no rule names on an explicit ``unattributed`` row.
"""

from __future__ import annotations

import argparse
import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
LEVELS = 3


@dataclass(frozen=True)
class Geometry:
    """The step's shape: batch, windows, the cropped window (height x
    width), bins, classes, E2VID base channels, events a window and the
    rows cropped off the sensor's bottom (the voxelizer's grid is the
    sensor's)."""
    batch: int = 8
    windows: int = 20
    height: int = 440
    width: int = 640
    bins: int = 5
    classes: int = 11
    base: int = 32
    events: int = 100_000
    crop: int = 40


BENCH = Geometry()

# A measured-time group: the rows whose bound a group's time stands beside.
GROUPS = {
    "voxelize": ("voxelize",),
    "fold_norm": ("fold_norm",),
    "lstm": ("lstm0_gates", "lstm0_ptwise", "lstm1_gates", "lstm1_ptwise",
             "lstm2_gates", "lstm2_ptwise"),
    "convs": ("head_conv", "enc0_conv", "enc1_conv", "enc2_conv",
              "resblocks", "decoders", "seghead_fwd_bwd", "front_a_x2",
              "head_x3_fwd_bwd"),
}
# Device kernels by name onto groups, first match wins: the scatter core
# (B1, B3, B3-legacy), the cells (B2, B2-int8) with the int8 preps (the
# absmax kernel is shared with the int8 block conv, which the default
# form does not run), the fused 3x3 convs (B4, B4-int8) and the library's
# convolutions and GEMMs.
KERNEL_GROUPS = (
    (r"scatter_kernel", "voxelize"),
    (r"cell_kernel|(?<!weight_)prep_kernel|absmax_kernel", "lstm"),
    (r"conv3x3_halo_kernel|conv3x3_int8_ws_kernel|weight_prep_kernel|"
     r"head_halo_kernel", "convs"),
    (r"fprop|dgrad|wgrad|xmma|implicit_convolve|convolve|conv2d|cudnn|"
     r"gemm|cutlass", "convs"),
)


def conv_flops(hw: int, k: int, cin: int, cout: int) -> int:
    """2 x MACs of a k x k conv producing hw pixels x cout channels."""
    return 2 * hw * k * k * cin * cout


def head_flops(g: Geometry) -> int:
    """One forward pass of the segmentation head (5 residual blocks at 256
    channels, 256 -> 128, two up stages, the 1x1 classifier)."""
    c_top = g.base * 2 ** LEVELS
    hw_top = (g.height >> LEVELS) * (g.width >> LEVELS)
    hw4 = (g.height >> 2) * (g.width >> 2)
    hw2 = (g.height >> 1) * (g.width >> 1)
    head = 5 * 2 * conv_flops(hw_top, 3, c_top, c_top)
    head += conv_flops(hw_top, 3, c_top, 128)
    head += conv_flops(hw4, 3, 128 + 64, 64) + conv_flops(hw4, 3, 64, 64)
    head += conv_flops(hw2, 3, 64 + 32, 64) + conv_flops(hw2, 3, 64, 32)
    head += conv_flops(hw2, 1, 32, g.classes)
    return head


Row = Tuple[str, str, float, float, str, bool]


def components(g: Geometry = BENCH, *, decode: bool = False) -> List[Row]:
    """(key, description, FLOPs, bytes, peak type, run by the step) of each
    part of one supervised train step; ``decode`` the rollout decodes its
    last window (the UDA step does, the supervised step does not)."""
    out: List[Row] = []
    nw = g.batch * g.windows
    hw = g.height * g.width
    sensor = (g.height + g.crop) * g.width
    window_bytes = g.bins * hw * 2                      # one bf16 window
    # B1: each folded record read once (x, y, ts, pol in f32; the folded
    # wire adds ~5 % ghost records, not counted), the f32 grid at the
    # sensor's rows and B1's stats written once
    out.append(("voxelize", "events -> f32 grid at the 480x640 sensor + "
                "stats (B1; JAX counts a bf16 440x640 grid)", 0.0,
                nw * (g.events * 16 + g.bins * sensor * 4 + 12), "bf16",
                True))
    # torch: read the f32 grid, write the normalized bf16 crop; the block
    # rollout's space-to-depth reads and writes it again
    out.append(("fold_norm", "normalize + crop + bf16 cast (read f32, write "
                "bf16) + space-to-depth fold (JAX: 2 bf16 reads, 1 write)",
                0.0, nw * (g.bins * sensor * 4 + 3 * window_bytes), "bf16",
                True))
    out.append(("head_conv", "5x5 conv bins->32 (the port: 3x3 block conv "
                "20->128 on 2x2 blocks, cuDNN)",
                nw * conv_flops(hw, 5, g.bins, g.base),
                nw * (window_bytes + hw * g.base * 2), "bf16", True))
    for i in range(LEVELS):
        c_in = g.base * 2 ** i
        c_out = 2 * c_in
        hw_i = (g.height >> (i + 1)) * (g.width >> (i + 1))
        out.append((f"enc{i}_conv", f"5x5 s2 conv {c_in}->{c_out} "
                    f"@/{2 ** (i + 1)}", nw * conv_flops(hw_i, 5, c_in, c_out),
                    nw * (4 * hw_i * c_in * 2 + hw_i * c_out * 2), "bf16",
                    True))
        out.append((f"lstm{i}_gates", f"3x3 gate conv {2 * c_out}->"
                    f"{4 * c_out} int8 (B2-int8; gates stay on chip)",
                    nw * conv_flops(hw_i, 3, 2 * c_out, 4 * c_out), 0.0,
                    "int8", True))
        out.append((f"lstm{i}_ptwise", f"cell state dataflow {c_out}ch: read "
                    "x, h, c, write h, c in bf16", 0.0,
                    nw * 5 * hw_i * c_out * 2, "bf16", True))
    c_top = g.base * 2 ** LEVELS
    hw_top = (g.height >> LEVELS) * (g.width >> LEVELS)
    run = "" if decode else " (not run: the step rolls out with decode=False)"
    out.append(("resblocks", f"2x residual block {c_top}ch @/8{run}",
                g.batch * 2 * 2 * conv_flops(hw_top, 3, c_top, c_top),
                g.batch * 2 * 2 * 2 * hw_top * c_top * 2, "bf16", decode))
    dec_flops = dec_bytes = 0
    for i in range(LEVELS):
        c_in = g.base * 2 ** (LEVELS - i)
        c_out = c_in // 2
        hw_i = (g.height >> (LEVELS - i - 1)) * (g.width >> (LEVELS - i - 1))
        dec_flops += g.batch * conv_flops(hw_i, 5, c_in, c_out)
        dec_bytes += g.batch * (hw_i * c_in * 2 + hw_i * c_out * 2)
    out.append(("decoders", f"3x [x2 up + 5x5 conv]{run}", dec_flops,
                dec_bytes, "bf16", decode))
    out.append(("seghead_fwd_bwd", "task head fwd+bwd (standard layout; "
                "backward ~2x forward)", g.batch * 3 * head_flops(g), 0.0,
                "bf16", True))
    hw4 = (g.height >> 2) * (g.width >> 2)
    logits_bytes = g.batch * hw4 * 16 * g.classes * 2
    out.append(("loss", "dice+CE on the logits + bwd", 0.0,
                3 * logits_bytes, "bf16", True))
    return out


def uda_components(g: Geometry = BENCH) -> List[Row]:
    """The DSEC UDA train step: the supervised step's rollout, decoding its
    last window, plus the ResNet18 front on two images, three head passes
    and the cycle and task losses."""
    out = [c for c in components(g, decode=True)
           if c[0] not in ("seghead_fwd_bwd", "loss")]
    hw2 = (g.height >> 1) * (g.width >> 1)
    hw4 = (g.height >> 2) * (g.width >> 2)
    hw8 = (g.height >> 3) * (g.width >> 3)
    fe = conv_flops(hw2, 7, 1, 64)
    fe += 4 * conv_flops(hw2, 3, 64, 64)
    fe += (conv_flops(hw4, 3, 64, 128) + 3 * conv_flops(hw4, 3, 128, 128)
           + conv_flops(hw4, 1, 64, 128))
    fe += (conv_flops(hw8, 3, 128, 256) + 3 * conv_flops(hw8, 3, 256, 256)
           + conv_flops(hw8, 1, 128, 256))
    out.append(("front_a_x2", "resnet18 stem+layer1-3 fwd+bwd, 2 images",
                g.batch * 2 * 3 * fe, 0.0, "bf16", True))
    out.append(("head_x3_fwd_bwd", "3 head passes (a/fake/real) fwd+bwd",
                g.batch * 3 * 3 * head_flops(g), 0.0, "bf16", True))
    lat_bytes = g.batch * (hw2 * 64 + hw4 * 128 + hw8 * 256) * 2 * 2
    logits_bytes = 3 * g.batch * hw4 * 16 * g.classes * 2
    out.append(("cycle_losses", "L1 latent + symJS + dice/CE + bwd", 0.0,
                3 * (lat_bytes + logits_bytes), "bf16", True))
    return out


def bound_ms(flops: float, nbytes: float, kind: str) -> Tuple[float, str]:
    """The least ms for the row, and whether operations or bytes bound it."""
    t_ops = flops / PEAK_OPS_PER_S[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def group_of(kernel: str) -> str:
    for pattern, group in KERNEL_GROUPS:
        if re.search(pattern, kernel):
            return group
    return "unattributed"


def trace_groups(path: str) -> Dict[str, float]:
    """Device ms by group of a Chrome trace or of a ``trace_summary``
    result (its listed kernels)."""
    with open(path) as f:
        data = json.load(f)
    if "traceEvents" in data:
        from ess_tpu_torch.bench import trace_summary
        data = trace_summary(path, top=1 << 30)
    data = data.get("profile", data)
    out: Dict[str, float] = {}
    for k in data["top"]:
        g = group_of(k["name"])
        out[g] = out.get(g, 0.0) + float(k["ms"])
    return out


def table(step: str, g: Geometry = BENCH,
          measured: Optional[Dict[str, float]] = None) -> dict:
    """The rows of ``step`` ('supervised' or 'uda') with their bounds, the
    measured times beside rows and groups, and the totals."""
    comps = components(g) if step == "supervised" else uda_components(g)
    measured = dict(measured or {})
    unknown = (set(measured) - {c[0] for c in comps} - set(GROUPS)
               - {"unattributed"})
    if unknown:
        raise ValueError(f"roofline: no row or group {sorted(unknown)}")
    rows = []
    for key, desc, fl, by, kind, run in comps:
        t, by_what = bound_ms(fl, by, kind)
        rows.append({"component": key, "desc": desc, "gflops": fl / 1e9,
                     "mb": by / 1e6, "peak": kind, "bound_ms": t,
                     "bound_by": by_what, "run": run,
                     "measured_ms": (None if key in GROUPS
                                     else measured.get(key))})
    groups = []
    for name, keys in GROUPS.items():
        in_step = [r for r in rows if r["component"] in keys and r["run"]]
        if in_step:
            groups.append({"group": name,
                           "rows": [r["component"] for r in in_step],
                           "bound_ms": sum(r["bound_ms"] for r in in_step),
                           "measured_ms": measured.get(name)})
    extra = measured.get("unattributed")
    if extra is not None:
        groups.append({"group": "unattributed", "rows": [],
                       "bound_ms": 0.0, "measured_ms": extra})
    total = sum(r["bound_ms"] for r in rows if r["run"])
    windows = g.batch * g.windows
    return {"step": step, "rows": rows, "groups": groups,
            "total_bound_ms": total,
            "all_rows_bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_windows_per_sec": 1e3 * windows / total,
            "windows_per_step": windows}


def main(argv: Optional[List[str]] = None, device=None) -> dict:
    """Print the table (or ``--json``) and return it; ``device`` is
    accepted for the tools' common form and unused (no device work)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step", choices=["supervised", "uda"],
                    default="supervised")
    ap.add_argument("--measured", nargs="*", default=[],
                    help="KEY=MS: a row's or a group's measured ms")
    ap.add_argument("--trace", default=None,
                    help="a Chrome trace or a trace_summary JSON")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    measured = {}
    if args.trace:
        measured.update(trace_groups(args.trace))
    for kv in args.measured:
        k, v = kv.split("=")
        measured[k] = float(v)
    g = BENCH
    res = table(args.step, g, measured)
    if args.json:
        print(json.dumps(res), flush=True)
        return res
    print(f"# Bound of the DSEC {args.step} step on one H100 (B={g.batch} x "
          f"T={g.windows}, {g.height}x{g.width}; datasheet peaks 3.35 TB/s, "
          "989 TFLOP/s bf16, 1,979 TOP/s int8)\n")
    print("| component | what | GFLOP | MB | peak | bound | bound ms | "
          "measured ms |")
    print("|---|---|---|---|---|---|---|---|")
    for r in res["rows"]:
        m = "" if r["measured_ms"] is None else f"{r['measured_ms']:.3f}"
        print(f"| {r['component']}{'' if r['run'] else ' (not run)'} | "
              f"{r['desc']} | {r['gflops']:.1f} | {r['mb']:.1f} | "
              f"{r['peak']} | {r['bound_by']} | {r['bound_ms']:.3f} | {m} |")
    print("\n| group | rows | bound ms | measured ms |\n|---|---|---|---|")
    for gr in res["groups"]:
        m = "" if gr["measured_ms"] is None else f"{gr['measured_ms']:.3f}"
        print(f"| {gr['group']} | {', '.join(gr['rows'])} | "
              f"{gr['bound_ms']:.3f} | {m} |")
    print(f"\nTotal bound: {res['total_bound_ms']:.3f} ms a step = "
          f"{res['bound_windows_per_sec']:.0f} windows/s (rows the step "
          f"runs; all rows {res['all_rows_bound_ms']:.3f} ms)")
    return res


if __name__ == "__main__":
    main()
