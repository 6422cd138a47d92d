"""Profile of the voxelizers as the pipeline calls them: device time by
kernel of one call of ``ops/batch_voxel.py``'s entry for each
``bench_kernel`` case, normalization included (``voxelize_tile`` for B3 on
the tile wire, ``voxelize_band`` for B1 and B3-legacy on their band wires;
160 windows of 100k DSEC events).

Counterpart of the JAX package's ``tools/profile_kernel.py``, which traces
its voxelizer and splits the kernel's time from the halo fold's. The
port's voxelizers are one kernel a call with no fold; the profile splits
the kernel's time from the time normalization before it and the
normalization after it (from the kernel's stats), and gives the device's
idle share around them::

    python -m ess_tpu_torch.tools.profile_kernel [--windows=N] [--out=DIR]

The Chrome traces go to ``DIR`` (default: a new temporary directory). On
the CPU (``main(argv, device="cpu", shape=...)``) the plain versions at a
small shape, host time by op.
"""

from __future__ import annotations

import functools
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from ess_tpu_torch import resolve_device
from ess_tpu_torch.ops.batch_voxel import voxelize_band, voxelize_tile
from ess_tpu_torch.tools import device_line, parse_args, profile_top
from ess_tpu_torch.tools.bench_kernel import WINDOWS, binned


def main(argv: Optional[List[str]] = None, *, device=None,
         shape: Optional[tuple] = None) -> Dict[str, List[dict]]:
    """Profile each case; returns its top entries by case."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    windows, events, height, width = shape or (
        int(args.get("--windows", WINDOWS)), 100_000, 480, 640)
    out_dir = args.get("--out") or tempfile.mkdtemp(prefix="profile_kernel_")
    print(device_line(device), flush=True)
    kw = dict(num_bins=5, height=height, width=width, normalize=True)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = {}
    for name, (r, v, o) in binned(windows, events, height, width).items():
        cols = [to_dev(r[..., i]) for i in range(4)] + [to_dev(v), to_dev(o)]
        fn = (functools.partial(voxelize_tile, trilinear=True)
              if name == "B3" else voxelize_band)
        print(f"{name}: {windows} windows x {events} events", flush=True)
        out[name] = profile_top(lambda: fn(*cols, **kw), device, out_dir,
                                f"voxelizer_{name}")
    return out


if __name__ == "__main__":
    main()
