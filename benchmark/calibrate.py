"""The readings that the check's limits are set from, on the card at a
cell's own size, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 12 \
        [--control 3] [--faults 3] [--fault NAME ...] [--first-seed N]

- the program's numbers on ``--seeds`` seeds (the lower readings);
- the control's on ``--control`` seeds: the reference computed one
  precision below the configuration's (``reference/precision.py``), put in
  the program's place and compared with the float32 reference;
- each fault of ``benchmark/faults.py`` that the cell's step can have,
  planted in the program, on ``--faults`` seeds (``--fault`` names the
  faults to plant; all of them by default).

Each reading is a JSON line on standard output, with ``correct``: the
cell's committed limits (``benchmark.check.judge``) applied to it. The
last line sums them up: per number the largest program reading, the
smallest control reading and the smallest reading of each fault; and per
kind the seeds that the committed limits judged correct (a sound program
on every seed, the control and each fault on none); a cell that states no
limits yet gets its readings alone.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys

import torch

from benchmark import check, faults
from benchmark.reference.precision import LOWERED, f32_matmuls
from benchmark.run import cell_files


def _serve(driver, traffic) -> None:
    """Requests after the checked ones until each ring entry has served
    once (the streaming cell checks every ring segment)."""
    while driver.cursor < traffic["ring"]:
        driver.request()


def readings(workload: str, seeds, control, fault_seeds, emit, *,
             device, files=None, only=None) -> dict:
    """The readings of the module docstring; ``files`` (tests) a small cell
    as ``benchmark.run.cell_files`` gives, ``only`` the faults to plant."""
    files = files or cell_files(workload)
    step = files.traffic["step"]
    limits = files.cell.get("limits")

    def judge(n):
        return check.judge(n, limits) if limits else None

    drivers = importlib.import_module(f"benchmark.drivers.{step}")
    dev = device
    driver = drivers.Driver(files.conf, files.traffic, dev)
    out = {"program": [], "control": [], "faults": {}}
    for s in seeds:
        driver.prepare(s)
        _serve(driver, files.traffic)
        with f32_matmuls():
            prog, ref = driver.program_outputs(), driver.reference()
        n = driver.compare(prog, ref)
        out["program"].append(n)
        emit({"kind": "program", "seed": s, **n,
              "correct": judge(n), **_worst_leaves(prog, ref)})
    for s in control:
        driver.prepare(s)
        _serve(driver, files.traffic)
        with f32_matmuls():
            ref = driver.reference()
            low = driver.reference(LOWERED)
        n = driver.compare(driver.as_program(low), ref)
        out["control"].append(n)
        emit({"kind": "control", "seed": s, **n,
              "correct": judge(n),
              **_worst_leaves(driver.as_program(low), ref)})
    del driver
    names = [f for f in faults.FAULTS[step] if only is None or f in only]
    for name in names if fault_seeds else ():
        with faults.planted(name):
            d = drivers.Driver(files.conf, files.traffic, dev)
            for s in fault_seeds:
                d.prepare(s)
                _serve(d, files.traffic)
                with f32_matmuls():
                    prog, ref = d.program_outputs(), d.reference()
                n = d.compare(prog, ref)
                out["faults"].setdefault(name, []).append(n)
                emit({"kind": name, "seed": s, **n,
                      "correct": judge(n),
                      **_worst_leaves(prog, ref)})
            del d
    return out


def _worst_leaves(prog: dict, ref: dict, top: int = 3) -> dict:
    """Train cells: the leaves that read the largest gaps, and the median
    leaf's."""
    if "grad1" not in prog:
        return {}
    leaves = check.counted_leaves(ref["grad1"])
    out = {}
    for key in ("grad1", "delta"):
        gaps = check.leaf_gaps(prog[key], ref[key], leaves)
        ranked = sorted(gaps.items(), key=lambda kv: -kv[1])
        out[key + "_worst"] = ranked[:top]
        out[key + "_median"] = statistics.median(gaps.values())
    return out


def summary(out: dict, limits: dict) -> dict:
    """Per number its extreme readings; per kind, under ``judged`` (where
    the cell has ``limits``), the count of seeds the limits judged correct
    and the count of seeds."""
    kinds = {"program": out["program"], "control": out["control"],
             **out["faults"]}
    kinds = {k: rs for k, rs in kinds.items() if rs}
    keys = next(iter(kinds.values()))[0].keys()
    res = {k: {} for k in keys}
    for kind, rs in kinds.items():
        for k in keys:
            res[k][kind + ("_max" if kind == "program" else "_min")] = (
                (max if kind == "program" else min)(r[k] for r in rs))
    if limits:
        res["judged"] = {kind: [sum(check.judge(r, limits) for r in rs),
                                len(rs)] for kind, rs in kinds.items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault", action="append", default=None,
                    help="a fault to plant (repeat; all by default)")
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--train-cells", default=None,
                    help="run the program's train rollout on other cells "
                         "than the configuration's ('exact': the bf16 "
                         "cell), a witness of what the int8 cells move")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    s0 = args.first_seed
    seeds = range(s0, s0 + args.seeds)
    control = range(s0 + 1000, s0 + 1000 + args.control)
    fault_seeds = range(s0 + 2000, s0 + 2000 + args.faults)
    emit = lambda r: print(json.dumps(r), flush=True)  # noqa: E731
    files = cell_files(args.workload)
    if args.train_cells:
        files.conf["train_cells"] = args.train_cells
    out = readings(args.workload, seeds, control, fault_seeds, emit,
                   device=torch.device("cuda", 0), files=files,
                   only=args.fault)
    emit({"summary": args.workload,
          **summary(out, files.cell.get("limits"))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
