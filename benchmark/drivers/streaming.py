"""The streaming cell: ``train/streaming.py::make_streaming_steps`` on S
carried-state streams, one window a step, the last window of each segment
scored.

The traffic is a ring of seeded segments of ``windows_per_segment`` windows;
each segment restarts its streams (``is_first`` on its first window) and
carries their state through its windows, as ``bench.py``'s streams do. A
request is one segment: from its first window's launch until the scored
window's confusion matrix is on the host, the one host read a segment. The
check compares every finished segment's confusion matrix, and the state the
program carried to the end of each ring segment, with the reference's run
of that segment from zero state.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import check, program, traffic as gen, weights, work
from benchmark.drivers.base import Driver as BaseDriver
from benchmark.reference import steps as ref_steps
from benchmark.reference.precision import F32, Precision


class Driver(BaseDriver):
    @classmethod
    def windows_per_request(cls, conf: dict, traffic: dict) -> int:
        return traffic["streams"] * traffic["windows_per_segment"]

    @classmethod
    def work(cls, conf: dict, traffic: dict) -> Dict[str, work.Work]:
        """A segment: S x windows_per_segment windows voxelized and
        rolled out on the exact cell, the head's forward on the S scored
        windows."""
        nwin = cls.windows_per_request(conf, traffic)
        convs = work.convs_work(work.rollout_convs(conf), nwin)
        convs += work.convs_work(work.head_convs(conf, train=False),
                                 traffic["streams"])
        return {"voxelizer": work.voxel_work(conf, nwin),
                "cells": work.cell_work(conf, nwin, False),
                "convs": convs}

    def __init__(self, conf: dict, traffic: dict, device):
        self.conf, self.traffic, self.device = conf, traffic, device
        self.mods = program.build(conf, "ess_supervised", device)
        self.encode, self.score = program.streaming_steps(self.mods)
        self.failed = 0

    def prepare(self, seed: int) -> None:
        conf, tr = self.conf, self.traffic
        self.params = weights.make(conf, False, seed, self.device)
        program.load(self.mods, self.params)
        with ThreadPoolExecutor(tr["ring"]) as pool:
            self.host = list(pool.map(
                lambda i: gen.stream_segment(conf, tr, seed, i),
                range(tr["ring"])))
            wired = list(pool.map(self._wire, self.host))
        self.ring = [[program.to_device(w, self.device) for w in seg]
                     for seg in wired]
        self.state = self.mods.recon_val.init_state(tr["streams"],
                                                    self.device)
        self.cursor = 0
        self.cms: List[Tuple[int, np.ndarray]] = []
        self.last_state: Dict[int, tuple] = {}
        self.request()

    def _wire(self, seg: Dict[str, np.ndarray]) -> List[Dict]:
        """One host dict a window, as the streaming steps take them."""
        host = program.wire(self.conf, seg["events"], self.traffic["wire"])
        n = seg["events"].shape[1]
        out = []
        for w in range(n):
            b = {k: v[:, w] for k, v in host.items()}
            b["is_first"] = np.full(seg["events"].shape[0], w == 0)
            if w == n - 1:
                b["label"] = seg["label"]
            out.append(b)
        return out

    def request(self) -> None:
        idx = self.cursor % len(self.ring)
        self.cursor += 1
        state = self.state
        for b in self.ring[idx]:
            if "label" in b:
                state, cm = self.score(state, b)
            else:
                state = self.encode(state, b)
        cm = cm.cpu().numpy()
        self.state = state
        self.last_state[idx] = state
        self.cms.append((idx, cm))
        if not np.isfinite(cm).all() or cm.sum() != self.host[idx][
                "label"].size:
            self.failed += 1

    def release(self) -> None:
        """Free the program's state before the reference runs; the carried
        states that are checked stay."""
        del self.mods, self.encode, self.score, self.state, self.ring
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def program_outputs(self) -> dict:
        return {"cms": self.cms, "states": self.last_state}

    def reference(self, prec: Precision = F32) -> dict:
        done = sorted({idx for idx, _ in self.cms})
        out = {}
        for idx in done:
            seg = self.host[idx]
            r = ref_steps.stream_segment(self.conf, self.params,
                                         seg["events"], seg["label"],
                                         prec=prec, device=self.device)
            out[idx] = {"state": r["state"], "cm": r["cm"].cpu().numpy()}
        return out

    @staticmethod
    def compare(prog: dict, ref: dict) -> Dict[str, float]:
        return check.stream_numbers(prog, ref)

    def as_program(self, ref: dict) -> dict:
        """The reference's outputs in the program's form (the control put in
        the program's place): its cm for every finished request."""
        return {"cms": [(idx, ref[idx]["cm"]) for idx, _ in self.cms],
                "states": {idx: r["state"] for idx, r in ref.items()}}
