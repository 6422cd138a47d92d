"""Train-step cells: the supervised step (``train/supervised.py``) or the
ESS UDA step (``train/uda.py``) on a ring of distinct seeded batches.

Set-up makes the ring's batches on a few host threads, builds one train
state and drives it through its first three steps
on the ring's first three batches, by the window's own call and feed; those
steps are what the check compares with the reference: each step's loss, the
first gradient as the optimizer holds it after one step (RAdam with b1 = 0
keeps it as its first moment), and the parameters' change after the three
steps. The window then goes on training the same state around the ring. A
request is one step: its launch until its losses are on the host, the one
host read a step that the program's Trainer makes.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, program, traffic as gen, weights, work
from benchmark.drivers.base import Driver
from benchmark.reference import steps as ref_steps
from benchmark.reference.precision import F32, Precision

CHECKED_STEPS = 3


class TrainDriver(Driver):
    uda = False

    @classmethod
    def windows_per_request(cls, conf: dict, traffic: dict) -> int:
        return conf["batch"] * conf["windows"]

    @classmethod
    def rollout_work(cls, conf: dict) -> Dict[str, work.Work]:
        """The voxelizer, the cells and the encoder convs of a step's
        B x T windows."""
        nwin = cls.windows_per_request(conf, {})
        return {"voxelizer": work.voxel_work(conf, nwin),
                "cells": work.cell_work(conf, nwin,
                                        conf["train_cells"] == "int8"),
                "convs": work.convs_work(work.rollout_convs(conf), nwin)}

    def __init__(self, conf: dict, traffic: dict, device):
        self.conf, self.traffic, self.device = conf, traffic, device
        self.mods = program.build(conf, "ess" if self.uda else
                                  "ess_supervised", device)
        make = (program.uda_train_step if self.uda
                else program.supervised_train_step)
        self.step = make(self.mods)
        self.failed = 0

    # -- set-up ---------------------------------------------------------
    def prepare(self, seed: int) -> None:
        """Weights, the ring and a fresh train state from ``seed``; then the
        checked steps."""
        conf = self.conf
        self.params = weights.make(conf, self.uda, seed, self.device)
        program.load(self.mods, self.params)
        self.state = program.fresh_state(self.mods)
        ring = self.traffic["ring"]
        with ThreadPoolExecutor(ring) as pool:
            self.host = list(pool.map(lambda i: gen.train_batch(
                conf, self.traffic, seed, i, self.uda), range(ring)))
            wired = list(pool.map(self._wire, self.host))
        self.ring = [program.to_device(w, self.device) for w in wired]
        self.cursor = 0
        opt_params = self._trainable()
        self.checked_losses: List[float] = []
        for i in range(CHECKED_STEPS):
            self.checked_losses.append(self.request())
            if i == 0:
                self.grad1 = program.first_moments(self.state, opt_params)
        self.delta = {k: float((p.detach() - self.params[k]).double().norm())
                      for k, p in opt_params.items()}

    def _wire(self, b: Dict) -> Dict[str, np.ndarray]:
        host = program.wire(self.conf, b["events"], self.traffic["wire"])
        for k in ("label", "label_a", "image_a"):
            if k in b:
                host[k] = b[k]
        return host

    def _trainable(self) -> Dict[str, torch.Tensor]:
        out = {f"head.{k}": p for k, p in self.mods.head.named_parameters()}
        if self.uda:
            out.update({f"front.{k}": p
                        for k, p in self.mods.front_a.named_parameters()})
        return out

    # -- the timed path -------------------------------------------------
    def request(self) -> float:
        batch = self.ring[self.cursor % len(self.ring)]
        self.cursor += 1
        loss = float(self.step(self.state, batch)["loss"])
        if not math.isfinite(loss):
            self.failed += 1
        return loss

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.mods, self.step, self.state, self.ring
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def reference(self, prec: Precision = F32) -> dict:
        return ref_steps.train_steps(
            self.conf, self.params, self.host[:CHECKED_STEPS], uda=self.uda,
            prec=prec, device=self.device)

    @staticmethod
    def compare(prog: dict, ref: dict) -> Dict[str, float]:
        return check.train_numbers(prog, ref)

    def program_outputs(self) -> dict:
        return {"losses": self.checked_losses, "grad1": self.grad1,
                "delta": self.delta}

    def as_program(self, ref: dict) -> dict:
        """The reference's outputs in the program's form (the control put
        in the program's place)."""
        return ref
