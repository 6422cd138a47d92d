"""A whole run with the timed path broken underneath comes out not
correct: the harness driven on the CPU at a small size (its look for a
chip skipped), with each fault of ``benchmark/faults.py`` that the cell can
have planted in the program, against the cell's committed limits; the
same run unbroken comes out correct."""

import pytest
import torch

from benchmark import faults, run
from benchmark.tests.small import small_files

CELLS = [("dsec_sup_train_b8", "ess_ddd17"),
         ("dsec_stream_b8", "ess_ddd17")]


def _run(cell, config):
    files = small_files(cell, config=config)
    return run.run(cell, 2 ** 31 + 3, 0.2, False, device=torch.device("cpu"),
                   metrics=["windows_per_s"], files=files)


@pytest.mark.parametrize("cell,config", CELLS)
def test_sound_run_is_correct(cell, config):
    out = _run(cell, config)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,config,fault", [
    (c, conf, f) for c, conf in CELLS
    for f in faults.FAULTS[run.cell_files(c).traffic["step"]]])
def test_fault_is_caught(monkeypatch, cell, config, fault):
    for obj, attr, new in faults.patches(fault):
        monkeypatch.setattr(obj, attr, new)
    out = _run(cell, config)
    assert not out["correct"], out["checks"]
