"""What the benchmark imports: the reference nothing of the program, of the
JAX package or of JAX; a run refuses to report once any of those three
is loaded in its process, whenever in the run it came."""

import os
import subprocess
import sys
import types

import pytest
import torch

from benchmark import run
from benchmark.tests.small import small_files

ROOT = run.ROOT


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, check=True)
    return set(out.stdout.split())


def test_reference_imports_none_of_the_program():
    mods = _top_level("import benchmark.reference.steps")
    assert not mods & {"jax", "jaxlib", "flax", "ess_tpu", "ess_tpu_torch"}


def _modules(folder: str) -> list:
    return sorted(f"benchmark.{folder}.{n[:-3]}" for n in os.listdir(
        os.path.join(ROOT, "benchmark", folder))
        if n.endswith(".py") and n != "__init__.py")


def test_harness_imports_no_jax():
    mods = _top_level("import benchmark.run, benchmark.calibrate, "
                      "benchmark.faults, " + ", ".join(
                          _modules("drivers") + _modules("metrics")))
    assert not mods & {"jax", "jaxlib", "flax", "ess_tpu"}
    assert "ess_tpu_torch" in mods


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ess_tpu_torch_extra",
                        types.ModuleType("ess_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ess_tpu.ops",
                        types.ModuleType("ess_tpu.ops"))
    assert run.forbidden_modules() == ["ess_tpu.ops"]


def _plant_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


@pytest.mark.parametrize("when", ["set-up", "reference", "metric read"])
def test_run_refuses_with_jax_loaded(monkeypatch, when):
    """JAX loaded before the run, by the reference after the window, or by
    a metric's reader: no result either way."""
    from benchmark.metrics import windows_per_s
    from benchmark.reference import steps

    if when == "set-up":
        _plant_jax(monkeypatch)
    elif when == "reference":
        ref = steps.train_steps

        def planting_reference(*a, **k):
            _plant_jax(monkeypatch)
            return ref(*a, **k)
        monkeypatch.setattr(steps, "train_steps", planting_reference)
    else:
        read = windows_per_s.read

        def planting_read(ctx):
            _plant_jax(monkeypatch)
            return read(ctx)
        monkeypatch.setattr(windows_per_s, "read", planting_read)
    with pytest.raises(SystemExit, match="forbidden"):
        run.run("dsec_sup_train_b8", 1, 0.1, False,
                device=torch.device("cpu"), metrics=["windows_per_s"],
                files=small_files("dsec_sup_train_b8"))


@pytest.mark.parametrize("cell", ["ddd17_sup_train_b16", "dsec_uda_train_b8"])
def test_cell_without_limits_is_refused(cell):
    """The cells left out of BENCHMARK.json state no limits: a run of one
    is refused before its set-up."""
    files = small_files(cell)
    assert "limits" not in files.cell
    with pytest.raises(SystemExit, match="no limits"):
        run.run(cell, 1, 0.1, False, device=torch.device("cpu"), metrics=[],
                files=files)


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "dsec_sup_train_b8", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
