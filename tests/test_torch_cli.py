"""The port's train and evaluate CLIs (``ess_tpu_torch.cli``) on a
``make_ddd17_dir`` tree with ``tests/test_cli.py``'s YAML, on the CPU
(``main(argv, device="cpu")``; the tree's masks are written with cv2).

- ``build_loaders`` of both packages gives equal batches, in the same
  order, on the tree and on a DSEC tree written with
  ``tests.test_datasets_integration.make_dsec_seq`` (needs ``h5py``), for
  the band wire (voxel grid) and the tile wire (histogram);
- the port's ``cli.train.main`` prints the summary keys the JAX CLI prints
  and writes the YAML copy, ``metrics.jsonl`` with train losses, and the
  checkpoints;
- ``cli.evaluate.main`` on that run's checkpoints prints the training
  run's last validation summary exactly;
- ``--num_devices`` other than 0 and ``model_name: 'ess'`` with an image
  set on disk raise; ``python -m ess_tpu_torch.cli.train`` raises without
  a GPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_cli import write_yaml
from tests.test_datasets_integration import make_ddd17_dir, make_dsec_seq
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread

pytest.importorskip("cv2")

# the JAX side loads its own copy of the native library (test_torch_host_bin)
_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddd17")
    make_ddd17_dir(str(root), n_masks=2, n_events=4000)
    return str(root)


def yaml_for(tmp_path, tree, name="cfg.yaml", edits=None):
    """``tests/test_cli.py``'s YAML for ``tree`` with the text replacements
    of ``edits``."""
    path = str(tmp_path / name)
    write_yaml(path, tree, str(tmp_path / f"logs_{name}"))
    with open(path) as f:
        text = f.read()
    for old, new in (edits or {}).items():
        assert old in text, old
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def summary_lines(out: str) -> dict:
    rows = [line.split(": ", 1) for line in out.splitlines()
            if line.startswith(("semseg_", "train_stats_"))]
    return {k: v for k, v in rows}


def dsec_config(tmp_path, representation):
    """``configs/settings_DSEC.yaml`` (supervised, small windows, B=2) on a
    DSEC tree of one train and one val sequence written here."""
    import yaml

    for sub, name, seed in (("train", "zurich_city_00_a", 0),
                            ("test", "zurich_city_13_a", 1)):
        make_dsec_seq(str(tmp_path / "dsec" / sub / name), n_events=20000,
                      n_labels=10, seed=seed)
    with open(os.path.join(ROOT, "configs", "settings_DSEC.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["dataset"]["DSEC_events"].update(
        dataset_path=str(tmp_path / "dsec"), nr_events_data=4,
        nr_events_window=1024, event_representation=representation)
    raw["model"]["model_name"] = "ess_supervised"
    raw["optim"]["batch_size_b"] = 2
    raw["hardware"]["num_cpu_workers"] = 2
    return raw


@pytest.mark.parametrize("representation", ["voxel_grid", "histogram"])
@pytest.mark.parametrize("dataset", ["DDD17", "DSEC"])
def test_build_loaders_match_jax(tmp_path, tree, dataset, representation):
    """Both packages' loaders give equal batches in the same order: the
    band wire for the voxel grid, the tile wire otherwise."""
    from ess_tpu.cli.train import build_loaders as jax_build_loaders
    from ess_tpu.core.config import load_config as jax_load_config
    from ess_tpu_torch.cli.train import build_loaders
    from ess_tpu_torch.core.config import load_config

    if dataset == "DSEC":
        src = dsec_config(tmp_path, representation)
    else:
        src = yaml_for(tmp_path, tree, edits={
            "event_representation: 'voxel_grid'":
            f"event_representation: '{representation}'"})
    _, jtrain, _, jval, _ = jax_build_loaders(jax_load_config(src))
    train_a, train_b, val_a, val_b = build_loaders(load_config(src))
    assert train_a is None and val_a is None
    for got_loader, want_loader in ((train_b, jtrain), (val_b, jval)):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    offsets = ("band_offsets" if representation == "voxel_grid"
               else "tile_offsets")
    assert offsets in got[0]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, tree):
    """The port's train CLI, one epoch with checkpoints: (YAML, run
    directory, stdout)."""
    import contextlib
    import io

    from ess_tpu_torch.cli import train

    tmp = tmp_path_factory.mktemp("cli")
    path = yaml_for(tmp, tree, edits={
        "save_checkpoint: False": "save_checkpoint: True"})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--settings_file", path], device="cpu")
    logs = os.path.join(str(tmp), "logs_cfg.yaml")
    runs = sorted(os.listdir(logs))
    assert len(runs) == 1
    return path, os.path.join(logs, runs[0]), out.getvalue()


def test_train_cli_prints_jax_summary_keys(tmp_path, tree, trained, capsys):
    from ess_tpu.cli import train as jax_train

    _, _, out = trained
    jax_train.main(["--settings_file", yaml_for(tmp_path, tree, "jax.yaml")])
    want = summary_lines(capsys.readouterr().out)
    got = summary_lines(out)
    assert sorted(got) == sorted(want) == ["semseg_sensor_b_acc",
                                           "semseg_sensor_b_mean_iou"]
    assert 0 <= float(got["semseg_sensor_b_mean_iou"]) <= 100


def test_train_cli_writes_its_run(trained):
    path, run, out = trained
    assert {"cfg.yaml", "checkpoints", "config.json",
            "metrics.jsonl"} <= set(os.listdir(run))
    with open(path) as f, open(os.path.join(run, "cfg.yaml")) as g:
        assert f.read() == g.read()
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    assert losses and all(np.isfinite(losses))
    assert os.listdir(os.path.join(run, "checkpoints")) == ["0"]
    assert "back_end" in out and "front_sensor_b(e2vid,frozen)" in out


def test_evaluate_cli_reproduces_the_last_validation(trained, capsys):
    from ess_tpu_torch.cli import evaluate

    path, run, out = trained
    evaluate.main(["--settings_file", path, "--checkpoint",
                   os.path.join(run, "checkpoints")], device="cpu")
    got = summary_lines(capsys.readouterr().out)
    assert got == summary_lines(out) and got


def test_num_devices_raises(tmp_path, tree):
    from ess_tpu_torch.cli import train

    with pytest.raises(NotImplementedError, match="multi-GPU"):
        train.main(["--settings_file", yaml_for(tmp_path, tree),
                    "--num_devices", "1"], device="cpu")


@pytest.mark.parametrize("name_a", ["Cityscapes_gray", "DDD17_gray"])
def test_uda_from_disk_raises(tmp_path, tree, name_a):
    from ess_tpu_torch.cli import train

    path = yaml_for(tmp_path, tree, edits={
        "model_name: 'ess_supervised'": "model_name: 'ess'",
        "name_a: 'Cityscapes_gray'": f"name_a: '{name_a}'"})
    with pytest.raises(NotImplementedError, match="image datasets"):
        train.main(["--settings_file", path], device="cpu")


def test_module_entry_point_needs_a_gpu(tmp_path, tree):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "ess_tpu_torch.cli.train", "--settings_file",
         yaml_for(tmp_path, tree)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
