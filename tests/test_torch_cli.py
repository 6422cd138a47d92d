"""The port's train and evaluate CLIs (``ess_tpu_torch.cli``) on a
``make_ddd17_dir`` tree with ``tests/test_cli.py``'s YAML, on the CPU
(``main(argv, device="cpu")``; the tree's masks are written with cv2).

- ``build_loaders`` of both packages gives equal batches, in the same
  order, on the tree and on a DSEC tree written with
  ``tests.test_datasets_integration.make_dsec_seq`` (needs ``h5py``), for
  the band wire (voxel grid) and the tile wire (histogram), on DSEC also
  with ``wire_format: packed`` (``DSEC_packed``), and the rectify map
  both return fifth is None (the loaders rectify on the host);
- the port's ``cli.train.main`` prints the summary keys the JAX CLI prints
  and writes the YAML copy, ``metrics.jsonl`` with train losses, and the
  checkpoints;
- ``cli.evaluate.main`` on that run's checkpoints prints the training
  run's last validation summary exactly;
- on written DDD17 (frames in ``imgs/`` added) and Cityscapes trees,
  ``build_loaders``' image loaders equal the JAX ones for each sensor-A
  set (lengths, and first batches within ``tests/test_torch_image_sets.py``'s
  bounds), and ``model_name: 'ess'`` trains from disk: the first step's
  losses of ``cli.train.main`` within 1e-3 (relative) of the JAX CLI's on
  the same trees, both runs starting from the JAX run's initial weights;
- ``--num_devices`` beyond the CUDA devices present, or with a batch that
  does not divide over the ranks, raises (data parallel itself:
  ``tests/test_torch_parallel_cli.py``); ``python -m
  ess_tpu_torch.cli.train`` raises without a GPU.
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


def dsec_config(tmp_path, representation, wire_format="f32"):
    """``configs/settings_DSEC.yaml`` (supervised, small windows, B=2, on
    ``wire_format``) on a DSEC tree of one train and one val sequence
    written here."""
    import yaml

    for sub, name, seed in (("train", "zurich_city_00_a", 0),
                            ("test", "zurich_city_13_a", 1)):
        make_dsec_seq(str(tmp_path / "dsec" / sub / name), n_events=20000,
                      n_labels=10, seed=seed)
    with open(os.path.join(ROOT, "configs", "settings_DSEC.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["dataset"]["DSEC_events"].update(
        dataset_path=str(tmp_path / "dsec"), nr_events_data=4,
        nr_events_window=1024, event_representation=representation,
        wire_format=wire_format)
    raw["model"]["model_name"] = "ess_supervised"
    raw["optim"]["batch_size_b"] = 2
    raw["hardware"]["num_cpu_workers"] = 2
    return raw


@pytest.mark.parametrize("representation", ["voxel_grid", "histogram"])
@pytest.mark.parametrize("dataset", ["DDD17", "DSEC", "DSEC_packed"])
def test_build_loaders_match_jax(tmp_path, tree, dataset, representation):
    """Both packages' loaders give equal batches in the same order: the
    band wire for the voxel grid, the tile wire otherwise; ``DSEC_packed``
    sends them as packed columns."""
    from ess_tpu.cli.train import build_loaders as jax_build_loaders
    from ess_tpu.core.config import load_config as jax_load_config
    from ess_tpu_torch.cli.train import build_loaders
    from ess_tpu_torch.core.config import load_config

    if dataset.startswith("DSEC"):
        src = dsec_config(tmp_path, representation,
                          "packed" if dataset == "DSEC_packed" else "f32")
    else:
        src = yaml_for(tmp_path, tree, edits={
            "event_representation: 'voxel_grid'":
            f"event_representation: '{representation}'"})
    _, jtrain, _, jval, jrect = jax_build_loaders(jax_load_config(src))
    train_a, train_b, val_a, val_b, rect = build_loaders(load_config(src))
    assert train_a is None and val_a is None
    # the fifth value, the map the Trainer applies on the device: None in
    # both, the loaders rectify on the host
    assert rect is None and jrect is None
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
    assert ("ev_xq" in got[0]) == (dataset == "DSEC_packed")


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
    """Data parallel on more CUDA devices than exist (none here), or with a
    batch that does not divide over the ranks, raises before a rank
    starts; no path trains on fewer devices."""
    from ess_tpu_torch.cli import train

    path = yaml_for(tmp_path, tree)
    for n in ("1", "2", "-1"):
        with pytest.raises(ValueError, match="CUDA device"):
            train.main(["--settings_file", path, "--num_devices", n])
    with pytest.raises(ValueError, match="does not divide over 3"):
        train.main(["--settings_file", path, "--num_devices", "3"],
                   device="cpu")
    with pytest.raises(ValueError, match="name the number of ranks"):
        train.main(["--settings_file", path, "--num_devices", "-1"],
                   device="cpu")


@pytest.fixture(scope="module")
def uda_trees(tmp_path_factory):
    """A DDD17 tree of one mask a recording with its frames, and in the
    same directory a Cityscapes tree of 3 train and 2 val frames: the
    DDD17_Cityscapes_gray mix reads both from its one ``dataset_path``."""
    from tests.test_torch_image_sets import (add_ddd17_frames,
                                             make_cityscapes_tree)

    root = str(tmp_path_factory.mktemp("ddd17_cityscapes"))
    make_ddd17_dir(root, n_masks=1, n_events=4000)
    add_ddd17_frames(root, 1)
    make_cityscapes_tree(root, n_train=3, n_val=2)
    return root


def uda_yaml(tmp_path, root, name_a, name="uda.yaml"):
    """``tests/test_cli.py``'s YAML with ``model_name: 'ess'``, sensor-A
    set ``name_a``, every set on ``root``, augmentation on and one event
    batch of 4."""
    import yaml

    path = str(tmp_path / name)
    write_yaml(path, root, str(tmp_path / f"logs_{name}"))
    with open(path) as f:
        raw = yaml.safe_load(f)
    ds = raw["dataset"]
    ds["name_a"] = name_a
    ds["cityscapes_img"]["dataset_path"] = root
    ds["DDD17_img"] = dict(dataset_path=root, shape=[200, 352])
    raw["model"].update(model_name="ess", data_augmentation_train=True)
    raw["optim"]["batch_size_b"] = 4
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


@pytest.mark.parametrize("name_a", ["Cityscapes_gray", "DDD17_gray",
                                    "DDD17_Cityscapes_gray"])
def test_image_loaders_match_jax(monkeypatch, tmp_path, uda_trees, name_a):
    from ess_tpu.cli.train import build_loaders as jax_build_loaders
    from ess_tpu.core.config import load_config as jax_load_config
    from ess_tpu_torch.cli.train import build_loaders
    from ess_tpu_torch.core.config import load_config
    from tests.test_torch_image_sets import check_sample, float32_corners

    float32_corners(monkeypatch)
    path = uda_yaml(tmp_path, uda_trees, name_a)
    jtrain_a, _, jval_a, _, _ = jax_build_loaders(jax_load_config(path))
    train_a, _, val_a, _, _ = build_loaders(load_config(path))
    lengths = {"Cityscapes_gray": (1, 1), "DDD17_gray": (2, 1),
               "DDD17_Cityscapes_gray": (4, 1)}[name_a]
    assert (len(train_a), len(val_a)) == (len(jtrain_a), len(jval_a)) \
        == lengths
    for got_loader, want_loader in ((train_a, jtrain_a), (val_a, jval_a)):
        got, want = next(iter(got_loader)), next(iter(want_loader))
        assert sorted(got) == sorted(want) == ["image", "label"]
        n = got["image"].shape[0]
        assert n == want["image"].shape[0] > 0
        for i in range(n):
            check_sample({k: v[i] for k, v in got.items()},
                         {k: v[i] for k, v in want.items()}, warped=True)


def jax_draws(jax_pipeline):
    """A stand-in for the port's ``draw_augment`` that draws what the JAX
    UDA step draws at the same step: ``sample_augment`` of the JAX
    pipeline with the key ``fold_in(PRNGKey(seed), step)``."""
    import jax
    import torch

    from ess_tpu_torch.data.pipeline import AugmentParams

    def draw(pipeline, seed, step, batch_size):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        aug = jax_pipeline.sample_augment(key, batch_size, train=True)
        return AugmentParams(*(
            None if a is None else torch.from_numpy(np.asarray(a).copy())
            for a in (aug.flip, aug.crop_y, aug.crop_x)))

    return draw


def test_uda_cli_first_step_matches_jax(monkeypatch, tmp_path, uda_trees):
    """Both CLIs train ``model_name: 'ess'`` on the DDD17_Cityscapes_gray
    mix and DDD17 events from disk for one epoch, the port from the JAX
    run's initial weights and with the JAX run's event augmentation draws
    (:func:`jax_draws`): the first step's losses agree within 1e-3
    (relative)."""
    import jax

    from ess_tpu.cli import train as jax_train
    from ess_tpu.core.config import load_config as jax_load_config
    from ess_tpu.train import loop as jax_loop
    from ess_tpu.train.builder import make_pipeline as jax_make_pipeline
    from ess_tpu_torch.cli import train
    from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
    from ess_tpu_torch.train import loop, uda
    from tests.test_torch_image_sets import float32_corners
    from tests.test_torch_loop import scalars

    float32_corners(monkeypatch)
    initial = {}

    class JaxTrainer(jax_loop.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.writer.flush_every = 1   # log every step's losses
            initial["state"] = jax.device_get(self.state)
            initial["log_dir"] = self.log_dir

    class Trainer(loop.Trainer):
        def __init__(self, cfg, **kw):
            st = initial["state"]
            e2vid, head = params_from_jax(st.e2vid_params, st.back_params)
            kw.update(e2vid_state=e2vid, front_state=front_from_jax(
                st.front_params, st.front_batch_stats))
            super().__init__(cfg, **kw)
            self.state.head.load_state_dict(head)
            self.writer.flush_every = 1
            initial["port_log_dir"] = self.log_dir

    monkeypatch.setattr(jax_loop, "Trainer", JaxTrainer)
    monkeypatch.setattr(loop, "Trainer", Trainer)
    jax_train.main(["--settings_file", uda_yaml(
        tmp_path, uda_trees, "DDD17_Cityscapes_gray", "jax.yaml")])
    monkeypatch.setattr(uda, "draw_augment", jax_draws(
        jax_make_pipeline(jax_load_config(uda_yaml(
            tmp_path, uda_trees, "DDD17_Cityscapes_gray", "draws.yaml")),
            train=True)))
    train.main(["--settings_file", uda_yaml(
        tmp_path, uda_trees, "DDD17_Cityscapes_gray", "port.yaml")],
        device="cpu")
    want = scalars(initial["log_dir"], "train/")
    got = scalars(initial["port_log_dir"], "train/")
    assert sorted(got) == sorted(want)
    assert {"train/loss", "train/semseg_sensor_a_loss"} <= set(got)
    for k, v in want.items():
        assert len(got[k]) == len(v) == 4, k   # 3 + 5 images at B=2
        np.testing.assert_allclose(got[k][0], v[0], rtol=1e-3, err_msg=k)


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
