"""The port's metric writer, region timers and visualization helpers
(``ess_tpu_torch.io.writers``, ``io.timers``, ``utils.viz``) against the
JAX package's on the CPU: the same calls give the same JSONL records (the
wall-clock ``t`` aside) and ``config.json``, and every viz function gives
the same array on the same inputs, exactly (``latent_pca_rgb`` takes the
port's channel-first latent where JAX takes it channel-last)."""

import json
import os

import numpy as np
import pytest
import torch

from ess_tpu.core import labels as jax_labels
from ess_tpu.io import timers as jax_timers
from ess_tpu.io.writers import MetricsWriter as JaxWriter
from ess_tpu.utils import viz as jax_viz

from ess_tpu_torch.io import timers
from ess_tpu_torch.io.writers import MetricsWriter
from ess_tpu_torch.utils import viz
from tests.test_torch_loop import one_torch_thread

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


def drive(writer):
    events = []
    writer._tracker = lambda *e: events.append(e[:2] + e[3:])
    writer.scalar("val/a", 1.5, 3)
    writer.scalars({"x": 2.0, "v": np.ones(3)}, 4, prefix="p/")
    for i in range(7):
        writer.averaged_scalar("train/loss", float(i), i + 1)
    writer.image("img", np.zeros((4, 6, 3), np.float32), 7)
    writer.figure("fig", None, 7)
    writer.close()
    with open(os.path.join(writer.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        assert isinstance(r.pop("t"), float)
    with open(os.path.join(writer.log_dir, "config.json")) as f:
        return recs, json.load(f), events


def test_writer_records_match_jax(tmp_path):
    config = {"cfg": {"a": 1, "b": [1, 2]}, "seed": 6}
    got = drive(MetricsWriter(str(tmp_path / "port"), config=config,
                              flush_every=3))
    want = drive(JaxWriter(str(tmp_path / "jax"), config=config,
                           flush_every=3))
    assert got == want
    recs = got[0]
    assert [r["train/loss"] for r in recs if "train/loss" in r] == [1.0, 4.0]
    assert {"step": 7, "image": "img", "shape": [4, 6, 3]} in recs


def test_timers(tmp_path):
    timers.reset_timers()
    x = torch.ones(3)
    with timers.Timer("a", sync={"x": [x, (x,)]}):
        pass
    with timers.timed_scope("a"):
        pass
    with timers.timed_scope("b"):
        pass
    rep = timers.timer_report()
    assert sorted(rep) == ["a", "b"] and all(v >= 0 for v in rep.values())
    assert len(timers._ACCUM["a"]) == 2
    with timers.trace(str(tmp_path / "prof")):
        (x + 1).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(RuntimeError):
        timers.stop_trace()
    timers.reset_timers()
    assert timers.timer_report() == {}
    api = {"Timer", "timed_scope", "trace", "timer_report", "reset_timers"}
    assert api <= set(dir(jax_timers)) and api <= set(dir(timers))


def viz_cases():
    rng = np.random.default_rng(4)
    lbl = rng.integers(0, 6, (9, 11)).astype(np.uint8)
    lbl[2:4] = 255
    imgs = [rng.uniform(size=(5, 7, 3)).astype(np.float32),
            rng.uniform(size=(4, 6)).astype(np.float32),
            rng.uniform(size=(5, 7, 1)).astype(np.float32)]
    boxes = np.array([[2, 3, 5, 8], [1, 1, 2, 2], [0, 0, 0, 0], [9, 9, 4, 4]])
    lat = rng.normal(size=(16, 6, 5)).astype(np.float32)   # (C, H, W)
    return {
        "event_histogram_rgb": (
            (np.abs(rng.normal(size=(2, 8, 8))).astype(np.float32),), {}),
        "voxel_grid_rgb": ((rng.normal(size=(5, 8, 8)).astype(np.float32),),
                           {}),
        "colorize_semseg": ((lbl, jax_labels.COLOR_MAP_6), {}),
        "make_grid": ((imgs,), {"nrow": 2, "pad": 1}),
        "latent_pca_rgb": ((lat,), {}),
        "draw_bounding_boxes": ((np.zeros((20, 30, 3), np.float32), boxes),
                                {"ground_truth": False}),
        "flow_rgb": ((rng.normal(size=(2, 2, 6, 7)).astype(np.float32),),
                     {}),
        "disparity_rgb": ((rng.uniform(-5, 90, (6, 7)),), {}),
        "disparity_overlay": ((rng.integers(0, 256, (6, 7)),
                               rng.integers(0, 256, (6, 7, 3))), {}),
    }


@pytest.mark.parametrize("name", sorted(viz_cases()))
def test_viz_matches_jax(name):
    args, kw = viz_cases()[name]
    got = getattr(viz, name)(*args, **kw)
    if name == "latent_pca_rgb":
        args = (np.moveaxis(args[0], 0, -1),)
    want = getattr(jax_viz, name)(*args, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_embedding_dump_matches_jax(tmp_path):
    emb = np.random.default_rng(5).normal(size=(4, 8)).astype(np.float32)
    labels = np.array([0, 1, 2, 3])
    viz.embedding_dump(emb, labels, str(tmp_path / "p.tsv"))
    jax_viz.embedding_dump(emb, labels, str(tmp_path / "j.tsv"))
    for suffix in ("", ".labels.tsv"):
        assert (tmp_path / f"p.tsv{suffix}").read_text() == \
            (tmp_path / f"j.tsv{suffix}").read_text()


def test_confusion_figure():
    fig = viz.confusion_matrix_figure(np.eye(3), ["a", "b", "c"])
    if fig is not None:
        assert hasattr(fig, "savefig")


def test_count_params():
    lin = torch.nn.Linear(3, 4)
    assert viz.count_params(lin) == 16
    assert viz.count_params(lin.state_dict()) == 16
    assert viz.count_params({"w": np.zeros((2, 5))}) == \
        jax_viz.count_params({"w": np.zeros((2, 5))}) == 10
