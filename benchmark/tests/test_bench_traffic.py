"""The frozen generators give the port's ``bench.py`` batches bit for bit."""

import numpy as np
import pytest
import torch

from benchmark import program, traffic
from benchmark.run import cell_files
from ess_tpu_torch import bench

DSEC = cell_files("dsec_sup_train_b8").conf
DDD17 = cell_files("ddd17_sup_train_b16").conf


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k].cpu().numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("windows", [1, 20])
def test_events_match_make_raw(windows):
    ours = traffic.events(np.random.default_rng(7), DSEC, 2, windows)
    theirs, _ = bench.make_raw(np.random.default_rng(7), 2, windows)
    np.testing.assert_array_equal(ours, theirs)


def test_dsec_batch_matches_make_batch():
    rng = np.random.default_rng(11)
    raw = traffic.events(rng, DSEC, 1, DSEC["windows"])
    host = program.wire(DSEC, raw, "band")
    host["label"] = traffic.labels(rng, DSEC, 1)
    _same(host, bench.make_batch(11, 1, "cpu"))


def test_ddd17_batch_matches_make_ddd17_batch():
    rng = np.random.default_rng(5)
    raw = traffic.events(rng, DDD17, 1, DDD17["windows"])
    host = program.wire(DDD17, raw, "band")
    host["label"] = traffic.labels(rng, DDD17, 1)
    _same(host, bench.make_ddd17_batch(5, 1, "cpu"))


def test_sensor_a_matches_make_uda_batch():
    theirs = bench.make_uda_batch(3, 1, "cpu")
    ours = traffic.sensor_a(np.random.default_rng(4), DSEC, 1)
    for k in ("label_a", "image_a"):
        np.testing.assert_array_equal(ours[k], theirs[k].numpy())


def test_tile_wire_matches_make_stream():
    rng = np.random.default_rng(9)
    raw = traffic.events(rng, DSEC, 2, 2)
    host = program.wire(DSEC, raw, "tile")
    windows = bench.make_stream(9, 2, "cpu", windows=2)
    for w, theirs in enumerate(windows):
        for k, v in host.items():
            np.testing.assert_array_equal(v[:, w], theirs[k].numpy())


def test_seeds_keep_sizes():
    a = traffic.train_batch(DSEC, {"pile": None}, 2 ** 31 + 5, 0)
    b = traffic.train_batch(DSEC, {"pile": None}, 12, 0)
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
    assert not np.array_equal(a["events"], b["events"])
    c = traffic.train_batch(DSEC, {"pile": None}, 2 ** 31 + 5, 0)
    np.testing.assert_array_equal(a["events"], c["events"])
    assert torch.is_tensor(program.to_device({"x": a["label"]}, "cpu")["x"])
