"""DSEC rectification on the device: the port against the JAX package.

Raw events arrive at integer sensor coordinates, with times relative to
their window, and a rectify map (H, W, 2) sends each pixel to its rectified
float coordinates. Map values lie on a 1/64-pixel lattice (as in
``tests/test_torch_streaming.py``), so the two voxelizer formulations hold
every tent position exactly. Bands of the map send events past each edge
of the frame: below 0 (into the (-1, 0) border zone, where one corner
lands, and below -1), past the right edge and past the bottom edge; a few
sensor coordinates lie outside the sensor, where the gather clips them.
The reference is JAX's Pallas path in interpret mode with f32 tent planes
(``use_pallas=True, pallas_interpret=True``): JAX's XLA scatter truncates
negative coordinates toward zero where the kernels floor them.

- ``rectify_events``: equal to JAX's;
- ``voxelize_window_soa(rectify_map=)`` for the voxel grid (normalized and
  not), the histogram and EV-SegNet: the bounds of
  ``tests/test_torch_voxel_tiled.py`` (``assert_close``) on the voxel
  grid; the histogram equal, EV-SegNet within 1e-6;
- a map with host offsets (tile or band) raises, as JAX's assert, and a
  map on another device than the events raises;
- ``make_pipeline(rectify_map=)`` of a DSEC config against JAX's: the
  same config, and ``build_all`` of a raw batch within those bounds;
- ``run_streaming_eval`` on a stream of raw sensor-coordinate windows with
  a rectifying pipeline against JAX's: the final state within 1e-4 and the
  confusion matrix identical (``tests/test_torch_streaming.py``'s bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.ops.batch_voxel import rectify_events as jax_rectify
from ess_tpu.ops.batch_voxel import voxelize_window_soa as jax_window_soa
from ess_tpu.train import streaming as jax_streaming
from ess_tpu.train.builder import make_pipeline as jax_make_pipeline

from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
from ess_tpu_torch.ops.batch_voxel import rectify_events, voxelize_window_soa
from ess_tpu_torch.train import streaming as port_streaming
from ess_tpu_torch.train.builder import make_pipeline
from tests.test_torch_eval_step import port_config
from tests.test_torch_streaming import (
    assert_states_close, build_both, capture_final_state)
from tests.test_torch_voxel_tiled import assert_close
from tests.test_train_steps import tiny_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


H, W = 48, 256


def rectify_map(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 2) map: each pixel moved by a sub-pixel offset on the 1/64
    lattice, with bands that leave the frame on every side."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    off = rng.integers(-32, 33, (h, w, 2)) / 64.0
    m = np.stack([xx, yy], -1) + off
    m[:, :3, 0] -= (np.arange(3)[None, :] + 0.75)   # x in (-1, 0) and < -1
    m[:2, :, 1] -= 1.5                               # y below -1 and (-1, 0)
    m[:, -3:, 0] += 1.25                             # past the right edge
    m[-3:, :, 1] += 2.0                              # past the bottom edge
    return m.astype(np.float32)


def sensor_events(rng, b: int, n: int, h: int, w: int):
    """(B, N) columns of raw events at integer sensor coordinates (a few
    outside the sensor), window-relative times, +-1 polarity as 0 / 1, the
    last tenth invalid."""
    x = rng.integers(0, w, (b, n)).astype(np.float32)
    y = rng.integers(0, h, (b, n)).astype(np.float32)
    x[:, :5], y[:, 5:10] = -2.0, h + 3.0             # clipped by the gather
    t = np.sort(rng.uniform(0, 5e4, (b, n)), -1).astype(np.float32)
    p = rng.integers(0, 2, (b, n)).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[:, n - n // 10:] = False
    return [x, y, t, p, valid]


def test_rectify_events_matches_jax():
    rng = np.random.default_rng(0)
    m = rectify_map(rng, H, W)
    x, y = sensor_events(rng, 3, 700, H, W)[:2]
    x[0, :4] = [-0.5, W - 0.5, W + 10.0, 1e6]       # casts and clips
    want = jax_rectify(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
    got = rectify_events(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(m))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    inside = (got[0] >= 0) & (got[0] <= W - 1) & (got[1] >= 0) & (
        got[1] <= H - 1)
    assert (~inside).float().mean() > 0.05           # the edges are tested
    assert (got[0] < -1).any() and ((got[1] > -1) & (got[1] < 0)).any()
    assert (got[0] > W - 1).any() and (got[1] > H - 1).any()


@pytest.mark.parametrize("case", ["voxel_grid", "voxel_grid_normalized",
                                  "histogram", "ev_segnet"])
def test_rectified_window_matches_jax(case):
    rng = np.random.default_rng(1)
    m = rectify_map(rng, H, W)
    cols = sensor_events(rng, 3, 900, H, W)
    rep = case.removesuffix("_normalized")
    kw = dict(num_bins=5, height=H, width=W, representation=rep,
              normalize=case.endswith("normalized"))
    # trilinear is forced on by the map in both packages
    want = jax_window_soa(*map(jnp.asarray, cols), rectify_map=jnp.asarray(m),
                          use_pallas=True, pallas_interpret=True,
                          oh_dtype=jnp.float32, trilinear=False, **kw)
    want = np.moveaxis(np.asarray(want), -1, 1)
    got = voxelize_window_soa(*map(torch.from_numpy, cols),
                              rectify_map=torch.from_numpy(m),
                              trilinear=False, **kw).numpy()
    assert got.shape == want.shape and np.abs(want).sum() > 0
    if rep == "voxel_grid":
        assert_close(got, want, kw["normalize"])
    elif rep == "histogram":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_rectify_with_offsets_or_elsewhere_raises():
    rng = np.random.default_rng(2)
    m = torch.from_numpy(rectify_map(rng, 16, 16))
    cols = list(map(torch.from_numpy, sensor_events(rng, 1, 64, 16, 16)))
    offs = torch.zeros(1, 3, dtype=torch.int32)
    for kind in ("tile", "band"):
        with pytest.raises(ValueError, match="before rectification"):
            voxelize_window_soa(*cols, num_bins=5, height=16, width=16,
                                rectify_map=m, tile_offsets=offs,
                                offsets_kind=kind)
    with pytest.raises(ValueError, match="lies on"):
        rectify_events(cols[0], cols[1], m.to("meta"))
    with pytest.raises(ValueError, match="requires a rectify_map"):
        EventPipeline(PipelineConfig(sensor_height=16, sensor_width=16,
                                     rectify=True))


def dsec_config():
    cfg = tiny_config(event_name="DSEC_events")
    return cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, sensor_b=dataclasses.replace(
            cfg.dataset.sensor_b, shape=(440, 640), nr_events_data=2)))


def test_make_pipeline_rectifies_like_jax():
    cfg = dsec_config()
    rng = np.random.default_rng(3)
    m = rectify_map(rng, 480, 640)
    jpipe = jax_make_pipeline(cfg, train=False, rectify_map=m)
    pipe = make_pipeline(port_config(cfg), train=False, rectify_map=m,
                         device="cpu")
    assert pipe.cfg.rectify and jpipe.cfg.rectify
    assert pipe.rectify_map.dtype == torch.float32
    for f in dataclasses.fields(pipe.cfg):
        assert getattr(pipe.cfg, f.name) == getattr(jpipe.cfg, f.name), f.name
    assert not make_pipeline(port_config(cfg), train=False).cfg.rectify
    # the JAX reference on its Pallas path (interpret mode, f32 tent planes)
    jpipe = JaxPipeline(dataclasses.replace(
        jpipe.cfg, use_pallas=True, pallas_interpret=True,
        voxel_oh_dtype="float32"), m)

    b, t_dim, n = 1, 2, 1200
    cols = [np.stack(c, 1) for c in zip(*(sensor_events(rng, b, n, 480, 640)
                                          for _ in range(t_dim)))]
    batch = dict(zip(("ev_x", "ev_y", "ev_t", "ev_p", "ev_valid"), cols))
    batch["label"] = rng.integers(0, 6, (b, 440, 640))
    want, _ = jpipe.build_all({k: jnp.asarray(v) for k, v in batch.items()},
                              time_major=True)
    got, label = pipe.build_all({k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert got.shape == (t_dim, b, 5, 440, 640)
    assert_close(got.numpy(), np.moveaxis(np.asarray(want), -1, 2), True)
    np.testing.assert_array_equal(label.numpy(), batch["label"])


def raw_stream(rng, h, w, n, n_windows=6, label_every=3, resets=(0, 4)):
    """Samples as ``SequenceRecurrent`` yields them on the raw wire, at
    sensor coordinates: (1, N, 4) events, flags, a label."""
    out = []
    for i in range(n_windows):
        x, y, t, p, valid = sensor_events(rng, 1, n, h, w)
        out.append({"raw_events": np.stack([x, y, t, p], -1),
                    "valid": valid, "is_first": np.bool_(i in resets),
                    "has_label": np.bool_(i % label_every == label_every - 1),
                    "label": rng.integers(0, 6, (h, w)).astype(np.int32)})
    return out


def test_streaming_rectifies_like_jax(monkeypatch):
    rng = np.random.default_rng(4)
    m = rectify_map(rng, H, W)
    (jmods, jstate, jpipe), (mods, pipe) = build_both(H, W, trilinear=False)
    jpipe = JaxPipeline(dataclasses.replace(jpipe.cfg, rectify=True), m)
    pipe = EventPipeline(dataclasses.replace(pipe.cfg, rectify=True), m,
                         device="cpu")
    stream = raw_stream(rng, H, W, 900)

    seen_j = capture_final_state(monkeypatch, jax_streaming)
    want = jax_streaming.run_streaming_eval(jmods, jstate, iter(stream),
                                            jpipe)
    seen_p = capture_final_state(monkeypatch, port_streaming)
    got = port_streaming.run_streaming_eval(mods, iter(stream), pipe)
    assert got.confusion.sum() == 2 * H * W
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert_states_close(seen_p["state"], jax.device_get(seen_j["state"]))
