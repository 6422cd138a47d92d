"""The ``histogram`` and ``ev_segnet`` event representations against the JAX
package.

- ``voxelize_window_soa(representation=...)`` against JAX's on the same
  seeded windows: DSEC-like float coordinates spilling past every border
  (x in (-1, 0) lands in column 0: both cast toward zero), integer DDD17
  coordinates at 260x346, an empty window and partly valid ones, raw and
  host tile-sorted (the scatter ignores the offsets). The histogram is
  exact; ``ev_segnet`` rtol 1e-5 / atol 1e-6 (f32 sums of normalized
  times in another order). Neither normalizes, as in JAX, and folded band
  records raise in both packages.
- ``EventPipeline.build_all`` through both packages' ``make_pipeline`` at
  DDD17's 260x346 geometry (60-row crop, resize to 200x352, the UDA
  train pipeline's bottom-anchored 120x216 crop and flip with JAX's
  draws): windows atol 1e-4 / rtol 1e-5, labels equal. The resize's f32
  sampling positions near column 346 are exact to an ulp (3e-5), so a
  weight moves by as much times the difference of two neighbouring values
  (counts up to 2 here; 6.1e-5 read).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops import batch_voxel as jax_bv
from ess_tpu.train.builder import make_pipeline as jax_make_pipeline

from ess_tpu_torch.data.pipeline import (AugmentParams, EventPipeline,
                                         PipelineConfig)
from ess_tpu_torch.ops import batch_voxel
from ess_tpu_torch.ops.voxel_tiled import host_tile_bin
from ess_tpu_torch.train.builder import make_pipeline
from tests.test_torch_ddd17 import ddd17_cfg, int_events, jax_aug_with_flip
from tests.test_torch_eval_step import port_config
from tests.test_torch_host_bin import use_private_jax_native


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

TOL = {"histogram": dict(rtol=0, atol=0),
       "ev_segnet": dict(rtol=1e-5, atol=1e-6)}
PIPE_TOL = dict(rtol=1e-5, atol=1e-4)
REPS = ("histogram", "ev_segnet")


def float_events(rng, b, n, h, w):
    """(B, N) DSEC-like windows: float coordinates over [-1.5, dim + 0.5)
    (a quarter of the x in (-1, 0)), window 0 with no valid event, the
    others with about a tenth invalid."""
    x = rng.uniform(-1.5, w + 0.5, (b, n)).astype(np.float32)
    x[:, : n // 4] = rng.uniform(-1, 0, (b, n // 4))
    y = rng.uniform(-1.5, h + 0.5, (b, n)).astype(np.float32)
    t = np.sort(rng.uniform(0, 5e4, (b, n)), -1).astype(np.float32)
    p = rng.integers(0, 2, (b, n)).astype(np.float32)
    valid = rng.random((b, n)) > 0.1
    valid[0] = False
    return x, y, t, p, valid


def both(rep, cols, h, w, offsets=None):
    """(the port's grid, JAX's as NCHW) of the columns."""
    kw = dict(num_bins=5, height=h, width=w, representation=rep,
              normalize=True)
    want = jax_bv.voxelize_window_soa(
        *(jnp.asarray(c) for c in cols), trilinear=True,
        tile_offsets=None if offsets is None else jnp.asarray(offsets), **kw)
    got = batch_voxel.voxelize_window_soa(
        *(torch.from_numpy(np.ascontiguousarray(c)) for c in cols),
        trilinear=True,
        tile_offsets=None if offsets is None else torch.from_numpy(offsets),
        **kw)
    return got.numpy(), np.moveaxis(np.asarray(want), -1, 1)


@pytest.mark.parametrize("rep", REPS)
def test_float_coordinates_match_jax(rep):
    cols = float_events(np.random.default_rng(0), 4, 3000, 24, 40)
    got, want = both(rep, cols, 24, 40)
    assert got.shape == (4, 2 if rep == "histogram" else 6, 24, 40)
    np.testing.assert_allclose(got, want, **TOL[rep])
    assert not got[0].any()                  # no valid event: zeros
    x, y, _, p, valid = cols
    # column 0 holds the events with x in (-1, 0) too; nothing is normalized
    counts = got[1, :2].sum(0) if rep == "ev_segnet" else got[1].sum(0)
    inside = (valid[1] & (x[1] > -1) & (x[1] < 40) & (y[1] > -1)
              & (y[1] < 24))
    assert counts.sum() == inside.sum()
    assert counts[:, 0].sum() == (inside & (x[1] < 1)).sum()


@pytest.mark.parametrize("rep", REPS)
def test_integer_coordinates_match_jax(rep):
    """DDD17 windows: integer coordinates on 260x346, a few outside, the
    last tenth of each window invalid; raw and host tile-sorted."""
    raw, valid = int_events(np.random.default_rng(1), 1, 3, 4000, 260, 346)
    cols = tuple(raw[0, ..., i] for i in range(4)) + (valid[0],)
    got, want = both(rep, cols, 260, 346)
    np.testing.assert_allclose(got, want, **TOL[rep])
    sraw, svalid, offs = host_tile_bin(raw[0], valid[0], height=260,
                                       width=346)
    sorted_cols = tuple(sraw[..., i] for i in range(4)) + (svalid,)
    got_t, want_t = both(rep, sorted_cols, 260, 346, offs)
    np.testing.assert_allclose(got_t, want_t, **TOL[rep])
    np.testing.assert_allclose(got_t, got, **TOL[rep])


@pytest.mark.parametrize("rep", REPS)
def test_band_records_raise(rep):
    cols = float_events(np.random.default_rng(2), 2, 100, 8, 8)
    offs = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError, match="raw events"):
        batch_voxel.voxelize_window_soa(
            *(torch.from_numpy(np.ascontiguousarray(c)) for c in cols),
            num_bins=5, height=8, width=8, representation=rep,
            tile_offsets=torch.from_numpy(offs), offsets_kind="band")
    with pytest.raises(AssertionError):
        jax_bv.voxelize_window_soa(
            *(jnp.asarray(c) for c in cols), num_bins=5, height=8, width=8,
            representation=rep, tile_offsets=jnp.asarray(offs),
            offsets_kind="band")


def test_pipeline_config_channels_and_names():
    """``channels`` is the grid's real count (JAX's property says
    ``num_bins`` for ``ev_segnet``); an unknown name raises."""
    kw = dict(sensor_height=8, sensor_width=8, num_bins=5)
    assert [PipelineConfig(representation=r, **kw).channels
            for r in ("voxel_grid",) + REPS] == [5, 2, 6]
    with pytest.raises(ValueError, match="unknown representation"):
        PipelineConfig(representation="voxel", **kw)


@pytest.mark.parametrize("model_name,train", [
    ("ess", True), ("ess_supervised", True), ("ess_supervised", False)])
@pytest.mark.parametrize("rep", REPS)
def test_build_all_at_ddd17_geometry_matches_jax(rep, model_name, train):
    """B=2, T=2 windows of 3000 integer events at 260x346 through both
    packages' ``make_pipeline``, host tile-sorted as the CLI's loaders
    send them: the crop of 60 rows, the resize to 200x352, and for
    training the flip (and, UDA, the 120x216 crop at y = 80)."""
    cfg = ddd17_cfg(model_name)
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset, sensor_b=dataclasses.replace(
            cfg.dataset.sensor_b, event_representation=rep)))
    jpipe = jax_make_pipeline(cfg, train=train)
    pipe = make_pipeline(port_config(cfg), train=train)
    assert pipe.cfg.representation == jpipe.cfg.representation == rep
    raw, valid = int_events(np.random.default_rng(3), 2, 2, 3000, 260, 346)
    binned = [host_tile_bin(raw[i], valid[i], height=260, width=346)
              for i in range(2)]
    sraw = np.stack([b_[0] for b_ in binned])
    cols = {"ev_x": sraw[..., 0], "ev_y": sraw[..., 1],
            "ev_t": sraw[..., 2], "ev_p": sraw[..., 3],
            "ev_valid": np.stack([b_[1] for b_ in binned]),
            "ev_tile_offsets": np.stack([b_[2] for b_ in binned]),
            "label": np.random.default_rng(4).integers(
                0, 6, (2, 200, 352)).astype(np.int32)}
    rng, aug = None, AugmentParams()
    if train:
        rng, jaug = jax_aug_with_flip(jpipe, 2)
        aug = AugmentParams(*(None if a is None else
                              torch.from_numpy(np.asarray(a).copy())
                              for a in (jaug.flip, jaug.crop_y, jaug.crop_x)))
    grids_j, label_j = jpipe.build_all(
        {k: jnp.asarray(v) for k, v in cols.items()}, rng, train=train)
    windows, label = pipe.build_all(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in cols.items()}, aug=aug)
    assert windows.shape == (2, 2, pipe.cfg.channels) + tuple(
        pipe.cfg.output_size(train))
    np.testing.assert_allclose(windows.permute(1, 0, 3, 4, 2).numpy(),
                               np.asarray(grids_j), **PIPE_TOL)
    np.testing.assert_array_equal(label.numpy(), np.asarray(label_j))
    assert isinstance(pipe, EventPipeline)
