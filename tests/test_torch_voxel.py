"""Folded voxelizer path of the port (CPU: the plain version) against JAX.

At 48x256 (2 bands x 2 x-slots) and at the unaligned 26x170, the port's
``voxelize_band`` over host-folded records is held against
- the JAX scatter reference on the raw events
  (``voxelize_window_soa(use_pallas=False)``), atol 2e-3 / rtol 1e-4: both
  are f32 trilinear scatters, the bound of tests/test_voxel_pallas.py;
- the JAX slotted Pallas kernel in interpret mode with its default bf16
  tent planes, atol 0.02 / rtol 0.03: bf16 rounds each corner weight to 8
  mantissa bits;
with and without normalization, plus ``EventPipeline.build_all`` with a
bottom crop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.ops.batch_voxel import voxelize_window_soa

from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
from ess_tpu_torch.ops.batch_voxel import voxelize_band
from ess_tpu_torch.ops.voxel import voxel_grid_trilinear
from ess_tpu_torch.ops.voxel_folded import (
    host_band_bin_folded, voxelize_folded, voxelize_folded_ref)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


SIZES = [(48, 256), (26, 170)]


def soa(rng, b, n, h, w):
    x = rng.uniform(0, w - 1, (b, n)).astype(np.float32)
    y = rng.uniform(0, h - 1, (b, n)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e4, (b, n)), axis=1).astype(np.float32)
    p = rng.integers(0, 2, (b, n)).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[:, n - n // 8:] = False
    return x, y, t, p, valid


def fold(x, y, t, p, valid, h, w):
    raw = np.stack([x, y, t, p], axis=-1)
    r, v, o = host_band_bin_folded(raw, valid, height=h, width=w, bins=5)
    return [r[..., 0], r[..., 1], r[..., 2], r[..., 3], v], o


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("h,w", SIZES)
def test_folded_path_matches_jax(h, w, normalize):
    raw = soa(np.random.default_rng(h + w), 3, 800, h, w)
    folded, offs = fold(*raw, h, w)
    kw = dict(num_bins=5, height=h, width=w, normalize=normalize)
    got = voxelize_band(*map(torch.from_numpy, folded),
                        torch.from_numpy(offs), **kw).numpy()

    ref = voxelize_window_soa(*map(jnp.asarray, raw), use_pallas=False,
                              trilinear=True, **kw)
    np.testing.assert_allclose(got, nchw(ref), atol=2e-3, rtol=1e-4)

    kern = voxelize_window_soa(
        *map(jnp.asarray, folded), use_pallas=True, pallas_interpret=True,
        tile_offsets=jnp.asarray(offs), offsets_kind="band", trilinear=True,
        **kw)
    np.testing.assert_allclose(got, nchw(kern), atol=0.02, rtol=0.03)

    # the port's plain scatter on the raw events is the same grid
    plain = voxel_grid_trilinear(*map(torch.from_numpy, raw), **kw).numpy()
    np.testing.assert_allclose(plain, nchw(ref), atol=2e-3, rtol=1e-4)


def test_border_events_keep_in_frame_corner():
    """A coordinate in (-1, 0) deposits only its in-frame corner, on both
    the plain scatter and the folded path (values of
    tests/test_voxel_pallas.py::test_pallas_border_events)."""
    h, w = 24, 256
    x = np.array([[-0.25, 10.0]], np.float32)
    y = np.array([[-0.5, -0.25]], np.float32)
    t = np.array([[0.0, 100.0]], np.float32)
    p = np.ones((1, 2), np.float32)
    valid = np.ones((1, 2), bool)
    kw = dict(num_bins=5, height=h, width=w)
    plain = voxel_grid_trilinear(*map(torch.from_numpy, (x, y, t, p, valid)),
                                 **kw)
    folded, offs = fold(x, y, t, p, valid, h, w)
    band = voxelize_band(*map(torch.from_numpy, folded),
                         torch.from_numpy(offs), **kw)
    for g in (plain, band):
        assert float(g[0, 0, 0, 0]) == pytest.approx(0.75 * 0.5, abs=1e-6)
        assert float(g[0, 4, 0, 10]) == pytest.approx(0.75, abs=1e-6)
        assert float(g.abs().sum()) == pytest.approx(0.75 * 0.5 + 0.75,
                                                     abs=1e-6)


def test_voxelize_folded_stats_and_dispatch():
    """CPU tensors take the plain version; its stats are the grid's sum,
    sum of squares and nonzero count per window."""
    h, w = 48, 256
    folded, offs = fold(*soa(np.random.default_rng(1), 2, 500, h, w), h, w)
    x, y, t, p, _ = map(torch.from_numpy, folded)
    ts = t / t.amax(dim=1, keepdim=True) * 4.0
    args = (x, y, ts, p, torch.from_numpy(offs))
    grid, stats = voxelize_folded(*args, bins=5, height=h, width=w)
    grid_r, stats_r = voxelize_folded_ref(*args, bins=5, height=h, width=w)
    assert torch.equal(grid, grid_r) and torch.equal(stats, stats_r)
    torch.testing.assert_close(stats[:, 0], grid.sum((1, 2, 3)))
    torch.testing.assert_close(stats[:, 2], (grid != 0).sum((1, 2, 3)).float())
    with pytest.raises(ValueError):
        voxelize_folded(*args, bins=5, height=40, width=w)


def test_build_all_matches_jax_with_crop():
    """``build_all`` with the DSEC-style bottom crop (normalize over the
    full sensor, then crop) matches the JAX pipeline's f32-tent build."""
    b, t_dim, n, h, w, crop = 2, 3, 600, 48, 256, 8
    rng = np.random.default_rng(7)
    recs, valids, offs = [], [], []
    for _ in range(b):
        x, y, t, p, valid = soa(rng, t_dim, n, h, w)
        (rx, ry, rt, rp, rv), o = fold(x, y, t, p, valid, h, w)
        recs.append(np.stack([rx, ry, rt, rp], -1))
        valids.append(rv)
        offs.append(o)
    recs, valids, offs = np.stack(recs), np.stack(valids), np.stack(offs)
    label = rng.integers(0, 6, (b, h - crop, w)).astype(np.int32)
    cols = {"ev_x": recs[..., 0], "ev_y": recs[..., 1], "ev_t": recs[..., 2],
            "ev_p": recs[..., 3], "ev_valid": valids,
            "ev_band_offsets": offs, "label": label}

    jpipe = JaxPipeline(JaxPipelineConfig(
        sensor_height=h, sensor_width=w, num_bins=5, trilinear=True,
        normalize=True, crop_bottom=crop, use_pallas=True,
        pallas_interpret=True, voxel_oh_dtype="float32"))
    want, want_lbl = jpipe.build_all({k: jnp.asarray(v)
                                      for k, v in cols.items()})
    pipe = EventPipeline(PipelineConfig(sensor_height=h, sensor_width=w,
                                        num_bins=5, trilinear=True,
                                        normalize=True, crop_bottom=crop))
    got, lbl = pipe.build_all({k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in cols.items()})
    assert got.shape == (t_dim, b, 5, h - crop, w)
    want = np.moveaxis(np.asarray(want), (0, 1, 4), (1, 0, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(want_lbl))
