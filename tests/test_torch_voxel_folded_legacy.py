"""The legacy full-width band wire of the fold-free voxelizer against JAX.

Host side: ``host_band_bin_folded(x_slots=False)`` (native, ``ntx=1``) and
its numpy reference against the JAX package's ``host_band_bin_folded(...,
x_slots=False)``, arrays equal (the same C++ in each package's own build,
the same float64 folds and stable sort in numpy).

Device side, on the CPU (the plain version): the port's ``voxelize_band``
on full-width band offsets against
- the JAX ``voxelize_window_soa(use_pallas=True, pallas_interpret=True,
  offsets_kind='band')`` on the same records, which runs the Pallas
  ``_kernel`` with ``k_tiles=1`` in interpret mode with f32 tent planes:
  atol 2e-3 / rtol 1e-4, the bound of tests/test_voxel_pallas.py (f32
  trilinear sums in other orders);
- the JAX scatter reference on the raw events (off the frame-edge zones,
  where that reference places a border coordinate's weight its own way),
  the same bound;
with and without normalization, at 48x256 (2 bands, 2 slots wide) and at
the unaligned 26x170. Then the legacy wire against the slotted wire on the
same events, atol 1e-5 (the same f32 corner weights summed in another
order; the x-slot ghosts split a corner's weight exactly in two), on a
sensor wider than 128 with records on the slot boundaries, and on a window
whose records all fall in one band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ess_tpu.data.native as jax_native
from ess_tpu.ops.batch_voxel import voxelize_window_soa
from ess_tpu.ops.voxel_pallas import host_band_bin_folded as jax_bin

from ess_tpu_torch.ops.batch_voxel import voxelize_band
from ess_tpu_torch.ops.voxel_folded import (
    host_band_bin_folded, host_band_bin_folded_ref, voxelize_folded,
    voxelize_folded_ref)
from tests.test_torch_host_bin import (
    assert_bytes_equal, raw_events, use_private_jax_native)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


# the JAX side loads its own copy of the native library (test_torch_host_bin)
_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

SIZES = [(48, 256), (26, 170)]


def fold(raw, valid, h, w, x_slots):
    r, v, o = host_band_bin_folded(raw, valid, height=h, width=w, bins=5,
                                   x_slots=x_slots)
    return [r[..., 0], r[..., 1], r[..., 2], r[..., 3], v], o


def soa(raw, valid):
    return [raw[..., 0], raw[..., 1], raw[..., 2], raw[..., 3], valid]


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def band(cols, offs, **kw):
    return voxelize_band(*map(torch.from_numpy, cols),
                         torch.from_numpy(offs), **kw).numpy()


@pytest.mark.parametrize("h,w", SIZES)
def test_host_binning_matches_jax(h, w, monkeypatch):
    raw, valid = raw_events(np.random.default_rng(h * w), 3, 900, h, w)
    kw = dict(height=h, width=w, bins=5, x_slots=False)
    want = jax_bin(raw, valid, trilinear=True, **kw)
    got = host_band_bin_folded(raw, valid, **kw)
    assert got[2].shape == (3, -(-h // 24) + 1)
    assert_bytes_equal(got, want)
    # the JAX entry point takes its numpy body when its native lib is absent
    monkeypatch.setattr(jax_native, "band_bin_folded", lambda *a, **k: None)
    want = jax_bin(raw, valid, trilinear=True, **kw)
    assert_bytes_equal(host_band_bin_folded_ref(raw, valid, **kw), want)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("h,w", SIZES)
def test_legacy_wire_matches_jax_kernel(h, w, normalize):
    raw, valid = raw_events(np.random.default_rng(h + w), 3, 800, h, w)
    raw[..., 2] = np.sort(raw[..., 2], axis=-1)
    folded, offs = fold(raw, valid, h, w, x_slots=False)
    assert offs.shape[-1] == -(-h // 24) + 1
    kw = dict(num_bins=5, height=h, width=w, normalize=normalize)
    got = band(folded, offs, **kw)

    kern = voxelize_window_soa(
        *map(jnp.asarray, folded), use_pallas=True, pallas_interpret=True,
        oh_dtype=jnp.float32, tile_offsets=jnp.asarray(offs),
        offsets_kind="band", trilinear=True, **kw)
    np.testing.assert_allclose(got, nchw(kern), atol=2e-3, rtol=1e-4)

    # the scatter reference, on events off the frame-edge zones (it places
    # a border coordinate's weight its own way; both wires agree on them)
    raw, valid = raw_events(np.random.default_rng(w - h), 3, 800, h, w,
                            edges=False)
    folded, offs = fold(raw, valid, h, w, x_slots=False)
    ref = voxelize_window_soa(*map(jnp.asarray, soa(raw, valid)),
                              use_pallas=False, trilinear=True, **kw)
    np.testing.assert_allclose(band(folded, offs, **kw), nchw(ref),
                               atol=2e-3, rtol=1e-4)


def slot_boundary_events(rng, t_dim, n, h, w):
    """Uniform events, a third of them with x just below a 128-column
    boundary (their right corner lands on the next slot's first column)."""
    raw, valid = raw_events(rng, t_dim, n, h, w, edges=False)
    k = n // 3
    slot = rng.integers(1, w // 128 + 1, (t_dim, k))
    raw[:, :k, 0] = np.minimum(slot * 128 - 1 + rng.uniform(
        0.05, 0.95, (t_dim, k)), w - 1)
    raw[..., 2] = np.sort(raw[..., 2], axis=-1)
    return raw, valid


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("case", ["slot_edges", "one_band"])
def test_legacy_wire_matches_slotted_wire(case, normalize):
    h, w = 72, 384
    rng = np.random.default_rng(7)
    raw, valid = slot_boundary_events(rng, 2, 1500, h, w)
    if case == "one_band":
        raw[..., 1] = rng.uniform(24.0, 46.99, raw.shape[:2])
    kw = dict(num_bins=5, height=h, width=w, normalize=normalize)
    legacy, loffs = fold(raw, valid, h, w, x_slots=False)
    slotted, soffs = fold(raw, valid, h, w, x_slots=True)
    assert loffs.shape[-1] == 3 + 1 and soffs.shape[-1] == 3 * 3 + 1
    if case == "one_band":
        live = np.diff(loffs, axis=-1)
        assert (live[:, 1] == loffs[:, -1]).all() and live[:, 1].min() > 0
    g_l = band(legacy, loffs, **kw)
    g_s = band(slotted, soffs, **kw)
    assert np.abs(g_l).sum() > 0
    np.testing.assert_allclose(g_l, g_s, atol=1e-5, rtol=0)


def test_offsets_width_picks_the_wire():
    """Full-width offsets run the band wire, x-slot offsets the slotted one,
    any other width raises; at 128 columns the two are one wire; the stats
    are the grid's sum, sum of squares and nonzero count."""
    h, w = 48, 256
    raw, valid = raw_events(np.random.default_rng(3), 2, 500, h, w)
    cols, offs = fold(raw, valid, h, w, x_slots=False)
    x, y, t, p, _ = map(torch.from_numpy, cols)
    ts = t / t.amax(dim=1, keepdim=True) * 4.0
    args = (x, y, ts, p)
    grid, stats = voxelize_folded(*args, torch.from_numpy(offs), bins=5,
                                  height=h, width=w)
    grid_r, stats_r = voxelize_folded_ref(*args, torch.from_numpy(offs),
                                          bins=5, height=h, width=w)
    assert torch.equal(grid, grid_r) and torch.equal(stats, stats_r)
    torch.testing.assert_close(stats[:, 1], (grid * grid).sum((1, 2, 3)))
    torch.testing.assert_close(stats[:, 2],
                               (grid != 0).sum((1, 2, 3)).float())
    bad = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        voxelize_folded(*args, bad, bins=5, height=h, width=w)
