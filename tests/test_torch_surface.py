"""The rest of the JAX package's library surface in the port, against the
JAX functions on the same seeded inputs.

- ``ops/voxel.py``: ``voxel_grid_temporal`` (both ``separate_pol``) within
  1e-6 relative (the same f32 expressions, one ``index_add_`` order), and
  ``event_histogram`` and ``EventWindow.from_arrays`` exactly, on windows
  with padded lanes, out-of-frame and negative coordinates and a window of
  one time (the ``delta <= 0`` guard);
- ``data/native.py::voxelize_host`` (trilinear, temporal, temporal with
  ``separate_pol``) exactly: both bind the same C++ source; ``available``
  as JAX's; ``recon/color.py::to_uint8`` exactly;
- ``data/readers.py::H5DurationReader`` exactly, on a DSEC ``events.h5``
  written by ``tests/test_datasets_integration.py::make_dsec_seq``
  (``h5py`` and ``cv2``: skipped where absent);
- ``parallel/multihost.py::global_batch_from_local`` on two gloo ranks
  (every rank gets both ranks' rows in rank order, each leaf of a nested
  batch) and on a world of one;
- the fused level's size rule (``ops/level.py::fuses``) against JAX's
  non-interpret ``encoder_level_int8``, traced with ``jax.eval_shape`` at
  ``h_prev`` sizes just below and at its threshold, and the CPU's plain
  version answering below it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data import native as jax_native
from ess_tpu.data.readers import H5DurationReader as JaxH5Reader
from ess_tpu.ops import level_pallas as jax_level
from ess_tpu.ops import voxel as jax_voxel

from ess_tpu_torch.data import native
from ess_tpu_torch.data.readers import H5DurationReader
from ess_tpu_torch.ops import level, voxel
from ess_tpu_torch.parallel import launch, multihost
from tests import torch_dp_worker
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)
_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

H, W, BINS = 30, 41, 5


def window(seed, n=3000, *, one_time=False):
    """(x, y, t, p, valid) numpy columns: float coordinates, a tenth out of
    frame (negative ones included), the last eighth padded lanes."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, W + 3, n).astype(np.float32)
    y = rng.uniform(-3, H + 3, n).astype(np.float32)
    t = (np.full(n, 7.0) if one_time else
         np.sort(rng.uniform(100, 5e4, n))).astype(np.float32)
    p = rng.integers(0, 2, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - n // 8:] = False
    x[~valid] = 1e6                     # garbage in padded lanes
    return x, y, t, p, valid


def both_windows(cols):
    return (jax_voxel.EventWindow.from_arrays(*cols),
            voxel.EventWindow.from_arrays(*cols, device="cpu"))


@pytest.mark.parametrize("separate_pol", [False, True])
@pytest.mark.parametrize("one_time", [False, True])
def test_voxel_grid_temporal_matches_jax(separate_pol, one_time):
    jev, ev = both_windows(window(1, one_time=one_time))
    want = np.asarray(jax_voxel.voxel_grid_temporal(
        jev, num_bins=BINS, height=H, width=W, separate_pol=separate_pol))
    got = voxel.voxel_grid_temporal(ev, num_bins=BINS, height=H, width=W,
                                     separate_pol=separate_pol)
    assert got.shape == want.shape == ((2 if separate_pol else 1) * BINS,
                                       H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.count_nonzero(want) > 100


def test_event_histogram_and_event_window_match_jax():
    cols = window(2)
    jev, ev = both_windows(cols)
    for a, b in zip(ev, jev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        voxel.event_histogram(ev, height=H, width=W).numpy(),
        np.asarray(jax_voxel.event_histogram(jev, height=H, width=W)))
    all_valid = voxel.EventWindow.from_arrays(*cols[:4], device="cpu")
    assert all_valid.valid.dtype == torch.bool and bool(all_valid.valid.all())


@pytest.mark.parametrize("trilinear,separate_pol", [(True, False),
                                                     (False, False),
                                                     (False, True)])
def test_voxelize_host_matches_jax(trilinear, separate_pol):
    cols = [np.stack([window(10 + i)[k] for i in range(3)]) for k in range(5)]
    raw = np.stack(cols[:4], -1)                       # (T, N, 4)
    raw[..., 0] = np.where(cols[4], raw[..., 0], 0)
    kw = dict(num_bins=BINS, height=H, width=W, trilinear=trilinear,
              separate_pol=separate_pol)
    assert jax_native.available()
    want = jax_native.voxelize_host(raw, cols[4], **kw)
    got = native.voxelize_host(raw, cols[4], **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > 100


def test_native_available_and_to_uint8_match_jax():
    from ess_tpu.recon import color as jax_color
    from ess_tpu_torch.recon import color
    assert native.available() and jax_native.available()
    x = np.random.default_rng(4).normal(0.5, 0.6, (30, 40)).astype(
        np.float32)
    np.testing.assert_array_equal(color.to_uint8(x), jax_color.to_uint8(x))


def test_h5_duration_reader_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    pytest.importorskip("cv2")
    from tests.test_datasets_integration import make_dsec_seq
    seq = str(tmp_path / "seq")
    make_dsec_seq(seq, n_events=20000, n_labels=1)
    path = os.path.join(seq, "events", "left", "events.h5")
    for ms in (50.0, 33.3):
        got, want = list(H5DurationReader(path, ms)), list(
            JaxH5Reader(path, ms))
        assert len(got) == len(want) > 10
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape[1] == 4
            np.testing.assert_array_equal(g, w)


def local_batch(rank):
    rng = np.random.default_rng(rank)
    return {"events": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "meta": [rng.integers(0, 9, (2,)), (np.full((2, 1), rank),)]}


def test_global_batch_from_local_on_two_ranks():
    """Each rank holds both ranks' rows, rank 0's first, in every leaf."""
    locals_ = [local_batch(r) for r in range(2)]
    got = launch.spawn(torch_dp_worker.global_batches, 2, (locals_,),
                       device="cpu")
    for g in got:
        np.testing.assert_array_equal(
            g["events"].numpy(),
            np.concatenate([b["events"] for b in locals_]))
        np.testing.assert_array_equal(
            g["meta"][0].numpy(),
            np.concatenate([b["meta"][0] for b in locals_]))
        assert isinstance(g["meta"][1], tuple)
        np.testing.assert_array_equal(g["meta"][1][0].numpy().ravel(),
                                      [0, 0, 1, 1])


def test_global_batch_from_local_on_a_world_of_one():
    b = local_batch(3)
    got = launch.spawn(torch_dp_worker.global_batches, 1, ([b],),
                       device="cpu")[0]
    np.testing.assert_array_equal(got["events"].numpy(), b["events"])
    alone = multihost.global_batch_from_local(b, device="cpu")
    assert alone["events"].device.type == "cpu"
    np.testing.assert_array_equal(alone["meta"][0].numpy(), b["meta"][0])


def jax_fuses(b, ho, wo, ch, cu=32):
    """Whether JAX's non-interpret fused level takes h_prev (b, ho, wo,
    ch): traced abstractly (nothing is compiled or run)."""
    u = jax.ShapeDtypeStruct((b, 2 * ho, 2 * wo, cu), jnp.bfloat16)
    h = jax.ShapeDtypeStruct((b, ho, wo, ch), jnp.bfloat16)
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    out = jax.eval_shape(
        lambda u_, h_, ek, eb, gk, gb: jax_level.encoder_level_int8(
            u_, (h_, h_), ek, eb, gk, gb, u_s2d=False),
        u, h, f32(5, 5, cu, ch), f32(ch), f32(3, 3, 2 * ch, 4 * ch),
        f32(4 * ch))
    return out is not None


@pytest.mark.parametrize("shape", [(1, 25, 625, 64), (1, 25, 624, 64),
                                   (2, 25, 313, 64), (2, 25, 312, 64)])
def test_level_size_rule_matches_jax(shape):
    b, ho, wo, ch = shape
    n = b * ho * wo * ch
    assert level.FUSE_MIN_ELEMENTS == 1_000_000
    assert level.fuses(n) == jax_fuses(*shape) == (n >= 1_000_000)


def test_level_answers_below_the_rule_on_the_cpu():
    """JAX's interpret mode takes every size; so does the CPU's plain
    version (the rule holds on CUDA tensors only)."""
    from ess_tpu_torch.tools import bench_level
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(
        1, (1, 8, 14, 10), 32, False, "cpu")
    assert not level.fuses(h0.numel())
    assert level.encoder_level_int8(u, (h0, c0), ek, eb, gk, gb,
                                    u_s2d=False) is not None
