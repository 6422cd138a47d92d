"""The halo-tiled voxelizer path of the port against the JAX package (CPU).

Inputs come from a numpy seed and go through both packages:

- ``host_tile_bin`` (native and numpy reference) equals the JAX package's
  byte for byte: the native paths run the same C++ (each package builds its
  own copy), the numpy paths the same stable argsort;
- ``bin_events_device`` gives the same offsets and the same multiset of
  events per tile as the JAX ``lax.sort`` version;
- ``voxelize_tiled_ref`` (the plain version the wrapper takes on CPU
  tensors) against ``voxelize_tiled(..., interpret=True)``: atol 2e-3 / rtol
  1e-4 with f32 tent planes (same f32 weights, other summation order: the
  bound of tests/test_voxel_pallas.py), atol 0.02 / rtol 0.03 against the
  default bf16 tent planes (8-bit-mantissa corner weights there);
- ``voxelize_tile`` / ``voxelize_window_soa`` against the JAX dispatcher
  with ``use_pallas=True, pallas_interpret=True`` over sensors, bin counts,
  trilinear on and off, ``separate_pol``, host offsets and none;
- ``to_soa`` (also its pass-through of a packed batch, whose offsets it
  renames) and ``make_window_fn`` (bottom crop, per-sample crop, flip)
  against the JAX pipeline.

Events cover coordinates in (-1, 0), tile edges (rows and columns just below
a tile boundary), ``ts == bins - 1`` (each window's last valid event), an
empty tile and invalid padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ess_tpu.data.native as jax_native
from ess_tpu.data.pipeline import AugmentParams as JaxAug
from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.data.pipeline import to_soa as jax_to_soa
from ess_tpu.ops import voxel_pallas as jvp
from ess_tpu.ops.batch_voxel import voxelize_window_soa as jax_window_soa

from ess_tpu_torch.data.pipeline import (
    AugmentParams, EventPipeline, PipelineConfig, to_soa)
from ess_tpu_torch.ops import voxel_tiled as vt
from ess_tpu_torch.ops.batch_voxel import (
    effective_bins, voxelize_tile, voxelize_window_soa)
from tests.test_torch_host_bin import use_private_jax_native


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


# the JAX side loads its own copy of the native library (test_torch_host_bin)
_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

F32 = dict(atol=2e-3, rtol=1e-4)
BF16 = dict(atol=0.02, rtol=0.03)
# Normalized grids: the nonzero count is part of the statistics, and a cell
# whose only deposit is a weight near f32 epsilon is nonzero in one
# formulation and exactly zero in the other (the tent planes round an
# event's position inside a 128-row accumulator, the port keeps tile-local
# coordinates). Each such cell moves the variance by 1/count, ~2e-4 at these
# sizes, so normalized values carry a relative bound of 2e-3; the cell
# itself normalizes to -mean/std in one package and stays 0 in the other, so
# at most 1 cell in 10,000 may differ in its zero pattern and is left out.
F32_NORM = dict(atol=2e-3, rtol=2e-3)


def assert_close(got, want, normalized=False):
    if not normalized:
        np.testing.assert_allclose(got, want, **F32)
        return
    same = (got != 0) == (want != 0)
    assert (~same).mean() <= 1e-4
    np.testing.assert_allclose(np.where(same, got, 0),
                               np.where(same, want, 0), **F32_NORM)


def raw_events(rng, t_dim, n, h, w, *, bins=5, int_coords=False,
               empty_tile=False):
    """(T, N, 4) raw windows + validity. A third of the float events sit in
    the (-1, 0) border zones and just below tile boundaries; the last tenth
    is invalid padding (some of it with in-frame coordinates)."""
    th = vt.tile_h_for_bins(bins)
    raw = np.zeros((t_dim, n, 4), np.float32)
    if int_coords:
        raw[..., 0] = rng.integers(0, w, (t_dim, n))
        raw[..., 1] = rng.integers(0, h, (t_dim, n))
    else:
        raw[..., 0] = rng.uniform(0, w - 1, (t_dim, n))
        raw[..., 1] = rng.uniform(0, h - 1, (t_dim, n))
        k = n // 12
        frac = rng.uniform(0.05, 0.95, (t_dim, k)).astype(np.float32)
        raw[:, 0:k, 0] = -frac                                  # left border
        raw[:, k:2 * k, 1] = -frac                              # top border
        raw[:, 2 * k:3 * k, 0] = w - 1 + frac                   # right edge
        row = rng.integers(1, max(h // th, 1) + 1, (t_dim, k))
        raw[:, 3 * k:4 * k, 1] = np.minimum(row * th - 1 + frac, h - 0.5)
        col = rng.integers(1, max(w // 128, 1) + 1, (t_dim, k))
        raw[:, 4 * k:5 * k, 0] = np.minimum(col * 128 - 1 + frac, w - 0.5)
        raw[:, 5 * k, :2] = -0.5                                # both borders
    if empty_tile and w > 128:
        raw[..., 0] = np.minimum(raw[..., 0], 126.0)            # tile column 0
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (t_dim, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (t_dim, n))
    valid = np.ones((t_dim, n), bool)
    valid[:, n - n // 10:] = False
    return raw, valid


BIN_CASES = {
    "48x256-b5": dict(h=48, w=256, bins=5),
    "16x16-b5": dict(h=16, w=16, bins=5),
    "48x256-b10": dict(h=48, w=256, bins=10),
    "26x170-b5": dict(h=26, w=170, bins=5),
}


def assert_bytes_equal(got, want):
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert g.tobytes() == w_.tobytes()


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_host_tile_bin_native_matches_jax(case):
    c = BIN_CASES[case]
    raw, valid = raw_events(np.random.default_rng(3), 3, 900, c["h"], c["w"],
                            bins=c["bins"])
    want = jvp.host_tile_bin(raw, valid, height=c["h"], width=c["w"],
                             bins=c["bins"])
    got = vt.host_tile_bin(raw, valid, height=c["h"], width=c["w"],
                           bins=c["bins"])
    assert_bytes_equal(got, want)


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_host_tile_bin_numpy_matches_jax_numpy(case, monkeypatch):
    c = BIN_CASES[case]
    raw, valid = raw_events(np.random.default_rng(4), 2, 700, c["h"], c["w"],
                            bins=c["bins"])
    # the JAX entry point takes its numpy body when its native lib is absent
    monkeypatch.setattr(jax_native, "tile_bin", lambda *a, **k: None)
    want = jvp.host_tile_bin(raw, valid, height=c["h"], width=c["w"],
                             bins=c["bins"])
    got = vt.host_tile_bin_ref(raw, valid, height=c["h"], width=c["w"],
                               bins=c["bins"])
    assert_bytes_equal(got, want)
    # and the native sort agrees with the numpy one
    assert_bytes_equal(vt.host_tile_bin(raw, valid, height=c["h"],
                                        width=c["w"], bins=c["bins"]), got)


def kernel_inputs(rng, h, w, bins, *, b=2, n=900, **kw):
    """Masked, time-normalized (B, N) kernel inputs on the padded grid, as
    ``voxelize_tile`` builds them: (x, y, ts, pol, ok, hp, wp)."""
    raw, valid = raw_events(rng, b, n, h, w, bins=bins, **kw)
    x, y, t = raw[..., 0], raw[..., 1], raw[..., 2]
    ok = valid & (x > -1) & (x < w) & (y > -1) & (y < h)
    t0 = np.where(valid, t, np.inf).min(-1, keepdims=True)
    t1 = np.where(valid, t, -np.inf).max(-1, keepdims=True)
    ts = ((bins - 1) * (t - t0) / (t1 - t0)).astype(np.float32)
    pol = np.where(ok, np.where(raw[..., 3] > 0, 1.0, -1.0), 0.0).astype(
        np.float32)
    th = vt.tile_h_for_bins(bins)
    return x, y, ts, pol, ok, -(-h // th) * th, -(-w // 128) * 128


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_bin_events_device_matches_jax(case):
    c = BIN_CASES[case]
    x, y, ts, pol, ok, hp, wp = kernel_inputs(
        np.random.default_rng(5), c["h"], c["w"], c["bins"])
    kw = dict(height=hp, width=wp, bins=c["bins"])
    want = jax.vmap(lambda *a: jvp.bin_events_device(*a, **kw))(
        *map(jnp.asarray, (x, y, ts, pol, ok)))
    got = vt.bin_events_device(*map(torch.from_numpy, (x, y, ts, pol, ok)),
                               **kw)
    offs_w, offs_g = np.asarray(want[4]), got[4].numpy()
    assert got[4].dtype == torch.int32
    np.testing.assert_array_equal(offs_g, offs_w)
    rec_w = np.stack([np.asarray(a) for a in want[:4]], -1)
    rec_g = np.stack([a.numpy() for a in got[:4]], -1)
    for i in range(x.shape[0]):
        assert offs_g[i, -1] == ok[i].sum()
        for j in range(offs_g.shape[1] - 1):
            lo, hi = offs_g[i, j], offs_g[i, j + 1]
            key = lambda r: sorted(map(tuple, r[i, lo:hi].tolist()))
            assert key(rec_g) == key(rec_w)
    # tile ids agree with the JAX function, border coordinates included
    th = vt.tile_h_for_bins(c["bins"])
    np.testing.assert_array_equal(
        vt.tile_id(torch.from_numpy(x), torch.from_numpy(y), wp, th).numpy(),
        np.asarray(jvp.tile_id(jnp.asarray(x), jnp.asarray(y), wp, th)))


@pytest.mark.parametrize("empty_tile", [False, True])
@pytest.mark.parametrize("case", ["48x256-b5", "16x16-b5", "48x256-b10"])
def test_voxelize_tiled_ref_matches_jax_kernel(case, empty_tile):
    c = BIN_CASES[case]
    bins = c["bins"]
    x, y, ts, pol, ok, hp, wp = kernel_inputs(
        np.random.default_rng(6), c["h"], c["w"], bins,
        empty_tile=empty_tile)
    assert (ts == bins - 1).any(-1).all()       # an event on the last bin
    kw = dict(bins=bins, height=hp, width=wp)
    xs, ys, tss, ps, offs = vt.bin_events_device(
        *map(torch.from_numpy, (x, y, ts, pol, ok)), **kw)
    if empty_tile and wp > 128:
        assert (offs[:, 1] == offs[:, 2]).all()             # tile 1 is empty
    got = vt.voxelize_tiled(xs, ys, tss, ps, offs, **kw).numpy()
    assert got.shape == (x.shape[0], bins, hp, wp)
    jargs = [jnp.asarray(a.numpy()) for a in (xs, ys, tss, ps, offs)]
    want = jvp.voxelize_tiled(*jargs, interpret=True, oh_dtype=jnp.float32,
                              **kw)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    want16 = jvp.voxelize_tiled(*jargs, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want16), **BF16)
    # on the padded grid nothing lands past the sensor's +1 border row and
    # column (events in (dim - 1, dim) reach those; the caller crops them)
    assert not got[:, :, c["h"] + 1:].any()
    assert not got[:, :, :, c["w"] + 1:].any()


def test_border_events_deposit_one_corner():
    """An event in (-1, 0) on both axes deposits exactly its in-frame
    corner, with the bilinear weight (1 + x)(1 + y)."""
    x = torch.tensor([[-0.25]])
    y = torch.tensor([[-0.5]])
    ts = torch.tensor([[2.0]])
    pol = torch.tensor([[1.0]])
    offs = torch.tensor([[0, 1, 1, 1, 1]], dtype=torch.int32)
    grid = vt.voxelize_tiled(x, y, ts, pol, offs, bins=5, height=48,
                             width=256)
    assert grid[0, 2, 0, 0].item() == pytest.approx(0.75 * 0.5)
    assert grid.count_nonzero().item() == 1


TILE_CASES = {
    "48x256-tri-host": dict(h=48, w=256, bins=5, trilinear=True, host=True),
    "48x256-tri-raw": dict(h=48, w=256, bins=5, trilinear=True, host=False),
    "16x16-tri-raw": dict(h=16, w=16, bins=5, trilinear=True, host=False),
    "16x16-int-host": dict(h=16, w=16, bins=5, trilinear=False, host=True),
    "48x256-int-raw": dict(h=48, w=256, bins=5, trilinear=False, host=False),
    "48x256-b10-tri-host": dict(h=48, w=256, bins=10, trilinear=True,
                                host=True),
    "48x256-seppol-host": dict(h=48, w=256, bins=5, trilinear=False,
                               host=True, separate_pol=True),
    "16x16-seppol-raw": dict(h=16, w=16, bins=5, trilinear=False, host=False,
                             separate_pol=True),
    "26x170-tri-host": dict(h=26, w=170, bins=5, trilinear=True, host=True),
}


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_voxelize_tile_matches_jax(case, normalize):
    c = TILE_CASES[case]
    h, w, bins = c["h"], c["w"], c["bins"]
    sep = c.get("separate_pol", False)
    bins_eff = effective_bins(bins, sep, c["trilinear"])
    assert bins_eff == (2 * bins if sep else bins)
    raw, valid = raw_events(np.random.default_rng(7), 3, 800, h, w,
                            bins=bins_eff, int_coords=not c["trilinear"])
    offs = None
    if c["host"]:
        raw, valid, offs = vt.host_tile_bin(raw, valid, height=h, width=w,
                                            bins=bins_eff)
    cols = [np.ascontiguousarray(raw[..., i]) for i in range(4)] + [valid]
    kw = dict(num_bins=bins, height=h, width=w, separate_pol=sep,
              trilinear=c["trilinear"], normalize=normalize)
    want = jax_window_soa(
        *map(jnp.asarray, cols), use_pallas=True, pallas_interpret=True,
        oh_dtype=jnp.float32, offsets_kind="tile",
        tile_offsets=None if offs is None else jnp.asarray(offs), **kw)
    want = np.moveaxis(np.asarray(want), -1, 1)
    targs = list(map(torch.from_numpy, cols))
    toffs = None if offs is None else torch.from_numpy(offs)
    got = voxelize_window_soa(*targs, tile_offsets=toffs,
                              offsets_kind="tile", **kw)
    assert got.shape == (3, bins_eff, h, w)
    assert_close(got.numpy(), want, normalize)
    torch.testing.assert_close(voxelize_tile(*targs, toffs, **kw), got,
                               rtol=0, atol=0)
    # the scatter reference of the JAX package agrees too
    ref = jax_window_soa(*map(jnp.asarray, cols), use_pallas=False, **kw)
    if c["trilinear"]:
        # it truncates where the kernels floor: compare off the (-1, 0) zone
        inside = (cols[0] >= 0) & (cols[1] >= 0)
        args2 = [torch.from_numpy(a) for a in cols[:4]] + [
            torch.from_numpy(valid & inside)]
        ref = jax_window_soa(*[jnp.asarray(a.numpy()) for a in args2],
                             use_pallas=False, **{**kw, "normalize": False})
        got2 = voxelize_window_soa(*args2, **{**kw, "normalize": False})
        np.testing.assert_allclose(
            got2.numpy(), np.moveaxis(np.asarray(ref), -1, 1), **F32)
    else:
        assert_close(got.numpy(), np.moveaxis(np.asarray(ref), -1, 1),
                     normalize)


def test_window_soa_rejects():
    z = torch.zeros(1, 4)
    kw = dict(num_bins=5, height=16, width=16)
    with pytest.raises(ValueError):
        voxelize_window_soa(z, z, z, z, z.bool(), offsets_kind="band", **kw)
    with pytest.raises(ValueError):
        voxelize_window_soa(z, z, z, z, z.bool(), offsets_kind="rows", **kw)
    with pytest.raises(ValueError):
        vt.voxelize_tiled(z, z, z, z, torch.zeros(1, 2, dtype=torch.int32),
                          bins=5, height=16, width=128)
    with pytest.raises(ValueError):
        vt.voxelize_tiled(z, z, z, z, torch.zeros(1, 3, dtype=torch.int32),
                          bins=5, height=24, width=128)


@pytest.mark.parametrize("host", [False, True])
def test_voxelize_trilinear_matches_jax(host):
    h, w = 48, 256
    raw, valid = raw_events(np.random.default_rng(8), 2, 700, h, w)
    offs = None
    if host:
        raw, valid, offs = vt.host_tile_bin(raw, valid, height=h, width=w)
    cols = [np.ascontiguousarray(raw[..., i]) for i in range(4)] + [valid]
    kw = dict(num_bins=5, height=h, width=w)
    want = jvp.voxelize_trilinear_pallas(
        *map(jnp.asarray, cols), interpret=True, oh_dtype=jnp.float32,
        offsets=None if offs is None else jnp.asarray(offs), **kw)
    got = vt.voxelize_trilinear(
        *map(torch.from_numpy, cols),
        offsets=None if offs is None else torch.from_numpy(offs), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_to_soa_matches_jax():
    raw, valid = raw_events(np.random.default_rng(9), 2, 300, 48, 256)
    raw, valid, offs = vt.host_tile_bin(raw, valid, height=48, width=256)
    batch = {"raw_events": raw, "valid": valid, "tile_offsets": offs,
             "is_first": np.bool_(True), "label": np.zeros((4, 4), np.int32)}
    want, got = jax_to_soa(batch), to_soa(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    assert got["ev_x"].flags.c_contiguous
    packed = {"ev_xq": np.zeros((4, 3), np.uint16), "tile_offsets": offs,
              "is_first": np.bool_(True)}
    got, want = to_soa(packed), jax_to_soa(packed)
    assert sorted(got) == sorted(want) == ["ev_tile_offsets", "ev_xq",
                                           "is_first"]
    for k in want:
        assert got[k] is want[k] is packed[k.replace("ev_tile", "tile")]


@pytest.mark.parametrize("kind", ["tile", "raw"])
def test_window_fn_crop_flip_matches_jax(kind):
    """make_window_fn: voxelize, bottom crop, per-sample crop, flip, and
    the same transform on the label."""
    h, w, b = 48, 256, 3
    raw, valid = raw_events(np.random.default_rng(10), b, 600, h, w)
    offs = None
    if kind == "tile":
        raw, valid, offs = vt.host_tile_bin(raw, valid, height=h, width=w)
    cols = [np.ascontiguousarray(raw[..., i]) for i in range(4)] + [valid]
    flip = np.array([True, False, True])
    crop_y, crop_x = np.array([0, 5, 8]), np.array([30, 0, 99])
    label = np.random.default_rng(11).integers(0, 6, (b, h - 8, w))
    geo = dict(sensor_height=h, sensor_width=w, num_bins=5, trilinear=True,
               normalize=True, crop_bottom=8, random_crop=(32, 128),
               random_flip=True)
    jpipe = JaxPipeline(JaxPipelineConfig(
        use_pallas=True, pallas_interpret=True, voxel_oh_dtype="float32",
        **geo))
    jaug = JaxAug(flip=jnp.asarray(flip), crop_y=jnp.asarray(crop_y),
                  crop_x=jnp.asarray(crop_x))
    want = jpipe.make_window_fn(jaug)(
        *map(jnp.asarray, cols),
        tile_offsets=None if offs is None else jnp.asarray(offs))
    pipe = EventPipeline(PipelineConfig(**geo))
    assert pipe.cfg.channels == 5 and pipe.cfg.pre_aug_size == (h - 8, w)
    assert pipe.cfg.output_size(train=False) == (h - 8, w)
    assert pipe.cfg.output_size(train=True) == (32, 128)
    aug = AugmentParams(flip=torch.from_numpy(flip),
                        crop_y=torch.from_numpy(crop_y),
                        crop_x=torch.from_numpy(crop_x))
    got = pipe.make_window_fn(aug)(
        *map(torch.from_numpy, cols),
        tile_offsets=None if offs is None else torch.from_numpy(offs))
    assert got.shape == (b, 5, 32, 128)
    assert_close(got.numpy(), np.moveaxis(np.asarray(want), -1, 1), True)
    np.testing.assert_array_equal(
        pipe.apply_label_transform(torch.from_numpy(label), aug).numpy(),
        np.asarray(jpipe.apply_label_transform(jnp.asarray(label), jaug)))
    # draws: one flip bit and one in-range crop offset per sample
    drawn = pipe.sample_augment(torch.Generator().manual_seed(0), 64,
                                train=True)
    assert drawn.flip.shape == (64,) and drawn.flip.dtype == torch.bool
    assert 0 <= int(drawn.crop_y.min()) and int(drawn.crop_y.max()) <= 8
    assert 0 <= int(drawn.crop_x.min()) and int(drawn.crop_x.max()) <= 128
    assert pipe.sample_augment(None, 4, train=True) == AugmentParams()


@pytest.mark.parametrize("kind", ["tile", "raw"])
def test_build_all_tile_wires_match_jax(kind):
    """build_all on ev_tile_offsets and on offset-free batches, time-major,
    against the JAX pipeline."""
    h, w, b, t_dim, n = 48, 256, 2, 3, 500
    rng = np.random.default_rng(12)
    raws, valids, offs = [], [], []
    for _ in range(b):
        r, v = raw_events(rng, t_dim, n, h, w)
        o = None
        if kind == "tile":
            r, v, o = vt.host_tile_bin(r, v, height=h, width=w)
        raws.append(r), valids.append(v), offs.append(o)
    raw, valid = np.stack(raws), np.stack(valids)
    batch = {"ev_x": raw[..., 0], "ev_y": raw[..., 1], "ev_t": raw[..., 2],
             "ev_p": raw[..., 3], "ev_valid": valid,
             "label": rng.integers(0, 6, (b, h - 8, w))}
    if kind == "tile":
        batch["ev_tile_offsets"] = np.stack(offs)
    geo = dict(sensor_height=h, sensor_width=w, num_bins=5, trilinear=True,
               normalize=True, crop_bottom=8)
    jpipe = JaxPipeline(JaxPipelineConfig(
        use_pallas=True, pallas_interpret=True, voxel_oh_dtype="float32",
        **geo))
    want, _ = jpipe.build_all({k: jnp.asarray(np.ascontiguousarray(v))
                               for k, v in batch.items()}, time_major=True)
    got, lbl = EventPipeline(PipelineConfig(**geo)).build_all(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in batch.items()})
    assert got.shape == (t_dim, b, 5, h - 8, w)
    assert_close(got.numpy(), np.moveaxis(np.asarray(want), -1, 2), True)
    np.testing.assert_array_equal(lbl.numpy(), batch["label"])
