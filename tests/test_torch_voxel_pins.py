"""The voxelizer's opt-in pins against the JAX package: the int8 tent planes
(``voxel_oh_dtype='int8'``), the raw and stack emissions of the fold-free
voxelizer (``raw_windows``, ``stack_windows``), its ``s2d`` / ``deint``
layouts and the builds and rollout branches that take them.

The port runs its plain versions on CPU tensors; the JAX side runs its
Pallas voxelizers in interpret mode (``use_pallas=True,
pallas_interpret=True``). Bounds, each with its reason:

- int8 grids (x-slot, full-width band and tile wires; float coordinates
  and integer ones at 5 and 10 bins, the factored and the tall row plane):
  atol 1e-6 and no cell zero in one grid only. Both compute every quantized
  weight by the same f32 expressions and add exact integer products; JAX
  then scales each 1024-record chunk's sum into an f32 accumulator and
  adds B3's halos in f32, the port scales the exact sum once. Normalized
  grids atol 1e-5 / rtol 1e-5 (the stats' f32 sums in other orders).
- the layouts (``'raw'``, ``'stack'``, ``'s2d'`` with ``deint``, ``'nhwc'``)
  against JAX's with f32 tent planes: atol 2e-3 / rtol 1e-4, the f32
  voxelizer bound of tests/test_torch_voxel.py (JAX's f32 planes evaluate
  the column tent at the global position band * width + x, where f32 keeps
  about 1e-3 of a column), stats rtol 1e-3; the int8 forms at the int8
  bound, stats rtol 1e-5. Every layout equals the port's NCHW grid relaid
  out, stats bit for bit.
- ``build_all_stack``, ``build_all_raw`` (DSEC geometry with a bottom crop
  and JAX's flip draws; a reduced DDD17 geometry, integer records and a
  width resize 70 -> 72) and ``build_all(layout='s2d', time_major=True)``:
  windows atol 2e-3 / rtol 1e-4, the f32 voxelizer bound of
  tests/test_torch_voxel.py (a normalized window moves with the stats'
  summation order), labels equal.
- the supervised and the UDA train step with each pin: in
  tests/test_torch_voxel_pins_steps.py.
- the port's stack and raw forms against its standard build: windows
  and eval outputs equal bit for bit (the same f32 values,
  normalized alike, cast last).
- the branch ``_rollout`` takes for each pin and wire, train and eval,
  equal to JAX's (JAX's s2d branch is the port's ``windows_s2d=True``);
  the in-loop and streaming forms take the int8 planes through
  ``make_window_fn`` (streaming against JAX's ``run_streaming_eval`` at
  the streaming bounds, tests/test_torch_streaming.py).
- ``'s4d'`` from a voxelizer kernel or at sides not divisible by 4, a
  stack of tile events, a stack without x-slots and unknown pins raise, as
  JAX asserts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.ops import voxel_pallas as jvp
from ess_tpu.ops.batch_voxel import voxelize_window_soa as jax_voxelize
from ess_tpu.train import streaming as jax_streaming
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data.pipeline import (AugmentParams, EventPipeline,
                                         PipelineConfig)
from ess_tpu_torch.ops import voxel_folded as vf
from ess_tpu_torch.ops import voxel_scatter as vs
from ess_tpu_torch.ops import voxel_tiled as vt
from ess_tpu_torch.ops.batch_voxel import (band_operands,
                                          voxelize_window_soa)
from ess_tpu_torch.ops.conv_s2d import space_to_depth
from ess_tpu_torch.train import streaming as port_streaming
from ess_tpu_torch.train import supervised as sup
from tests.test_torch_ddd17 import binned_batch
from tests.test_torch_eval_step import B, CLASSES, H, T, W, folded_batch
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread
from tests.test_torch_packed_steps import (jax_batch, packed_batch,
                                           port_modules, torch_batch)
from tests.test_torch_streaming import (assert_states_close, build_both,
                                        capture_final_state, make_stream)
from tests.test_torch_train_step import slice_config

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

INT8_ATOL = 1e-6
PINS = {"stack": {"stack_windows": True}, "raw": {"raw_windows": True},
        "int8": {"voxel_oh_dtype": "int8"}}


def events(rng, b, n, h, w, *, integer=False, edges=False):
    """(b, n, 4) raw windows, a tenth invalid; ``edges`` puts a third of
    the events in (-1, 0) on x or y (B3's wy_fold and left column)."""
    raw = np.zeros((b, n, 4), np.float32)
    if integer:
        raw[..., 0] = rng.integers(0, w, (b, n))
        raw[..., 1] = rng.integers(0, h, (b, n))
    else:
        raw[..., 0] = rng.uniform(-0.9, w - 0.1, (b, n))
        raw[..., 1] = rng.uniform(-0.9, h - 0.1, (b, n))
    if edges:
        k = n // 6
        raw[:, :k, 0] = rng.uniform(-0.99, 0, (b, k))
        raw[:, k:2 * k, 1] = rng.uniform(-0.99, 0, (b, k))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (b, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, n - n // 10:] = False
    return raw, valid


def wire_cols(wire, raw, valid, h, w, *, bins, trilinear):
    """(columns x, y, t, p, valid; offsets; offsets kind) of a wire."""
    if wire == "tile":
        r, v, o = vt.host_tile_bin(raw, valid, height=h, width=w, bins=bins)
        kind = "tile"
    else:
        r, v, o = vf.host_band_bin_folded(raw, valid, height=h, width=w,
                                          bins=bins, trilinear=trilinear,
                                          x_slots=wire == "slots")
        kind = "band"
    return [np.ascontiguousarray(r[..., i]) for i in range(4)] + [v], o, kind


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def zero_pattern(a, b):
    return int(((a != 0) != (b != 0)).sum())


# --- the int8 tent planes ---------------------------------------------------

INT8_CASES = [  # (wire, h, w, trilinear, separate_pol)
    ("slots", 48, 256, True, False), ("slots", 26, 170, True, False),
    ("bands", 48, 256, True, False), ("slots", 52, 300, False, False),
    ("slots", 40, 256, False, True), ("bands", 40, 256, False, True),
    ("tile", 48, 256, True, False), ("tile", 24, 384, True, False),
    ("tile", 40, 256, False, True)]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("case", INT8_CASES,
                         ids=["-".join(map(str, c)) for c in INT8_CASES])
def test_int8_planes_match_jax(case, normalize):
    wire, h, w, trilinear, separate_pol = case
    bins = 10 if separate_pol else 5
    raw, valid = events(np.random.default_rng(h + w), 3, 700, h, w,
                        integer=not trilinear, edges=wire == "tile")
    cols, offs, kind = wire_cols(wire, raw, valid, h, w, bins=bins,
                                 trilinear=trilinear)
    kw = dict(num_bins=5, height=h, width=w, normalize=normalize,
              trilinear=trilinear, separate_pol=separate_pol,
              offsets_kind=kind)
    got = voxelize_window_soa(*map(torch.from_numpy, cols),
                              tile_offsets=torch.from_numpy(offs),
                              oh_dtype="int8", **kw).numpy()
    want = nchw(jax_voxelize(*map(jnp.asarray, cols),
                             tile_offsets=jnp.asarray(offs), use_pallas=True,
                             pallas_interpret=True, oh_dtype=jnp.int8, **kw))
    assert got.shape == want.shape == (3, bins, h, w)
    assert zero_pattern(got, want) == 0
    if normalize:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=INT8_ATOL, rtol=0)
    if not normalize:
        # the quantization is real: each corner moves by up to ~1/127
        f32 = voxelize_window_soa(*map(torch.from_numpy, cols),
                                  tile_offsets=torch.from_numpy(offs),
                                  **kw).numpy()
        assert 1e-4 < np.abs(f32 - got).max() < 0.1


# --- the layouts ------------------------------------------------------------

# the stack needs x-slots: on full-width bands it raises (test_pins_raise)
LAYOUT_CASES = [(slots, layout) for slots in (True, False)
                for layout in ("stack", "raw", "s2d", "nhwc")
                if slots or layout != "stack"]


@pytest.mark.parametrize("oh", ["float32", "int8"])
@pytest.mark.parametrize("slots,layout", LAYOUT_CASES, ids=[
    f"{'slots' if s else 'bands'}-{lay}" for s, lay in LAYOUT_CASES])
def test_voxelize_folded_layouts_match_jax(slots, layout, oh):
    h, w = 48, 256
    raw, valid = events(np.random.default_rng(5), 3, 700, h, w)
    cols, offs, _ = wire_cols("slots" if slots else "bands", raw, valid, h,
                              w, bins=5, trilinear=True)
    args, kw = band_operands(*map(torch.from_numpy, cols),
                             torch.from_numpy(offs), num_bins=5, height=h,
                             width=w)
    deint = layout == "s2d"
    got, got_stats = vf.voxelize_folded(*args, **kw, layout=layout,
                                        oh_dtype=oh, deint=deint)
    want, want_stats = jvp.voxelize_folded(
        *(jnp.asarray(a.numpy()) for a in args), bins=5, height=h, width=w,
        interpret=True, layout=layout, with_stats=True, deint=deint,
        oh_dtype=jnp.int8 if oh == "int8" else jnp.float32)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    q8 = oh == "int8"
    np.testing.assert_allclose(got.numpy(), want,
                               atol=INT8_ATOL if q8 else 2e-3,
                               rtol=0 if q8 else 1e-4)
    np.testing.assert_allclose(got_stats.numpy(), np.asarray(want_stats),
                               rtol=1e-5 if q8 else 1e-3, atol=1e-5)
    # every layout is the NCHW grid relaid out, stats alike
    grid, stats = vf.voxelize_folded(*args, **kw, oh_dtype=oh)
    assert torch.equal(stats, got_stats)
    view = {"stack": vs.relayout(grid, "stack", 24),
            "raw": vs.relayout(grid, "raw", 24),
            "s2d": space_to_depth(grid).permute(0, 2, 3, 1),
            "nhwc": grid.permute(0, 2, 3, 1)}[layout]
    assert torch.equal(got, view)


def test_voxelize_tiled_layouts():
    """B3's ``'nhwc'`` and ``'s2d'`` are its grid relaid out, as JAX's
    layouts of the same kernel (JAX's f32 planes: the f32 bound)."""
    raw, valid = events(np.random.default_rng(6), 2, 500, 48, 256)
    cols, offs, _ = wire_cols("tile", raw, valid, 48, 256, bins=5,
                              trilinear=True)
    x, y, t, p, v = map(torch.from_numpy, cols)
    ts = torch.clamp(t / t.amax(1, keepdim=True) * 4, 0, 4)
    pol = torch.where(v, torch.where(p > 0, 1.0, -1.0), 0.0)
    args = (x, y, ts, pol, torch.from_numpy(offs))
    kw = dict(bins=5, height=48, width=256)
    grid = vt.voxelize_tiled(*args, **kw)
    assert torch.equal(vt.voxelize_tiled(*args, **kw, layout="nhwc"),
                       grid.permute(0, 2, 3, 1))
    s2d = vt.voxelize_tiled(*args, **kw, layout="s2d")
    want = jvp.voxelize_tiled(*(jnp.asarray(a.numpy()) for a in args),
                              **kw, interpret=True, layout="s2d",
                              oh_dtype=jnp.float32)
    np.testing.assert_allclose(s2d.numpy(), np.asarray(want), atol=2e-3,
                               rtol=1e-4)
    assert torch.equal(s2d, space_to_depth(grid).permute(0, 2, 3, 1))


def test_pins_raise():
    raw, valid = events(np.random.default_rng(7), 2, 300, 48, 256)
    cols, offs, _ = wire_cols("bands", raw, valid, 48, 256, bins=5,
                              trilinear=True)
    args, kw = band_operands(*map(torch.from_numpy, cols),
                             torch.from_numpy(offs), num_bins=5, height=48,
                             width=256)
    for layout in ("s4d", "stack", "blocks"):
        with pytest.raises(ValueError, match=layout):
            vf.voxelize_folded(*args, **kw, layout=layout)
    with pytest.raises(ValueError):
        vf.voxelize_folded(*args, **kw, oh_dtype="float16")
    tcols, toffs, _ = wire_cols("tile", raw, valid, 48, 256, bins=5,
                                trilinear=True)
    for layout in ("stack", "raw"):
        with pytest.raises(ValueError, match="band"):
            voxelize_window_soa(*map(torch.from_numpy, tcols),
                                tile_offsets=torch.from_numpy(toffs),
                                offsets_kind="tile", num_bins=5, height=48,
                                width=256, layout=layout)
    # 's4d' is a relayout of the cropped grid (the quad-block rollout's
    # windows), made after the voxelizer: it needs sides divisible by 4
    with pytest.raises(ValueError, match="s4d"):
        voxelize_window_soa(*map(torch.from_numpy, tcols), num_bins=5,
                            height=50, width=256, layout="s4d")
    for bad in ({"voxel_oh_dtype": "fp8"}, {"raw_windows": "yes"}):
        with pytest.raises(ValueError):
            PipelineConfig(sensor_height=48, sensor_width=256, **bad)
    # the stack and raw builds need band offsets
    pipe = EventPipeline(PipelineConfig(sensor_height=48, sensor_width=256,
                                        stack_windows=True))
    batch = {"ev_x": torch.zeros(1, 1, 4), "ev_y": torch.zeros(1, 1, 4),
             "ev_t": torch.zeros(1, 1, 4), "ev_p": torch.zeros(1, 1, 4),
             "ev_valid": torch.ones(1, 1, 4, dtype=torch.bool)}
    assert not pipe.stack_capable(train=False, batch=batch)
    for build in (pipe.build_all_stack, pipe.build_all_raw):
        with pytest.raises(ValueError, match="band offsets"):
            build(batch)


# --- the builds -------------------------------------------------------------

def dsec_pipelines(pin, *, crop=8, flip=True):
    geo = dict(sensor_height=H, sensor_width=W, num_bins=5, trilinear=True,
               normalize=True, crop_bottom=crop, random_flip=flip,
               **PINS.get(pin, {}))
    oh = geo.pop("voxel_oh_dtype", "float32")
    return (JaxPipeline(JaxPipelineConfig(use_pallas=True,
                                          pallas_interpret=True,
                                          voxel_oh_dtype=oh, **geo)),
            EventPipeline(PipelineConfig(voxel_oh_dtype=oh, **geo)))


def flip_key(jpipe, b):
    """A key whose draws flip some samples and not others, and the port's
    draws."""
    for k in range(64):
        rng = jax.random.PRNGKey(k)
        flip = np.asarray(jpipe.sample_augment(rng, b, train=True).flip)
        if flip.any() and not flip.all():
            return rng, AugmentParams(flip=torch.from_numpy(flip.copy()))
    raise AssertionError("no key flips some samples")


def windows_of(built, window_map, permute):
    raw, stats = built["raw"], built["stats"]
    out = [window_map(raw[i], None if stats is None else stats[i])
           for i in range(raw.shape[0])]
    out = [np.asarray(o) for o in out]
    return np.stack([np.moveaxis(o, -1, 1) for o in out] if permute
                    else out)


@pytest.mark.parametrize("pin,oh", [("stack", "float32"), ("raw", "float32"),
                                    ("stack", "int8")])
def test_build_all_stack_raw_dsec_match_jax(pin, oh):
    jpipe, pipe = dsec_pipelines(pin)
    if oh == "int8":
        jpipe = JaxPipeline(dataclasses.replace(jpipe.cfg,
                                                voxel_oh_dtype="int8"))
        pipe = EventPipeline(dataclasses.replace(pipe.cfg,
                                                 voxel_oh_dtype="int8"))
    cols = folded_batch(np.random.default_rng(3))
    rng, aug = flip_key(jpipe, B)
    jbuild = getattr(jpipe, f"build_all_{pin}")
    jb, jlabel, jmap = jbuild(jax_batch(cols), rng, train=True,
                              out_dtype=jnp.float32)
    batch = torch_batch(cols)
    assert getattr(pipe, f"{pin}_capable")(train=True, batch=batch)
    pb, plabel, pmap = getattr(pipe, f"build_all_{pin}")(batch, aug=aug)
    assert pb["raw"].shape == jb["raw"].shape
    want = windows_of(jax.device_get(jb), jmap, True)
    got = windows_of(pb, pmap, False)
    assert got.shape == (T, B, 20, (H - 8) // 2, W // 2)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(plabel.numpy(), np.asarray(jlabel))
    # the standard build's windows in blocks, bit for bit
    std, label = pipe.build_all(batch, aug=aug)
    assert torch.equal(torch.from_numpy(got),
                       torch.stack([space_to_depth(s) for s in std]))
    assert torch.equal(plabel, label)


def test_build_all_raw_ddd17_resize_matches_jax():
    """Integer band records on a 52x70 sensor, 12 bottom rows cropped, the
    width resized 70 -> 72 (normalized, then resized before the map, as
    JAX's resize matrix), flips."""
    sh, sw, crop, resized = 52, 70, 12, (40, 72)
    geo = dict(sensor_height=sh, sensor_width=sw, num_bins=5,
               normalize=True, crop_bottom=crop, resize_to=resized,
               random_flip=True, raw_windows=True)
    jpipe = JaxPipeline(JaxPipelineConfig(use_pallas=True,
                                          pallas_interpret=True,
                                          voxel_oh_dtype="float32", **geo))
    pipe = EventPipeline(PipelineConfig(**geo))
    cols = binned_batch(np.random.default_rng(4), B, T, 600, sh, sw,
                        resized)
    rng, aug = flip_key(jpipe, B)
    jb, jlabel, jmap = jpipe.build_all_raw(jax_batch(cols), rng, train=True,
                                           out_dtype=jnp.float32)
    batch = torch_batch(cols)
    assert pipe.raw_capable(train=True, batch=batch)
    assert not pipe.stack_capable(train=True, batch=batch)   # a resize
    pb, plabel, pmap = pipe.build_all_raw(batch, aug=aug)
    assert pb["stats"] is None and jb["stats"] is None
    got = windows_of(pb, pmap, False)
    want = windows_of(jax.device_get(jb), jmap, True)
    assert got.shape == (T, B, 20, 20, 36)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(plabel.numpy(), np.asarray(jlabel))
    std, _ = pipe.build_all(batch, aug=aug)
    np.testing.assert_allclose(
        got, torch.stack([space_to_depth(s) for s in std]).numpy(),
        atol=1e-5, rtol=1e-5)        # F.interpolate on other extents


@pytest.mark.parametrize("wire", ["band", "tile", "ddd17"])
def test_build_all_s2d_time_major_matches_jax(wire):
    if wire == "ddd17":
        geo = dict(sensor_height=52, sensor_width=70, num_bins=5,
                   normalize=True, crop_bottom=12, resize_to=(40, 72),
                   random_flip=True)
        cols = binned_batch(np.random.default_rng(8), B, T, 600, 52, 70,
                            (40, 72))
    else:
        geo = dict(sensor_height=H, sensor_width=W, num_bins=5,
                   trilinear=True, normalize=True, crop_bottom=8,
                   random_flip=True)
        cols = (folded_batch(np.random.default_rng(8)) if wire == "band"
                else packed_tile_as_f32())
    jpipe = JaxPipeline(JaxPipelineConfig(use_pallas=True,
                                          pallas_interpret=True,
                                          voxel_oh_dtype="float32", **geo))
    pipe = EventPipeline(PipelineConfig(**geo))
    rng, aug = flip_key(jpipe, B)
    want, jlabel = jpipe.build_all(jax_batch(cols), rng, train=True,
                                   layout="s2d", out_dtype=jnp.float32,
                                   time_major=True)
    got, label = pipe.build_all(torch_batch(cols), aug=aug, layout="s2d")
    want = np.moveaxis(np.asarray(want), -1, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
    std, _ = pipe.build_all(torch_batch(cols), aug=aug)
    tol = dict(atol=1e-5, rtol=1e-5) if wire == "ddd17" else dict(atol=0,
                                                                 rtol=0)
    torch.testing.assert_close(
        got, torch.stack([space_to_depth(s) for s in std]), **tol)
    # sample-major
    got_bt, _ = pipe.build_all(torch_batch(cols), aug=aug, layout="s2d",
                               time_major=False)
    assert torch.equal(got_bt, got.transpose(0, 1))


def packed_tile_as_f32():
    """Host tile-sorted f32 events of a DSEC-shaped batch."""
    rng = np.random.default_rng(9)
    raw, valid = events(rng, B * T, 1500, H, W)
    rs, vs_, os_ = vt.host_tile_bin(raw, valid, height=H, width=W)
    label = rng.integers(0, CLASSES, (B, H, W))
    label[:, :3] = 255
    sh = lambda a: a.reshape(B, T, *a.shape[1:])
    return {"ev_x": sh(rs[..., 0]), "ev_y": sh(rs[..., 1]),
            "ev_t": sh(rs[..., 2]), "ev_p": sh(rs[..., 3]),
            "ev_valid": sh(vs_), "ev_tile_offsets": sh(os_), "label": label}


# --- the branch the rollout takes -------------------------------------------

class Branch(Exception):
    pass


def jax_branch(monkeypatch, mods, jpipe, batch, train):
    """The branch JAX's ``_rollout`` takes, read from the first build it
    calls."""
    def hit(name):
        def f(*a, **k):
            raise Branch(name)
        return f

    monkeypatch.setattr(JaxPipeline, "build_all_stack", hit("stack"))
    monkeypatch.setattr(JaxPipeline, "build_all_raw", hit("raw"))
    monkeypatch.setattr(
        JaxPipeline, "build_all",
        lambda self, b, r=None, **k: hit(
            "s2d" if k.get("layout") == "s2d" else "standard")())
    recon = mods.recon_train if train else mods.recon_val
    try:
        jax_sup._rollout(mods, recon, None, batch, jpipe, train=train,
                         rng=jax.random.PRNGKey(0))
    except Branch as b:
        return str(b)
    raise AssertionError("no build was called")


@pytest.mark.parametrize("wire", ["slots", "bands", "tile", "packed_folded",
                                  "packed_tile"])
def test_rollout_takes_jax_branch(wire, monkeypatch):
    cfg = slice_config(None)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_modules(cfg, state)
    if wire.startswith("packed"):
        cols = packed_batch(wire.removeprefix("packed_"), 0)
    else:
        raw, valid = events(np.random.default_rng(2), B * T, 600, H, W)
        c, o, kind = wire_cols(wire, raw, valid, H, W, bins=5,
                               trilinear=True)
        sh = lambda a: a.reshape(B, T, *a.shape[1:])
        cols = {k: sh(a) for k, a in zip(("ev_x", "ev_y", "ev_t", "ev_p",
                                          "ev_valid"), c)}
        cols[f"ev_{kind}_offsets"] = sh(o)
        cols["label"] = np.zeros((B, H, W), np.int64)
    jb, pb = jax_batch(cols), torch_batch(cols)
    for pin in (None, "stack", "raw", "int8"):
        jpipe, pipe = dsec_pipelines(pin, crop=0)
        for train in (False, True):
            want = jax_branch(monkeypatch, mods, jpipe, jb, train)
            recon = pmods.recon_train if train else pmods.recon_val
            got = sup.rollout_form(recon, pb, pipe, train=train,
                                   windows_s2d=True)
            assert got == want, (wire, pin, train)
            if want == "s2d":
                assert sup.rollout_form(recon, pb, pipe,
                                        train=train) == "standard"
    assert sup.rollout_form(pmods.recon_val, pb, pipe, train=False,
                            precompute=False) == "in_loop"


# --- the eval step ---------------------------------------------------------

@pytest.mark.parametrize("wire", ["slots", "packed_folded"])
def test_stack_and_raw_eval_equal_standard(wire):
    """The eval step with each layout pin against the standard build on the
    same batch, bit for bit, and with ``windows_s2d``."""
    cfg = slice_config(None)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_modules(cfg, state)
    cols = (folded_batch(np.random.default_rng(12)) if wire == "slots"
            else packed_batch("folded", 12))
    batch = torch_batch(cols)
    _, std_pipe = dsec_pipelines(None, crop=0, flip=False)
    want = sup.make_eval_step(pmods, std_pipe)(batch)
    outs = {pin: sup.make_eval_step(pmods, dsec_pipelines(
        pin, crop=0, flip=False)[1])(batch) for pin in ("stack", "raw")}
    outs["s2d"] = sup.make_eval_step(pmods, std_pipe, windows_s2d=True)(
        batch)
    for pin, got in outs.items():
        for k in ("loss", "latent8", "img_fake", "pred", "cm"):
            assert torch.equal(got[k], want[k]), (pin, k)


# --- streaming and the in-loop form ------------------------------------------

def test_streaming_takes_int8_planes(monkeypatch):
    """``run_streaming_eval`` on the tile wire with ``voxel_oh_dtype=
    'int8'`` against JAX's at the streaming bounds; the int8 planes reach
    it through ``make_window_fn`` (its state differs from the f32
    core's)."""
    h, w, n = 48, 256, 900
    (jmods, jstate, jpipe), (mods, pipe) = build_both(h, w, True)
    jpipe = JaxPipeline(dataclasses.replace(jpipe.cfg,
                                            voxel_oh_dtype="int8"))
    pipe8 = EventPipeline(dataclasses.replace(pipe.cfg,
                                              voxel_oh_dtype="int8"))
    stream = make_stream(1, "tile", h, w, n, True)
    seen_j = capture_final_state(monkeypatch, jax_streaming)
    want = jax_streaming.run_streaming_eval(jmods, jstate, iter(stream),
                                            jpipe)
    seen_p = capture_final_state(monkeypatch, port_streaming)
    got = port_streaming.run_streaming_eval(mods, iter(stream), pipe8)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert_states_close(seen_p["state"], jax.device_get(seen_j["state"]))
    int8_state = seen_p["state"]
    port_streaming.run_streaming_eval(mods, iter(stream), pipe)
    assert max(float((a - b).abs().max()) for (a, _), (b, _) in
               zip(int8_state, seen_p["state"])) > 1e-6


def test_in_loop_window_fn_takes_int8_planes():
    """``make_window_fn`` (the in-loop rollout's voxelizer) on the folded
    wire: the int8 pipeline's windows are the int8 voxelizer's."""
    cols = folded_batch(np.random.default_rng(13))
    batch = torch_batch(cols)
    _, pipe = dsec_pipelines("int8", crop=8, flip=False)
    fn = pipe.make_window_fn(AugmentParams(), offsets_kind="band")
    col = lambda k: batch[k][:, 0]
    got = fn(col("ev_x"), col("ev_y"), col("ev_t"), col("ev_p"),
             col("ev_valid"), tile_offsets=batch["ev_band_offsets"][:, 0])
    want = voxelize_window_soa(
        col("ev_x"), col("ev_y"), col("ev_t"), col("ev_p"), col("ev_valid"),
        tile_offsets=batch["ev_band_offsets"][:, 0], offsets_kind="band",
        num_bins=5, height=H, width=W, trilinear=True, normalize=True,
        oh_dtype="int8")[:, :, :H - 8]
    assert torch.equal(got, want)
