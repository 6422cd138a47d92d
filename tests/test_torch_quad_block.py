"""The quad-block rollout against the JAX package's and against the port's
standard block-space rollout.

``RecurrentUNet(quad_block=True)`` takes 4x4 space-to-depth windows: the
head and the first encoder's conv run on them (the head 5 -> 80 input
channels at 5 bins), the first ConvLSTM cell on 2x2 space-to-depth state,
the second encoder's conv on that s2d hidden state. Every form is an exact
remap of the same parameters, carried across from JAX's by
``io/convert.py::params_from_jax``.

Bounds: latents, states and images atol 1e-4 / rtol 1e-4 against JAX's quad
model and against the port's standard block-space rollout (the same f32
math summed in other orders, over three carried windows); the s4d build
(``build_all(layout='s4d')``) against JAX's on the x-slot, full-width band
and tile wires at the f32 voxelizer bound of tests/test_torch_voxel.py
(atol 2e-3 / rtol 1e-4) and bit for bit against the port's standard build
relaid; the branch ``_rollout`` takes under quad on five wires equal to
JAX's; the train step with a quad model against JAX's (loss rtol 1e-4,
head parameters atol 1e-5, tests/test_torch_train_step.py's bounds) and
against the port's standard rollout (loss rtol 1e-5); streaming with a
quad model against the standard one at the same bounds as the model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.models import RecurrentUNet as JaxUNet
from ess_tpu.models import zero_recurrent_state as jax_zero_state
from ess_tpu.ops.conv_s2d import space_to_depth4 as jax_s2d4
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data.pipeline import AugmentParams, EventPipeline
from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.models.e2vid import RecurrentUNet, zero_recurrent_state
from ess_tpu_torch.ops.conv_s2d import (
    depth_to_space, space_to_depth, space_to_depth4)
from ess_tpu_torch.train import streaming as port_streaming
from ess_tpu_torch.train import supervised as sup
from ess_tpu_torch.train.builder import build_modules, init_state
from tests.test_torch_eval_step import B, H, T, W, folded_batch, port_config
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread
from tests.test_torch_packed_steps import (jax_batch, packed_batch,
                                           torch_batch)
from tests.test_torch_train_step import jax_flips, slice_config
from tests.test_torch_voxel_pins import (dsec_pipelines, events, flip_key,
                                         wire_cols)

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = 8


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_quad_params():
    model = JaxUNet(base_channels=BASE, num_encoders=3)
    x = jnp.zeros((1, 32, 48, 5))
    st = jax_zero_state(1, 32, 48, num_encoders=3, base_channels=BASE)
    return to_np(model.init(jax.random.PRNGKey(1), x, st)["params"])


def test_quad_model_matches_jax_and_the_standard_rollout(jax_quad_params):
    """Three carried windows (decode off, off, on): the port's quad model
    against JAX's, and against its own standard block-space model on 2x2
    windows (level 0's state relaid)."""
    h, w = 32, 48
    params = jax_quad_params
    model = JaxUNet(base_channels=BASE, num_encoders=3, quad_block=True,
                    lstm_impl="xla")
    sd, _ = params_from_jax(params, to_np(jax_head_params()))
    quad = RecurrentUNet(base_channels=BASE, quad_block=True, lstm_impl="xla")
    std = RecurrentUNet(base_channels=BASE, lstm_impl="xla")
    quad.load_state_dict(sd)
    std.load_state_dict(sd)
    xs = np.random.default_rng(3).normal(size=(3, B, h, w, 5)).astype(
        np.float32)
    st_j = jax_zero_state(B, h, w, num_encoders=3, base_channels=BASE,
                          quad_block=True)
    zero = lambda q: zero_recurrent_state(B, h, w, num_encoders=3,
                                          base_channels=BASE, quad_block=q,
                                          device="cpu")
    st_q, st_s = zero(True), zero(False)
    assert st_q[0][0].shape == (B, 4 * 2 * BASE, h // 4, w // 4)
    with torch.no_grad():
        for i, decode in enumerate((False, False, True)):
            img_j, st_j, lat_j = model.apply(
                {"params": params}, jax_s2d4(jnp.asarray(xs[i])), st_j,
                decode=decode, block_input=True)
            x = torch.from_numpy(nchw(xs[i]))
            img_q, st_q, lat_q = quad(space_to_depth4(x), st_q,
                                      decode=decode, block_input=True)
            img_s, st_s, lat_s = std(space_to_depth(x), st_s, decode=decode,
                                     block_input=True)
            assert sorted(lat_q) == ([1, 2, 4, 8] if decode else [2, 4, 8])
            for s in lat_q:
                np.testing.assert_allclose(lat_q[s].numpy(), nchw(lat_j[s]),
                                           **TOL)
                np.testing.assert_allclose(lat_q[s].numpy(),
                                           lat_s[s].numpy(), **TOL)
            for lvl, ((hj, cj), (hq, cq), (hs, cs)) in enumerate(
                    zip(st_j, st_q, st_s)):
                np.testing.assert_allclose(hq.numpy(), nchw(hj), **TOL)
                np.testing.assert_allclose(cq.numpy(), nchw(cj), **TOL)
                relaid = depth_to_space if lvl == 0 else (lambda t: t)
                np.testing.assert_allclose(relaid(cq).numpy(), cs.numpy(),
                                           **TOL)
            if decode:
                np.testing.assert_allclose(img_q.numpy(), nchw(img_j), **TOL)
                np.testing.assert_allclose(img_q.numpy(), img_s.numpy(),
                                           **TOL)
    with pytest.raises(ValueError):
        RecurrentUNet(base_channels=BASE, quad_block=True,
                      recurrent_block="convgru")


def jax_head_params():
    from ess_tpu.models import SegmentationHead as JaxHead
    head = JaxHead(num_classes=6, input_features=8 * BASE)
    latent = {s: jnp.zeros((1, 32 // s, 48 // s, BASE * s if s > 1 else BASE))
              for s in (1, 2, 4, 8)}
    return head.init(jax.random.PRNGKey(2), latent)["params"]


# --- the builds and the branch ------------------------------------------

@pytest.mark.parametrize("wire", ["slots", "bands", "tile"])
def test_build_all_s4d_matches_jax(wire):
    """``build_all(layout='s4d')`` with a bottom crop and JAX's flips
    against JAX's s4d build, and against the port's standard build relaid
    into 4x4 blocks."""
    raw, valid = events(np.random.default_rng(8), B * T, 1500, H, W)
    c, o, kind = wire_cols(wire, raw, valid, H, W, bins=5, trilinear=True)
    sh = lambda a: a.reshape(B, T, *a.shape[1:])
    cols = {k: sh(a) for k, a in zip(("ev_x", "ev_y", "ev_t", "ev_p",
                                      "ev_valid"), c)}
    cols[f"ev_{kind}_offsets"] = sh(o)
    cols["label"] = np.random.default_rng(9).integers(0, 6, (B, H, W))
    jpipe, pipe = dsec_pipelines(None, crop=8)
    assert pipe.s4d_capable(train=True) == jpipe.s4d_capable(train=True)
    rng, aug = flip_key(jpipe, B)
    want, jlabel = jpipe.build_all(jax_batch(cols), rng, train=True,
                                   layout="s4d", out_dtype=jnp.float32,
                                   time_major=True)
    got, label = pipe.build_all(torch_batch(cols), aug=aug, layout="s4d")
    want = np.moveaxis(np.asarray(want), -1, 2)
    assert got.shape == want.shape == (T, B, 80, (H - 8) // 4, W // 4)
    assert got.is_contiguous(memory_format=torch.channels_last) or \
        got[0].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
    std, _ = pipe.build_all(torch_batch(cols), aug=aug)
    assert torch.equal(got, torch.stack([space_to_depth4(s) for s in std]))


def test_s4d_needs_a_4_aligned_geometry():
    from ess_tpu_torch.data.pipeline import PipelineConfig
    pipe = EventPipeline(PipelineConfig(sensor_height=H, sensor_width=W,
                                        crop_bottom=6))
    assert pipe.s2d_capable(train=False) and not pipe.s4d_capable(
        train=False)
    with pytest.raises(ValueError, match="s4d"):
        pipe.build_all(torch_batch(folded_batch(np.random.default_rng(0))),
                       layout="s4d")


class Branch(Exception):
    pass


def jax_branch(monkeypatch, mods, jpipe, batch, train):
    """The branch JAX's ``_rollout`` takes, read from the first build it
    calls (the layout of ``build_all``)."""
    def hit(name):
        def f(*a, **k):
            raise Branch(name)
        return f

    monkeypatch.setattr(JaxPipeline, "build_all_stack", hit("stack"))
    monkeypatch.setattr(JaxPipeline, "build_all_raw", hit("raw"))
    monkeypatch.setattr(
        JaxPipeline, "build_all",
        lambda self, b, r=None, **k: hit(k.get("layout") or "standard")())
    recon = mods.recon_train if train else mods.recon_val
    try:
        jax_sup._rollout(mods, recon, None, batch, jpipe, train=train,
                         rng=jax.random.PRNGKey(0))
    except Branch as b:
        return str(b)
    raise AssertionError("no build was called")


def jax_quad_modules(cfg):
    mods = jax_build(cfg)
    quad = lambda r: dataclasses.replace(
        r, model=r.model.clone(quad_block=True))
    return dataclasses.replace(mods, recon_train=quad(mods.recon_train),
                               recon_val=quad(mods.recon_val))


def port_quad_modules(cfg, state, quad=True):
    mods = build_modules(port_config(cfg), device="cpu", quad_block=quad)
    sd_e, sd_h = params_from_jax(jax.device_get(state.e2vid_params),
                                 jax.device_get(state.back_params))
    mods.e2vid.load_state_dict(sd_e)
    mods.head.load_state_dict(sd_h)
    return mods


@pytest.mark.parametrize("wire", ["slots", "bands", "tile", "packed_folded",
                                  "packed_tile"])
def test_quad_rollout_takes_jax_branch(wire, monkeypatch):
    """Under quad: the s4d build wherever JAX takes it (no stack or raw
    branch, whatever the pins), the standard build where the geometry is
    not 4-aligned."""
    cfg = slice_config(None)
    mods = jax_quad_modules(cfg)
    pmods = port_quad_modules(cfg, jax_init_state(jax_build(cfg),
                                                  jax.random.PRNGKey(0)))
    assert pmods.recon_train.quad and pmods.recon_val.quad
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
    seen = set()
    for pin in (None, "stack", "raw"):
        jpipe, pipe = dsec_pipelines(pin, crop=0)
        for train in (False, True):
            want = jax_branch(monkeypatch, mods, jpipe, jb, train)
            recon = pmods.recon_train if train else pmods.recon_val
            got = sup.rollout_form(recon, pb, pipe, train=train)
            assert got == want, (wire, pin, train)
            seen.add(got)
    assert seen == {"s4d"}
    # a bottom crop of 6 rows is 2-aligned, not 4-aligned
    jpipe, pipe = dsec_pipelines(None, crop=6)
    want = jax_branch(monkeypatch, mods, jpipe, jb, False)
    assert sup.rollout_form(pmods.recon_val, pb, pipe,
                            train=False) == want == "standard"


# --- the steps and streaming --------------------------------------------

STEPS = 2


def test_quad_train_step_matches_jax_and_the_standard_rollout():
    """Two train steps with JAX's flips: the port's quad model (s4d build)
    against JAX's quad train step, loss and the head's update, and against
    the port's standard rollout."""
    cfg = slice_config(None)
    cols = folded_batch(np.random.default_rng(11))
    jpipe, pipe = dsec_pipelines(None, crop=0)
    flips = [jax_flips(cfg, jpipe, s) for s in range(STEPS)]
    mods = jax_quad_modules(cfg)
    # JAX initializes the quad model at a size its interpret-mode cell
    # cannot tile; the parameters are the standard model's
    state = jax_init_state(jax_build(cfg), jax.random.PRNGKey(0))
    pmods = port_quad_modules(cfg, state)
    pstd = port_quad_modules(cfg, state, quad=False)
    jstep = jax_sup.make_train_step(mods, jpipe)
    want = []
    for _ in range(STEPS):
        state, out = jstep(state, jax_batch(cols))
        want.append(float(out["loss"]))
    _, want_head = params_from_jax(jax.device_get(state.e2vid_params),
                                   jax.device_get(state.back_params))
    batch = torch_batch(cols)
    augs = [AugmentParams(flip=torch.from_numpy(f.copy())) for f in flips]
    assert sup.rollout_form(pmods.recon_train, batch, pipe,
                            train=True) == "s4d"
    runs = []
    for m in (pmods, pstd):
        st = init_state(m)
        step = sup.make_train_step(m, pipe)
        runs.append([float(step(st, batch, augs[s])["loss"])
                     for s in range(STEPS)])
    np.testing.assert_allclose(runs[0], want, rtol=1e-4)
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)
    for k, v in pmods.head.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_head[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_quad_eval_and_streaming_match_the_standard_rollout():
    """The eval step on s4d windows and two streamed windows (a carried
    s2d level-0 state, reset by ``is_first``) equal the standard model's
    within TOL."""
    cfg = slice_config(None)
    state = jax_init_state(jax_build(cfg), jax.random.PRNGKey(0))
    pmods = port_quad_modules(cfg, state)
    pstd = port_quad_modules(cfg, state, quad=False)
    _, pipe = dsec_pipelines(None, crop=0, flip=False)
    batch = torch_batch(folded_batch(np.random.default_rng(12)))
    outs = [sup.make_eval_step(m, pipe)(batch) for m in (pmods, pstd)]
    for k in ("loss", "latent8", "img_fake"):
        np.testing.assert_allclose(outs[0][k].numpy(), outs[1][k].numpy(),
                                   **TOL, err_msg=k)
    states, cms = [], []
    for m in (pmods, pstd):
        encode, score = port_streaming.make_streaming_steps(m, pipe)
        st = m.recon_val.init_state(B, "cpu")
        for t in range(T):
            win = {k: v[:, t] for k, v in batch.items() if k != "label"}
            win["is_first"] = torch.tensor([t == 0, False])
            if t < T - 1:
                st = encode(st, win)
            else:
                win["label"] = batch["label"]
                st, cm = score(st, win)
        states.append(st)
        cms.append(cm)
    assert states[0][0][0].shape == (B, 4 * 2 * BASE, H // 4, W // 4)
    np.testing.assert_allclose(depth_to_space(states[0][0][1]).numpy(),
                               states[1][0][1].numpy(), **TOL)
    for lvl in (1, 2):
        np.testing.assert_allclose(states[0][lvl][1].numpy(),
                                   states[1][lvl][1].numpy(), **TOL)
    assert abs(int((cms[0] - cms[1]).abs().sum())) <= 4
