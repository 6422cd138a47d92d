"""The reconstruction runtime's per-window options against the JAX
package's, f32.

``Reconstructor``'s ``normalize``, ``flip``, ``standardize`` and
``no_recurrent`` (JAX's defaults: True, False, False, False), through
``step`` (every combination of the first three over carried windows, at a
size that pads and one that does not, block space on and off), ``step``
on space-to-depth windows (``events_s2d``: ``normalize`` on the blocks,
``flip`` refused), and each rollout form -- ``rollout`` (standard and s2d
windows), ``rollout_events``, ``rollout_raw`` and ``rollout_all`` --
with and without ``no_recurrent``, and ``preprocess_event_tensor``. The
model is E2VID at base 8, 3 encoders, the plain ConvLSTM cell on both
sides, weights carried across by ``params_from_jax``; the windows are
seeded sparse grids. Both sides compute the same f32 function with sums in
other orders: images and states within ATOL = 1e-5 absolute, as
``test_torch_reconstruct.py``; the preprocessed tensors within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.models import RecurrentUNet as JaxUNet
from ess_tpu.models import SegmentationHead as JaxHead
from ess_tpu.ops.conv_s2d import space_to_depth as jax_s2d
from ess_tpu.recon import Reconstructor as JaxReconstructor
from ess_tpu.recon import preprocess_event_tensor as jax_preprocess

from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.models.e2vid import RecurrentUNet
from ess_tpu_torch.ops.conv_s2d import space_to_depth
from ess_tpu_torch.recon import Reconstructor, preprocess_event_tensor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


BASE, BINS, B, T = 8, 5, 2, 3
ATOL = 1e-5
OPTIONS = ("normalize", "flip", "standardize")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, -3)))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), -1, -3),
                               rtol=0, atol=atol)


def close_states(st_p, st_j):
    for (hp, cp), (hj, cj) in zip(st_p, st_j):
        close(hp, hj)
        close(cp, cj)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's RecurrentUNet with the same weights)."""
    model = JaxUNet(base_channels=BASE, num_encoders=3, lstm_impl="xla")
    st = JaxReconstructor(model=model, height=16, width=16).init_state(1)
    params = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, BINS)),
                        st)["params"]
    head = JaxHead(num_classes=2, input_features=8 * BASE)
    latent = {s: jnp.zeros((1, 16 // s, 16 // s, BASE * s))
              for s in (1, 2, 4, 8)}
    head_params = head.init(jax.random.PRNGKey(5), latent)["params"]
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    sd, _ = params_from_jax(to_np(params), to_np(head_params))
    port = RecurrentUNet(base_channels=BASE, lstm_impl="xla",
                         block_conv_impl="xla", device="cpu")
    port.load_state_dict(sd)
    port.requires_grad_(False)
    return params, port


def recons(weights, h, w, **opts):
    params, port = weights
    jmodel = JaxUNet(base_channels=BASE, num_encoders=3, lstm_impl="xla")
    return (params, JaxReconstructor(model=jmodel, height=h, width=w, **opts),
            Reconstructor(model=port, height=h, width=w, **opts))


def windows(h, w, seed, t=T, scale=1.0):
    """(B, T, H, W, C) sparse event windows (three quarters zero), not
    normalized: offset and scaled so that ``normalize`` moves them."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, t, h, w, BINS)) * 3 + 1).astype(np.float32)
    return x * (rng.random(x.shape) < 0.25) * np.float32(scale)


def test_defaults_are_jax():
    fields = ("normalize", "flip", "standardize", "no_recurrent",
              "block_space")
    port = {f.name: f.default for f in dataclasses.fields(Reconstructor)}
    jax_ = {f.name: f.default for f in dataclasses.fields(JaxReconstructor)}
    assert {k: port[k] for k in fields} == {k: jax_[k] for k in fields}
    assert {k: port[k] for k in fields[:4]} == {
        "normalize": True, "flip": False, "standardize": False,
        "no_recurrent": False}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("flip", [True, False])
def test_preprocess_event_tensor_matches_jax(normalize, flip):
    x = windows(12, 10, 1)[:, 0]
    x[1] = 0.0                                  # an all-zero sample
    got = preprocess_event_tensor(nchw(x), normalize=normalize, flip=flip)
    want = jax_preprocess(jnp.asarray(x), normalize=normalize, flip=flip)
    close(got, want, 1e-6)


ALL_OPTIONS = [dict(zip(OPTIONS, (a, b, c))) for a in (True, False)
               for b in (True, False) for c in (True, False)]


@pytest.mark.parametrize("opts,hw,block_space", [
    *((o, (26, 35), True) for o in ALL_OPTIONS),
    (ALL_OPTIONS[0], (24, 32), False), (ALL_OPTIONS[-1], (24, 32), False)])
def test_step_options_match_jax(weights, opts, hw, block_space):
    """Every combination of normalize / flip / standardize through ``step``
    over T carried windows at a size that pads, in block space; all on and
    all off in the standard layout at one that does not: images (decoded
    each window) and states."""
    params, jrec, rec = recons(weights, *hw, block_space=block_space, **opts)
    x = windows(*hw, seed=2)
    jst, st = jrec.init_state(B), rec.init_state(B, "cpu")
    for i in range(T):
        jimg, jst, _ = jrec.step(params, jnp.asarray(x[:, i]), jst)
        img, st, _ = rec.step(nchw(x[:, i]), st)
        close(img, jimg)
        if opts["standardize"]:
            assert float(img.amin()) == 0.0
            assert abs(float(img.amax()) - 1.0) < 1e-6
    close_states(st, jst)


def test_step_on_s2d_windows_normalizes_the_blocks(weights):
    """``events_s2d``: ``normalize`` standardizes the blocks (the same
    value set), ``standardize`` scales the image; ``flip`` is refused."""
    hw = (24, 32)
    params, jrec, rec = recons(weights, *hw, standardize=True)
    x = windows(*hw, seed=3)[:, 0]
    jblk = jax_s2d(jnp.asarray(x))
    blk = space_to_depth(nchw(x))
    jimg, jst, _ = jrec.step(params, jblk, jrec.init_state(B),
                             events_s2d=True)
    img, st, _ = rec.step(blk, rec.init_state(B, "cpu"), events_s2d=True)
    close(img, jimg)
    close_states(st, jst)
    _, _, flipped = recons(weights, *hw, flip=True)
    with pytest.raises(ValueError):
        flipped.step(blk, flipped.init_state(B, "cpu"), events_s2d=True)


@pytest.mark.parametrize("no_recurrent", [False, True])
@pytest.mark.parametrize("s2d", [False, True])
def test_rollout_matches_jax(weights, no_recurrent, s2d):
    """``rollout`` with ``no_recurrent``: only the last window, stepped
    from the initial state (JAX skips its scan)."""
    hw = (24, 32) if s2d else (26, 35)
    opts = dict(no_recurrent=no_recurrent, flip=not s2d, standardize=True)
    params, jrec, rec = recons(weights, *hw, **opts)
    x = windows(*hw, seed=4)
    jx, px = jnp.asarray(x), nchw(x)
    if s2d:
        jx = jax.vmap(jax_s2d, in_axes=1, out_axes=1)(jx)
        px = torch.stack([space_to_depth(px[:, i]) for i in range(T)], 1)
    jimg, jst, _ = jrec.rollout(params, jx, windows_s2d=s2d)
    img, st, _ = rec.rollout(px, windows_s2d=s2d, time_major=False)
    close(img, jimg)
    close_states(st, jst)
    if no_recurrent:
        last, st1, _ = rec.step(px[:, -1], rec.init_state(B, "cpu"),
                                events_s2d=s2d)
        assert torch.equal(img, last)


def soa_columns(seed, h, w, n=400):
    """(B, T, N) event columns: integer pixels, times in [0, 1), p in
    {0, 1}; the last tenth of each window invalid."""
    rng = np.random.default_rng(seed)
    cols = {"ev_x": rng.integers(0, w, (B, T, n)).astype(np.float32),
            "ev_y": rng.integers(0, h, (B, T, n)).astype(np.float32),
            "ev_t": rng.random((B, T, n)).astype(np.float32),
            "ev_p": rng.integers(0, 2, (B, T, n)).astype(np.float32)}
    valid = np.ones((B, T, n), bool)
    valid[..., n - n // 10:] = False
    cols["ev_valid"] = valid
    return cols


def count_grid_jax(h, w):
    """A voxel function of JAX's form: signed event counts per (pixel,
    time bin), (B, H, W, C); integer sums, so exact in any order."""
    def fn(x, y, t, p, valid, tile_offsets=None):
        b = jnp.arange(x.shape[0])[:, None]
        bins = jnp.minimum((t * BINS).astype(jnp.int32), BINS - 1)
        val = jnp.where(valid, jnp.where(p > 0, 1.0, -1.0), 0.0)
        g = jnp.zeros((x.shape[0], h, w, BINS), jnp.float32)
        return g.at[b, y.astype(jnp.int32), x.astype(jnp.int32),
                    bins].add(val)
    return fn


def count_grid_port(h, w, calls):
    def fn(x, y, t, p, valid, tile_offsets=None):
        calls.append(1)
        b = torch.arange(x.shape[0])[:, None].expand_as(x)
        bins = torch.clamp((t * BINS).long(), max=BINS - 1)
        val = torch.where(valid, torch.where(p > 0, 1.0, -1.0), 0.0)
        g = torch.zeros(x.shape[0], BINS, h, w)
        return g.index_put_((b, bins, y.long(), x.long()), val,
                            accumulate=True)
    return fn


@pytest.mark.parametrize("no_recurrent", [False, True])
def test_rollout_events_matches_jax(weights, no_recurrent):
    """The in-loop rollout with the options on; with ``no_recurrent`` only
    the last window is voxelized and stepped."""
    hw = (26, 35)
    params, jrec, rec = recons(weights, *hw, no_recurrent=no_recurrent,
                               flip=True, standardize=True)
    cols = soa_columns(5, *hw)
    calls = []
    jimg, jst, _ = jrec.rollout_events(
        params, {k: jnp.asarray(v) for k, v in cols.items()},
        count_grid_jax(*hw))
    img, st, _ = rec.rollout_events(
        {k: torch.from_numpy(v) for k, v in cols.items()},
        count_grid_port(*hw, calls))
    close(img, jimg)
    close_states(st, jst)
    assert len(calls) == (1 if no_recurrent else T)


@pytest.mark.parametrize("no_recurrent", [False, True])
def test_rollout_raw_matches_jax(weights, no_recurrent):
    """``rollout_raw`` with a window map that scales each (T, B) raw block
    by its stats: ``normalize`` then standardizes the blocks."""
    hw = (24, 32)
    params, jrec, rec = recons(weights, *hw, no_recurrent=no_recurrent,
                               standardize=True)
    x = windows(*hw, seed=6)
    raw = np.stack([np.asarray(jax_s2d(jnp.asarray(x[:, i])))
                    for i in range(T)])                  # (T, B, h, w, 4C)
    stats = np.random.default_rng(7).uniform(0.5, 2, (T, B, 3)).astype(
        np.float32)
    jimg, jst, _ = jrec.rollout_raw(
        params, jnp.asarray(raw), jnp.asarray(stats),
        lambda r, s: r * s[:, :1, None, None])
    img, st, _ = rec.rollout_raw(
        nchw(raw), torch.from_numpy(stats),
        lambda r, s: r * s[:, :1, None, None])
    close(img, jimg)
    close_states(st, jst)


@pytest.mark.parametrize("no_recurrent", [False, True])
def test_rollout_all_matches_jax(weights, no_recurrent):
    """Every window decoded: (T, B, 1, Hp, Wp) images and the final state
    (the initial one with ``no_recurrent``); batch-major and time-major
    windows agree."""
    hw = (26, 35)
    params, jrec, rec = recons(weights, *hw, no_recurrent=no_recurrent,
                               flip=True, standardize=True)
    x = windows(*hw, seed=8)
    jimgs, jst = jrec.rollout_all(params, jnp.asarray(x))
    imgs, st = rec.rollout_all(nchw(x), time_major=False)
    g = rec.geometry
    assert tuple(imgs.shape) == (T, B, 1, g.padded_height, g.padded_width)
    close(imgs, jimgs)
    close_states(st, jst)
    imgs_tm, _ = rec.rollout_all(nchw(x).transpose(0, 1))
    assert torch.equal(imgs_tm, imgs)
    if no_recurrent:
        assert not any(t.any() for pair in st for t in pair)
        for i in range(T):
            one, _, _ = rec.step(nchw(x[:, i]), rec.init_state(B, "cpu"))
            assert torch.equal(imgs[i], one)
