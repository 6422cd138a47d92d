"""The port's reconstruction runtime against the JAX package's, f32.

``reflect_pad`` and ``crop_output`` equal JAX's exactly. ``Reconstructor``
(base 8, 3 encoders, the plain ConvLSTM cell on both sides, weights carried
across by ``params_from_jax``) is held against JAX's on the same seeded
windows at 26x35 (pads both sides), 24x35 (pads the width) and 24x32 (no
pad) and 31x24 (pads the height), in block space and in the standard
layout, on windows that arrive normalized (JAX's ``normalize=False``, as
its training pipeline and reconstruction program build it): ``step`` over 6
carried windows (images and states) and ``rollout``. Both sides
compute the same f32 function with sums in other orders (JAX evaluates
several convs in space-to-depth form); the bound is 1e-5 absolute on
images and states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.models import RecurrentUNet as JaxUNet
from ess_tpu.models import SegmentationHead as JaxHead
from ess_tpu.ops import pad as jax_pad
from ess_tpu.recon import Reconstructor as JaxReconstructor

from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.models.e2vid import RecurrentUNet
from ess_tpu_torch.ops import pad
from ess_tpu_torch.ops.conv_s2d import space_to_depth
from ess_tpu_torch.recon.reconstructor import Reconstructor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


BASE, BINS, B, T = 8, 5, 2, 6
ATOL = 1e-5
SIZES = [(26, 35), (24, 35), (24, 32)]


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def nhwc(a):
    return np.moveaxis(np.asarray(a), 1, -1)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's RecurrentUNet with the same weights)."""
    model = JaxUNet(base_channels=BASE, num_encoders=3, lstm_impl="xla")
    st = JaxReconstructor(model=model, height=16, width=16).init_state(1)
    params = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, BINS)),
                        st)["params"]
    head = JaxHead(num_classes=2, input_features=8 * BASE)
    latent = {s: jnp.zeros((1, 16 // s, 16 // s, BASE * s if s > 1 else BASE))
              for s in (1, 2, 4, 8)}
    head_params = head.init(jax.random.PRNGKey(5), latent)["params"]
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    sd, _ = params_from_jax(to_np(params), to_np(head_params))
    port = RecurrentUNet(base_channels=BASE, lstm_impl="xla",
                         block_conv_impl="xla", device="cpu")
    port.load_state_dict(sd)
    return params, port


def recons(weights, h, w, block_space=True):
    params, port = weights
    jmodel = JaxUNet(base_channels=BASE, num_encoders=3, lstm_impl="xla")
    return (params, JaxReconstructor(model=jmodel, height=h, width=w,
                                     normalize=False,
                                     block_space=block_space),
            Reconstructor(model=port, height=h, width=w, normalize=False,
                          block_space=block_space))


def windows(h, w, seed, t=T):
    """(T, B, H, W, C) sparse event windows (three quarters zero)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, B, h, w, BINS)).astype(np.float32)
    return x * (rng.random(x.shape) < 0.25)


def close_states(st_p, st_j):
    for (hp, cp), (hj, cj) in zip(st_p, st_j):
        np.testing.assert_allclose(hp.numpy(), nchw(hj), rtol=0, atol=ATOL)
        np.testing.assert_allclose(cp.numpy(), nchw(cj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw", SIZES + [(38, 50), (260, 346), (7, 9)])
def test_reflect_pad_and_crop_match_jax(hw):
    """Pads and crops equal JAX's exactly, round trip included; 260x346
    (DAVIS346) pads 2 + 2 rows and 3 + 3 columns to 264x352."""
    h, w = hw
    g = pad.CropGeometry(h, w, 3)
    jg = jax_pad.CropGeometry(h, w, 3)
    assert g.pads == jg.pads
    assert (g.padded_height, g.padded_width) == (jg.padded_height,
                                                 jg.padded_width)
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(
        np.float32)
    padded = pad.reflect_pad(torch.from_numpy(nchw(x)), g)
    want = jax_pad.reflect_pad(jnp.asarray(x), jg)
    np.testing.assert_array_equal(padded.numpy(), nchw(want))
    np.testing.assert_array_equal(
        pad.crop_output(padded, g).numpy(),
        nchw(jax_pad.crop_output(want, jg)))
    np.testing.assert_array_equal(pad.crop_output(padded, g).numpy(),
                                  nchw(x))
    if hw == (260, 346):
        assert g.pads == (2, 2, 3, 3)


STEP_SIZES = SIZES + [(31, 24)]


@pytest.mark.parametrize("block_space", [True, False],
                         ids=["block", "std"])
@pytest.mark.parametrize("hw", STEP_SIZES,
                         ids=[f"{h}x{w}" for h, w in STEP_SIZES])
def test_step_matches_jax(weights, hw, block_space):
    """Six carried windows through ``step``: the padded image (decoded on
    windows 2 and 5 only) and every state within ATOL of JAX's; the
    cropped image equals JAX's image cropped by JAX's ``crop_output``."""
    h, w = hw
    params, jrec, prec = recons(weights, h, w, block_space)
    assert prec.geometry.pads == jrec.geometry.pads
    xs = windows(h, w, seed=h * w + block_space)
    st_j = jrec.init_state(B)
    st_p = prec.init_state(B, "cpu")
    with torch.no_grad():
        for i in range(T):
            decode = i in (2, 5)
            img_j, st_j, _ = jrec.step(params, jnp.asarray(xs[i]), st_j,
                                       decode=decode)
            img_p, st_p, _ = prec.step(torch.from_numpy(nchw(xs[i])), st_p,
                                       decode=decode)
            close_states(st_p, st_j)
            if not decode:
                assert img_p is None and img_j is None
                continue
            g = prec.geometry
            assert img_p.shape == (B, 1, g.padded_height, g.padded_width)
            np.testing.assert_allclose(img_p.numpy(), nchw(img_j), rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(
                pad.crop_output(img_p, g).numpy(),
                nchw(jax_pad.crop_output(img_j, jrec.geometry)),
                rtol=0, atol=ATOL)


@pytest.mark.parametrize("block_space", [True, False],
                         ids=["block", "std"])
@pytest.mark.parametrize("hw", [(26, 35), (24, 32)],
                         ids=["26x35", "24x32"])
def test_rollout_matches_jax(weights, hw, block_space):
    """``rollout``: encoder-only windows, then the decoded last one."""
    h, w = hw
    params, jrec, prec = recons(weights, h, w, block_space)
    xs = windows(h, w, seed=11)
    img_j, st_j, _ = jrec.rollout(params, jnp.asarray(np.moveaxis(xs, 0, 1)))
    with torch.no_grad():
        img_p, st_p, _ = prec.rollout(torch.from_numpy(
            np.moveaxis(xs, -1, 2).copy()))
    np.testing.assert_allclose(img_p.numpy(), nchw(img_j), rtol=0, atol=ATOL)
    close_states(st_p, st_j)


def test_events_s2d_matches_jax_and_refuses_a_pad(weights):
    """Pre-built space-to-depth windows give JAX's result where no pad is needed, and are refused where one is."""
    params, jrec, prec = recons(weights, 24, 32)
    xs = windows(24, 32, seed=13, t=2)
    st_j, st_p = jrec.init_state(B), prec.init_state(B, "cpu")
    with torch.no_grad():
        for i in range(2):
            blk = space_to_depth(torch.from_numpy(nchw(xs[i])))
            img_j, st_j, _ = jrec.step(params, jnp.asarray(nhwc(blk.numpy())),
                                       st_j, events_s2d=True)
            img_p, st_p, _ = prec.step(blk, st_p, events_s2d=True)
    np.testing.assert_allclose(img_p.numpy(), nchw(img_j), rtol=0, atol=ATOL)
    close_states(st_p, st_j)
    _, _, padded = recons(weights, 26, 35)
    with pytest.raises(ValueError, match="pads"):
        padded.step(torch.zeros(B, 4 * BINS, 13, 17),
                    padded.init_state(B, "cpu"), events_s2d=True)
