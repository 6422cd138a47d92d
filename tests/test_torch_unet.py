"""The port's UNet family against the JAX package's, f32, on carried weights.

``TransposedConvLayer`` (flax's ``ConvTranspose(padding='SAME')``: the
port evaluates it as a cropped ``conv_transpose2d`` of the flipped kernel)
and ``activation_fn``; ``UNet``, ``UNetDecoder`` and ``UNetTaskDecoder``
for ``norm`` None and ``'IN'``, ``skip_type`` sum and concat and both
decoders (bilinear-upsample conv and transposed conv);
``RecurrentUNet(use_upsample_conv=False, final_activation=...)`` over
three carried windows; and the plain segmentation head's
``input_index_map``. Weights are made by flax's ``init`` from a seed and
carried by ``io/convert.py`` (``unet_from_jax``, ``unet_decoder_from_jax``,
``unet_task_decoder_from_jax``, ``params_from_jax``, ``seghead_from_jax``).
Both sides compute the same f32 function with sums in other orders; the
bound is TOL = 1e-4 absolute (``test_torch_models.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.models import e2vid as je2vid
from ess_tpu.models import layers as jlayers
from ess_tpu.models.seghead import SegmentationHead as JaxHead

from ess_tpu_torch import models
from ess_tpu_torch.io import convert
from ess_tpu_torch.models import layers


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


TOL = 1e-4
BASE = 8
H, W = 32, 48
VARIANTS = [(norm, skip, up) for norm in (None, "IN")
            for skip in ("sum", "concat") for up in (True, False)]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 1)))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(),
                               np.moveaxis(np.asarray(want), -1, 1),
                               rtol=0, atol=TOL)


def rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("norm", [None, "IN"])
@pytest.mark.parametrize("hw", [(7, 9), (16, 24)])
def test_transposed_conv_layer_matches_jax(norm, hw):
    """Output 2H x 2W equal to flax's SAME transposed conv; the weight is
    flax's kernel transposed to (in, out, kh, kw), unflipped."""
    x = rand(1, (2, *hw, 6))
    jl = jlayers.TransposedConvLayer(4, norm=norm)
    p = jl.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = jl.apply({"params": p}, jnp.asarray(x))
    port = layers.TransposedConvLayer(6, 4, norm=norm, device="cpu")
    sd = convert._decoder(to_np(p), "m")
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    got = port(nchw(x))
    assert tuple(got.shape) == (2, 4, 2 * hw[0], 2 * hw[1])
    close(got, want)
    np.testing.assert_array_equal(
        port.transposed_conv2d.weight.detach().numpy(),
        np.asarray(p["ConvTranspose_0"]["kernel"]).transpose(2, 3, 0, 1))


def test_transposed_conv_layer_refuses_batch_norm():
    with pytest.raises(ValueError):
        layers.TransposedConvLayer(6, 4, norm="BN", device="cpu")


@pytest.mark.parametrize("name", ["relu", "sigmoid", "tanh", None])
def test_activation_fn_matches_jax(name):
    x = rand(3, (64,)) * 3
    got = layers.activation_fn(name)(torch.from_numpy(x))
    want = jlayers.activation_fn(name)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(KeyError):
        layers.activation_fn("gelu")


@pytest.mark.parametrize("norm,skip,up", VARIANTS)
def test_unet_matches_jax(norm, skip, up):
    x = rand(4, (2, H, W, 5))
    jm = je2vid.UNet(base_channels=BASE, skip_type=skip, norm=norm,
                     use_upsample_conv=up)
    p = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    want = jm.apply({"params": p}, jnp.asarray(x))
    port = models.UNet(base_channels=BASE, skip_type=skip, norm=norm,
                       use_upsample_conv=up, device="cpu")
    port.load_state_dict(convert.unet_from_jax(to_np(p)))
    got = port(nchw(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, H, W)
    close(got, want)


def latent_dict(seed, b=2):
    """A {1, 2, 4, 8} latent of E2VID's widths at base BASE."""
    return {s: rand(seed + s, (b, H // s, W // s, BASE * s))
            for s in (1, 2, 4, 8)}


@pytest.mark.parametrize("norm,skip,up", VARIANTS)
def test_unet_decoder_matches_jax(norm, skip, up):
    lat = latent_dict(6)
    jlat = {k: jnp.asarray(v) for k, v in lat.items()}
    jm = je2vid.UNetDecoder(base_channels=BASE, skip_type=skip, norm=norm,
                            use_upsample_conv=up, final_activation="tanh")
    p = jm.init(jax.random.PRNGKey(7), jlat)["params"]
    want = jm.apply({"params": p}, jlat)
    port = models.UNetDecoder(base_channels=BASE, skip_type=skip, norm=norm,
                              use_upsample_conv=up, final_activation="tanh",
                              device="cpu")
    port.load_state_dict(convert.unet_decoder_from_jax(to_np(p)))
    close(port({k: nchw(v) for k, v in lat.items()}), want)


@pytest.mark.parametrize("norm,skip,up", VARIANTS)
def test_unet_task_decoder_matches_jax(norm, skip, up):
    """{8: latent[8], 4, 2: features, 1: logits}, the real latent[1]
    merged at full scale."""
    lat = latent_dict(8)
    jlat = {k: jnp.asarray(v) for k, v in lat.items()}
    jm = je2vid.UNetTaskDecoder(num_classes=3, base_channels=BASE,
                                skip_type=skip, norm=norm,
                                use_upsample_conv=up)
    p = jm.init(jax.random.PRNGKey(9), jlat)["params"]
    want = jm.apply({"params": p}, jlat)
    port = models.UNetTaskDecoder(3, base_channels=BASE, skip_type=skip,
                                  norm=norm, use_upsample_conv=up,
                                  device="cpu")
    port.load_state_dict(convert.unet_task_decoder_from_jax(to_np(p)))
    got = port({k: nchw(v) for k, v in lat.items()})
    assert sorted(got) == sorted(want) == [1, 2, 4, 8]
    assert tuple(got[1].shape) == (2, 3, H, W)
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("up,act", [(False, "tanh"), (False, None),
                                    (True, "relu")])
def test_recurrent_unet_decoder_options_match_jax(up, act):
    """``use_upsample_conv`` and ``final_activation`` over three carried
    windows, images and states; JAX's defaults are the port's."""
    import inspect
    sig = inspect.signature(models.RecurrentUNet).parameters
    assert (sig["use_upsample_conv"].default, sig["final_activation"].default
            ) == (je2vid.RecurrentUNet.use_upsample_conv,
                  je2vid.RecurrentUNet.final_activation)
    jm = je2vid.RecurrentUNet(base_channels=BASE, lstm_impl="xla",
                              use_upsample_conv=up, final_activation=act)
    jst = je2vid.zero_recurrent_state(2, H, W, base_channels=BASE)
    xs = rand(10, (3, 2, H, W, 5))
    p = jm.init(jax.random.PRNGKey(11), jnp.asarray(xs[0]), jst)["params"]
    head = JaxHead(num_classes=2, input_features=8 * BASE)
    hp = head.init(jax.random.PRNGKey(12), {
        s: jnp.zeros((1, 16 // s, 16 // s, BASE * s)) for s in (1, 2, 4, 8)}
    )["params"]
    sd, _ = convert.params_from_jax(to_np(p), to_np(hp))
    port = models.RecurrentUNet(base_channels=BASE, lstm_impl="xla",
                                use_upsample_conv=up, final_activation=act,
                                device="cpu")
    port.load_state_dict(sd)
    st = models.zero_recurrent_state(2, H, W, base_channels=BASE,
                                     device="cpu")
    for x in xs:
        want, jst, _ = jm.apply({"params": p}, jnp.asarray(x), jst)
        got, st, _ = port(nchw(x), st)
        close(got, want)
    for (hp_, cp_), (hj, cj) in zip(st, jst):
        close(hp_, hj)
        close(cp_, cj)


def test_plain_head_input_index_map_matches_jax():
    """The plain head with ``input_index_map``: latent[8] plus its row and
    column index channels before ``res_0`` (C + 2 channels); the
    skip-connect head ignores the option, as JAX's does."""
    c = 8 * BASE
    lat = {8: rand(13, (2, 4, 6, c))}
    jlat = {k: jnp.asarray(v) for k, v in lat.items()}
    jh = JaxHead(num_classes=3, input_features=c, skip_connect=False,
                 input_index_map=True)
    p = jh.init(jax.random.PRNGKey(14), jlat)["params"]
    want = jh.apply({"params": p}, jlat)
    port = models.SegmentationHead(3, c, skip_connect=False,
                                   input_index_map=True, device="cpu")
    port.load_state_dict(convert.seghead_from_jax(to_np(p)))
    assert port.decoder_scale_1[0].model[0].in_channels == c + 2
    got = port({8: nchw(lat[8])})
    for k in (4, 2, 1):
        close(got[k], want[k])
    assert not models.SegmentationHead(
        3, c, input_index_map=True, device="cpu").input_index_map
