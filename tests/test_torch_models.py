"""Port models against the JAX models, f32, narrow widths (base 8).

Weights come from the JAX initializers through ``params_from_jax``. Both
sides compute in f32 with the same math; the JAX package evaluates several
convs in space-to-depth form and the bilinear decoder upsample through
``up2x_bilinear_s2d``, so sums run in other orders: atol 1e-4 / rtol 1e-4.
A round trip writes the port's state dicts as reference-format checkpoints
and reads them back through ``ess_tpu/io/convert.py``.

The block-space rollout form (``block_input=True``: the window in 2x2
space-to-depth blocks, head and first-encoder convs as 3x3 block convs) is
held at base 8 on a 32x48 input over three carried windows, the JAX side on
its Pallas conv in interpret mode (``block_conv_impl='pallas_interpret'``)
or on XLA, the port on the plain versions (``'pallas'`` on CPU) or on the
library conv (``'xla'``), under the same bound; it needs no parameter that
the standard form lacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.io.convert import load_e2vid_checkpoint, load_semseg_head_torch
from ess_tpu.models import RecurrentUNet as JaxUNet
from ess_tpu.models import SegmentationHead as JaxHead
from ess_tpu.models import zero_recurrent_state as jax_zero_state
from ess_tpu.ops.conv_s2d import space_to_depth as jax_s2d

from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.models.e2vid import RecurrentUNet, zero_recurrent_state
from ess_tpu_torch.models.seghead import SegmentationHead
from ess_tpu_torch.ops.conv_s2d import space_to_depth


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


B, H, W, BASE = 2, 16, 32, 8
TOL = dict(atol=1e-4, rtol=1e-4)


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def jax_unet():
    model = JaxUNet(base_channels=BASE, num_encoders=3)
    x = jnp.zeros((1, H, W, 5))
    st = jax_zero_state(1, H, W, num_encoders=3, base_channels=BASE)
    return model, model.init(jax.random.PRNGKey(1), x, st)["params"]


def jax_head(classes=6):
    head = JaxHead(num_classes=classes, input_features=8 * BASE)
    latent = {s: jnp.zeros((1, H // s, W // s, BASE * s if s > 1 else BASE))
              for s in (1, 2, 4, 8)}
    return head, head.init(jax.random.PRNGKey(2), latent)["params"]


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_recurrent_unet_matches_jax():
    model, params = jax_unet()
    sd, _ = params_from_jax(to_np(params), to_np(jax_head()[1]))
    port = RecurrentUNet(base_channels=BASE)
    port.load_state_dict(sd)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(2, B, H, W, 5)).astype(np.float32)

    st_j = jax_zero_state(B, H, W, num_encoders=3, base_channels=BASE)
    st_p = zero_recurrent_state(B, H, W, num_encoders=3, base_channels=BASE,
                                device="cpu")
    with torch.no_grad():
        for i, decode in enumerate((False, True)):
            img_j, st_j, lat_j = model.apply({"params": params},
                                             jnp.asarray(xs[i]), st_j,
                                             decode=decode)
            img_p, st_p, lat_p = port(torch.from_numpy(nchw(xs[i])), st_p,
                                      decode=decode)
            assert sorted(lat_p) == sorted(lat_j) == [1, 2, 4, 8]
            for s in lat_j:
                np.testing.assert_allclose(lat_p[s].numpy(), nchw(lat_j[s]),
                                           **TOL)
            for (hj, cj), (hp, cp) in zip(st_j, st_p):
                np.testing.assert_allclose(hp.numpy(), nchw(hj), **TOL)
                np.testing.assert_allclose(cp.numpy(), nchw(cj), **TOL)
            if decode:
                assert img_p.shape == (B, 1, H, W)
                np.testing.assert_allclose(img_p.numpy(), nchw(img_j), **TOL)
            else:
                assert img_p is None and img_j is None


@pytest.mark.parametrize("jax_impl,port_impl", [
    ("pallas_interpret", "pallas"), ("xla", "xla"), ("xla", "pallas")])
def test_recurrent_unet_block_input_matches_jax(jax_impl, port_impl):
    """Three carried windows in block space, decode off, off, on: latents,
    states and the image against JAX within TOL; without decode the port
    builds no full-resolution head activation (no ``latent[1]``)."""
    h, w = 32, 48
    _, params = jax_unet()
    model = JaxUNet(base_channels=BASE, num_encoders=3,
                    block_conv_impl=jax_impl)
    sd, _ = params_from_jax(to_np(params), to_np(jax_head()[1]))
    port = RecurrentUNet(base_channels=BASE, block_conv_impl=port_impl)
    port.load_state_dict(sd)
    assert port.block_conv_impl == port_impl
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(3, B, h, w, 5)).astype(np.float32)

    st_j = jax_zero_state(B, h, w, num_encoders=3, base_channels=BASE)
    st_p = zero_recurrent_state(B, h, w, num_encoders=3, base_channels=BASE,
                                device="cpu")
    with torch.no_grad():
        for i, decode in enumerate((False, False, True)):
            img_j, st_j, lat_j = model.apply(
                {"params": params}, jax_s2d(jnp.asarray(xs[i])), st_j,
                decode=decode, block_input=True)
            x_blk = space_to_depth(torch.from_numpy(nchw(xs[i])))
            assert x_blk.shape == (B, 20, h // 2, w // 2)
            img_p, st_p, lat_p = port(x_blk, st_p, decode=decode,
                                      block_input=True)
            assert sorted(lat_p) == ([1, 2, 4, 8] if decode else [2, 4, 8])
            for s in lat_p:
                np.testing.assert_allclose(lat_p[s].numpy(), nchw(lat_j[s]),
                                           **TOL)
            for (hj, cj), (hp, cp) in zip(st_j, st_p):
                np.testing.assert_allclose(hp.numpy(), nchw(hj), **TOL)
                np.testing.assert_allclose(cp.numpy(), nchw(cj), **TOL)
            if decode:
                assert img_p.shape == (B, 1, h, w)
                np.testing.assert_allclose(img_p.numpy(), nchw(img_j), **TOL)
            else:
                assert img_p is None and img_j is None
    # the per-call override takes the place of JAX's clone(block_conv_impl=)
    with torch.no_grad():
        _, _, lat_o = port(x_blk, st_p, decode=False, block_input=True,
                           block_conv_impl="pallas_int8_interpret")
    assert (lat_o[2] - port(x_blk, st_p, decode=False,
                            block_input=True)[2][2]).abs().max() > 1e-4
    with pytest.raises(ValueError):
        RecurrentUNet(base_channels=BASE, block_conv_impl="pallas_interpret")
    with pytest.raises(ValueError):
        port(x_blk, st_p, block_input=True, block_conv_impl="bogus")


def test_block_space_needs_no_new_parameters():
    """The block-space form remaps the 5x5 weights at apply time: JAX
    initializes the same parameter tree under ``block_input=True`` with the
    conv kernel as it does in the standard form, ``params_from_jax`` maps it
    onto exactly the port's state-dict keys, and running the block form
    adds none."""
    _, params = jax_unet()
    model = JaxUNet(base_channels=BASE, num_encoders=3,
                    block_conv_impl="pallas_interpret")
    st = jax_zero_state(1, H, W, num_encoders=3, base_channels=BASE)
    params_blk = model.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, H // 2, W // 2, 20)), st,
                            block_input=True)["params"]
    flat = dict(jax.tree_util.tree_leaves_with_path(to_np(params)))
    flat_blk = dict(jax.tree_util.tree_leaves_with_path(to_np(params_blk)))
    assert sorted(map(str, flat)) == sorted(map(str, flat_blk))
    for path, leaf in flat.items():
        assert flat_blk[path].shape == leaf.shape
    sd, _ = params_from_jax(to_np(params_blk), to_np(jax_head()[1]))
    port = RecurrentUNet(base_channels=BASE, block_conv_impl="pallas")
    keys = sorted(port.state_dict())
    assert sorted(sd) == keys
    port.load_state_dict(sd)
    st_p = zero_recurrent_state(1, H, W, num_encoders=3, base_channels=BASE,
                                device="cpu")
    with torch.no_grad():
        port(torch.zeros(1, 20, H // 2, W // 2), st_p, block_input=True)
    assert sorted(port.state_dict()) == keys
    assert sd["head.conv2d.weight"].shape == (BASE, 5, 5, 5)


def test_segmentation_head_matches_jax():
    head, params = jax_head()
    _, sd = params_from_jax(to_np(jax_unet()[1]), to_np(params))
    port = SegmentationHead(6, input_features=8 * BASE)
    port.load_state_dict(sd)
    rng = np.random.default_rng(1)
    latent = {s: rng.normal(size=(B, H // s, W // s,
                                  BASE * s if s > 1 else BASE)
                            ).astype(np.float32) for s in (1, 2, 4, 8)}
    out_j = head.apply({"params": params},
                       {s: jnp.asarray(v) for s, v in latent.items()})
    with torch.no_grad():
        out_p = port({s: torch.from_numpy(nchw(v)) for s, v in latent.items()})
    for s in (1, 2, 4):
        np.testing.assert_allclose(out_p[s].numpy(), nchw(out_j[s]), **TOL)
    assert out_p[1].shape == (B, 6, H, W)


def test_state_dicts_round_trip_through_reference_converters(tmp_path):
    """The port's state dicts are reference-format checkpoints: the JAX
    converters read them back to the original pytrees."""
    _, e_params = jax_unet()
    head, h_params = jax_head()
    e_np, h_np = to_np(e_params), to_np(h_params)
    sd_e, sd_h = params_from_jax(e_np, h_np)
    port = RecurrentUNet(base_channels=BASE)
    port.load_state_dict(sd_e)
    port_head = SegmentationHead(6, input_features=8 * BASE)
    port_head.load_state_dict(sd_h)

    path = tmp_path / "e2vid.pth.tar"
    torch.save({"model": {"num_encoders": 3, "num_residual_blocks": 2},
                "state_dict": {f"unetrecurrent.{k}": v
                               for k, v in port.state_dict().items()}},
               str(path))
    back, _ = load_e2vid_checkpoint(str(path))
    hpath = tmp_path / "head.pth"
    torch.save(port_head.state_dict(), str(hpath))
    back_h = load_semseg_head_torch(str(hpath), h_np)

    for want, got in ((e_np, back), (h_np, back_h)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path_, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path_]), leaf)
