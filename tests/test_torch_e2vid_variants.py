"""The E2VID and head options of the YAML against the JAX package, f32.

``e2vid_recurrent_block: 'convgru'`` (``ConvGRUCell``, ``RecurrentConvLayer``),
``e2vid_norm: 'IN'`` (instance norm in ``ConvLayer``, ``ResidualBlock``,
``UpsampleConvLayer`` and the prediction layer) and ``skip_connect_task:
False`` (the plain segmentation head), each on seeded numpy inputs with the
JAX weights carried across by ``params_from_jax``: the layers alone, and
``RecurrentUNet`` rolled out by both packages' ``Reconstructor`` over 4
carried windows (images, final states, latent). ``Reconstructor`` runs in
block space only where the model has no norm, as JAX's ``_use_blocks``.
Both sides compute the same f32 function with sums in other orders: rtol
1e-4, atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.models import RecurrentUNet as JaxUNet
from ess_tpu.models import SegmentationHead as JaxHead
from ess_tpu.models import layers as jax_layers
from ess_tpu.recon import Reconstructor as JaxReconstructor

from ess_tpu_torch.io.convert import conv_state, params_from_jax
from ess_tpu_torch.models import layers
from ess_tpu_torch.models.e2vid import RecurrentUNet, zero_recurrent_state
from ess_tpu_torch.models.seghead import SegmentationHead
from ess_tpu_torch.recon.reconstructor import Reconstructor
from ess_tpu_torch.train.builder import orthogonal_, with_block_conv_impl
from tests.test_torch_loop import one_torch_thread

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

TOL = dict(rtol=1e-4, atol=1e-5)
BASE, BINS, B, T, H, W = 8, 5, 2, 4, 24, 32


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_conv_gru_cell_matches_jax():
    """Five carried steps of the GRU cell from a nonzero state."""
    rng = np.random.default_rng(0)
    cell = jax_layers.ConvGRUCell(hidden=6)
    x = [normal(rng, (B, 10, 12, 4)) for _ in range(5)]
    h0 = normal(rng, (B, 10, 12, 6), 0.5)
    params = cell.init(jax.random.PRNGKey(1), x[0], h0)["params"]
    port = layers.ConvGRUCell(4, 6, device="cpu")
    sd = {}
    for gate in ("reset_gate", "update_gate", "out_gate"):
        sd.update(conv_state(to_np(params[gate]), gate))
    port.load_state_dict(sd)
    hj, hp = jnp.asarray(h0), torch.from_numpy(nchw(h0))
    for xi in x:
        out_j, hj = cell.apply({"params": params}, jnp.asarray(xi), hj)
        out_p, hp = port(torch.from_numpy(nchw(xi)), hp)
        assert out_p is hp
        np.testing.assert_allclose(hp.detach().numpy(), nchw(hj), **TOL)


@pytest.mark.parametrize("stride,kernel", [(2, 5), (1, 5), (1, 1)])
def test_conv_layer_instance_norm_matches_jax(stride, kernel):
    """conv -> instance norm -> ReLU (sigmoid for the 1x1 prediction)."""
    rng = np.random.default_rng(stride * 10 + kernel)
    act = "sigmoid" if kernel == 1 else "relu"
    jl = jax_layers.ConvLayer(7, kernel, stride, activation=act, norm="IN")
    x = normal(rng, (B, 12, 16, 3))
    params = jl.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    port = layers.ConvLayer(3, 7, kernel, stride, act, norm="IN",
                            device="cpu")
    port.load_state_dict(conv_state(to_np(params["Conv_0"]), "conv2d"))
    got = port(torch.from_numpy(nchw(x)))
    want = jl.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), nchw(want), **TOL)
    assert port._block is None      # a norm has no block form
    with pytest.raises(ValueError, match="norm-free"):
        port(torch.zeros(B, 12, 6, 8), block_space=True)


def test_residual_and_upsample_layers_instance_norm_match_jax():
    rng = np.random.default_rng(3)
    x = normal(rng, (B, 6, 8, 8))
    jr = jax_layers.ResidualBlock(8, norm="IN")
    pr = jr.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    port_r = layers.ResidualBlock(8, norm="IN", device="cpu")
    port_r.load_state_dict({**conv_state(to_np(pr["Conv_0"]), "conv1"),
                            **conv_state(to_np(pr["Conv_1"]), "conv2")})
    np.testing.assert_allclose(
        port_r(torch.from_numpy(nchw(x))).detach().numpy(),
        nchw(jr.apply({"params": pr}, jnp.asarray(x))), **TOL)
    ju = jax_layers.UpsampleConvLayer(4, norm="IN")
    pu = ju.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    port_u = layers.UpsampleConvLayer(8, 4, norm="IN", device="cpu")
    port_u.load_state_dict(conv_state(to_np(pu["Conv_0"]), "conv2d"))
    np.testing.assert_allclose(
        port_u(torch.from_numpy(nchw(x))).detach().numpy(),
        nchw(ju.apply({"params": pu}, jnp.asarray(x))), **TOL)


def test_norms_outside_in_raise():
    """``'BN'`` raises (the JAX package cannot roll it out:
    ``test_torch_option_steps.py``), as does an unknown norm or cell."""
    for norm in ("BN", "GN"):
        with pytest.raises(ValueError, match="e2vid_norm"):
            RecurrentUNet(base_channels=BASE, norm=norm, device="cpu")
    with pytest.raises(ValueError, match="recurrent block"):
        RecurrentUNet(base_channels=BASE, recurrent_block="lstm",
                      device="cpu")


VARIANTS = {"convgru": dict(recurrent_block="convgru"),
            "IN": dict(norm="IN"),
            "convgru_IN": dict(recurrent_block="convgru", norm="IN"),
            "IN_concat": dict(norm="IN", skip_type="concat")}


def models(kw, seed):
    """(JAX model, its params, the port's model with the same weights)."""
    jmodel = JaxUNet(base_channels=BASE, num_encoders=3, lstm_impl="xla",
                     **kw)
    st = JaxReconstructor(model=jmodel, height=16, width=16).init_state(1)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 16, 16, BINS)), st)["params"]
    head = JaxHead(num_classes=2, input_features=8 * BASE)
    latent = {s: jnp.zeros((1, 16 // s, 16 // s, BASE * s if s > 1 else BASE))
              for s in (1, 2, 4, 8)}
    sd, _ = params_from_jax(
        to_np(params), to_np(head.init(jax.random.PRNGKey(0),
                                       latent)["params"]))
    port = RecurrentUNet(base_channels=BASE, lstm_impl="xla", device="cpu",
                         **kw)
    port.load_state_dict(sd)
    return jmodel, params, port


def close_state(st_p, st_j):
    flat_p = [t for s in st_p for t in (s if isinstance(s, tuple) else (s,))]
    flat_j = jax.tree_util.tree_leaves(st_j)
    assert len(flat_p) == len(flat_j)
    for p, j in zip(flat_p, flat_j):
        np.testing.assert_allclose(p.numpy(), nchw(j), **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rollout_matches_jax(variant):
    """``Reconstructor.rollout`` over 4 carried windows: block space where
    JAX takes it (no norm), the standard layout with a norm; the image,
    the final state (one tensor a level for a GRU) and the latent. Every
    cell's input is channels-last, as the CUDA cells require."""
    kw = VARIANTS[variant]
    jmodel, params, port = models(kw, seed=len(variant))
    jrec = JaxReconstructor(model=jmodel, height=H, width=W, normalize=False)
    rec = Reconstructor(model=port, height=H, width=W, normalize=False)
    assert rec.use_blocks == jrec._use_blocks == ("norm" not in kw)
    rng = np.random.default_rng(7)
    x = normal(rng, (T, B, H, W, BINS))
    x *= rng.random(x.shape) < 0.3
    img_j, st_j, lat_j = jrec.rollout(params, jnp.asarray(x),
                                      time_major=True)
    # the CUDA cell kernels take channels-last operands only
    layouts = []
    for enc in port.encoders:
        enc.recurrent_block.register_forward_pre_hook(
            lambda mod, args: layouts.append(args[0].is_contiguous(
                memory_format=torch.channels_last)))
    with torch.no_grad():
        img_p, st_p, lat_p = rec.rollout(torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(x, -1, 2))))
    assert len(layouts) == 3 * T and all(layouts)
    np.testing.assert_allclose(img_p.numpy(), nchw(img_j), **TOL)
    close_state(st_p, st_j)
    for s in (1, 2, 4, 8):
        np.testing.assert_allclose(lat_p[s].numpy(), nchw(lat_j[s]), **TOL)


def test_gru_state_and_block_space_rule():
    """A GRU level carries one tensor, zero and channels-last; a model
    with a norm stays in the standard layout under ``with_block_conv_impl``
    too (the fused conv kernel is never reached), and refuses windows in
    space-to-depth blocks."""
    st = zero_recurrent_state(2, 16, 24, base_channels=BASE,
                              recurrent_block="convgru", device="cpu")
    assert [tuple(s.shape) for s in st] == [(2, 16, 8, 12), (2, 32, 4, 6),
                                            (2, 64, 2, 3)]
    assert all(s.is_contiguous(memory_format=torch.channels_last)
               and not s.any() for s in st)
    port = RecurrentUNet(base_channels=BASE, norm="IN", device="cpu")
    rec = Reconstructor(model=port, height=16, width=16, normalize=False)
    assert rec.block_space and not rec.use_blocks
    mods = dataclasses.make_dataclass("Mods", ["recon_train", "recon_val"])
    swapped = with_block_conv_impl(mods(rec, rec), "pallas")
    assert swapped.recon_val.block_space
    assert not swapped.recon_val.use_blocks
    with pytest.raises(ValueError, match="block-space"):
        rec.step(torch.zeros(1, 20, 8, 8), rec.init_state(1, "cpu"),
                 events_s2d=True)


@pytest.mark.parametrize("skip_connect", [False, True])
def test_plain_head_matches_jax(skip_connect):
    """The plain head (``skip_connect=False``: three residual blocks, then
    three nearest-2x + conv stages and the 1x1 logits, reading latent[8]
    alone) and, for contrast, the skip-connect one with 'sum' skips; every
    scale of the output dict."""
    rng = np.random.default_rng(11)
    tch = 8 * BASE
    latent = {s: normal(rng, (B, 32 // s, 40 // s,
                              BASE * s if s > 1 else BASE))
              for s in (1, 2, 4, 8)}
    jhead = JaxHead(num_classes=3, input_features=tch,
                    skip_connect=skip_connect, skip_type="sum")
    params = jhead.init(jax.random.PRNGKey(9),
                        {k: jnp.asarray(v) for k, v in latent.items()}
                        )["params"]
    port = SegmentationHead(3, tch, skip_connect=skip_connect,
                            skip_type="sum", device="cpu")
    _, e2vid_params, _ = models({}, 0)
    _, sd = params_from_jax(to_np(e2vid_params), to_np(params))
    port.load_state_dict(sd)
    want = jhead.apply({"params": params},
                       {k: jnp.asarray(v) for k, v in latent.items()})
    with torch.no_grad():
        got = port({k: torch.from_numpy(nchw(v)) for k, v in latent.items()})
    assert sorted(got) == sorted(want) == [1, 2, 4, 8]
    for s in (1, 2, 4):
        np.testing.assert_allclose(got[s].numpy(), nchw(want[s]), **TOL)


def test_orthogonal_init_matches_flax_layout():
    """``orthogonal_`` gives the kernel flattened to (kh kw C_in, C_out)
    orthonormal columns, as flax's ``orthogonal()`` does for its HWIO
    kernel; a wide kernel gets orthonormal rows."""
    g = torch.Generator().manual_seed(0)
    for shape in ((16, 32, 3, 3), (40, 2, 1, 1)):
        w = torch.empty(shape)
        orthogonal_(w, g)
        flat = w.permute(2, 3, 1, 0).reshape(-1, shape[0]).double()
        gram = (flat.T @ flat if flat.shape[0] >= flat.shape[1]
                else flat @ flat.T)
        np.testing.assert_allclose(gram.numpy(), np.eye(len(gram)),
                                   atol=1e-6)
    ref = jax.nn.initializers.orthogonal()(jax.random.PRNGKey(0),
                                           (3, 3, 32, 16))
    ref = np.asarray(ref).reshape(-1, 16)
    np.testing.assert_allclose(ref.T @ ref, np.eye(16), atol=1e-5)
