"""The JAX package's size rule for its int8 cell and block conv, in the port.

JAX's ``conv_lstm_cell`` and ``conv3x3_fused`` with ``impl='pallas_int8'``
run the int8 kernel only where the op is a 3x3 conv, its input has at least
4M elements and ``pick_row_tile`` finds a row tile of its height; elsewhere
they compute the exact function. The port's ``conv_lstm.int8_size_rule`` is
that rule, and ``int8_route`` sends ``'pallas_int8'`` to the exact cell
(conv) where it does not hold.

- The predicate equals JAX's dispatch, traced with ``jax.make_jaxpr`` on
  abstract shapes (a ``pallas_call`` in the trace or not), at the DSEC and
  DDD17 shapes of the cells and block convs, and at a height with no row
  tile; ``'pallas_int8_interpret'`` skips the size half of the rule only,
  as JAX's trace of that name does.
- Below the rule a port rollout on ``'pallas_int8'`` (cells and block
  convs) matches JAX's ``'pallas_int8'``, which is exact there, within the
  exact models' bound (atol 1e-4 / rtol 1e-4, tests/test_torch_models.py),
  is bit for bit the port's exact rollout and differs from the int8 math
  (``'pallas_int8_interpret'``).
- The weights are prepared for the cell and the conv a shape runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.models import RecurrentUNet as JaxUNet
from ess_tpu.models import zero_recurrent_state as jax_zero_state
from ess_tpu.ops.conv3x3_pallas import conv3x3_fused as jax_conv
from ess_tpu.ops.conv_lstm_pallas import conv_lstm_cell as jax_cell
from ess_tpu.ops.conv_s2d import space_to_depth as jax_s2d

from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.models import layers
from ess_tpu_torch.models.e2vid import RecurrentUNet, zero_recurrent_state
from ess_tpu_torch.ops import conv_lstm as cl
from ess_tpu_torch.ops.conv_s2d import space_to_depth
from tests.test_torch_models import BASE, TOL, jax_head, nchw, to_np


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


# (name, NHWC input shape, the cell's hidden or the block conv's output
# channels, whether JAX's 'pallas_int8' runs its int8 kernel there)
CELLS = [
    ("dsec_b8_level0", (8, 220, 320, 64), 64, True),
    ("dsec_b8_level1", (8, 110, 160, 128), 128, True),
    ("dsec_b8_level2", (8, 55, 80, 256), 256, True),
    ("dsec_b2_level2", (2, 55, 80, 256), 256, False),
    ("ddd17_crop_b16_level0", (16, 60, 108, 64), 64, True),
    ("ddd17_crop_b16_level1", (16, 30, 54, 128), 128, False),
    ("ddd17_crop_b16_level2", (16, 15, 27, 256), 256, False),
    ("ddd17_b16_level0", (16, 100, 176, 64), 64, True),
    ("ddd17_b16_level1", (16, 50, 88, 128), 128, True),
    ("ddd17_b16_level2", (16, 25, 44, 256), 256, True),
    ("no_row_tile", (4, 29, 1000, 64), 64, False),   # 29 is prime
]
CONVS = [
    ("ddd17_crop_b16_head_block", (16, 60, 108, 20), 128, False),
    ("ddd17_crop_b16_encoder0_block", (16, 60, 108, 128), 64, True),
    ("dsec_b8_head_block", (8, 220, 320, 20), 128, True),
    ("dsec_b2_head_block", (2, 220, 320, 20), 128, False),
    ("no_row_tile_block", (8, 29, 1000, 20), 128, False),
]


def sds(*shape, dtype=jnp.bfloat16):
    return jax.ShapeDtypeStruct(shape, dtype)


def jax_runs_int8(kind: str, shape, ch, impl: str = "pallas_int8") -> bool:
    """Whether JAX's dispatch of ``impl`` reaches its kernel at ``shape``
    (traced only: no value is computed)."""
    b, h, w, c = shape
    if kind == "cell":
        fn = lambda x, hh, cc, k, bb: jax_cell(x, hh, cc, k, bb, impl=impl)
        args = (sds(b, h, w, c), sds(b, h, w, ch), sds(b, h, w, ch),
                sds(3, 3, c + ch, 4 * ch, dtype=jnp.float32),
                sds(4 * ch, dtype=jnp.float32))
    else:
        fn = lambda x, k, bb: jax_conv(x, k, bb, impl=impl)
        args = (sds(b, h, w, c), sds(3, 3, c, ch, dtype=jnp.float32),
                sds(ch, dtype=jnp.float32))
    return "pallas_call" in str(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize(
    "kind,what,shape,ch,want",
    [("cell",) + c for c in CELLS] + [("conv",) + c for c in CONVS],
    ids=[c[0] for c in CELLS] + [c[0] for c in CONVS])
def test_rule_is_jax_dispatch(kind, what, shape, ch, want):
    b, h, w, c = shape
    nchw_shape = (b, c, h, w)
    assert jax_runs_int8(kind, shape, ch) == want
    assert cl.int8_size_rule(nchw_shape) == want
    assert cl.int8_route("pallas_int8", nchw_shape) == (
        "pallas_int8" if want else "pallas")
    # the '_interpret' name skips the size half of the rule only: int8
    # wherever the height has a row tile, as JAX's trace of the same name
    interp = jax_runs_int8(kind, shape, ch, impl="pallas_int8_interpret")
    assert interp == (cl.pick_row_tile(h) is not None)
    assert cl.int8_route("pallas_int8_interpret", nchw_shape) == (
        "pallas_int8" if interp else "pallas")
    for name in ("pallas", "xla"):
        assert cl.int8_route(name, nchw_shape) == name


def test_rollout_below_the_rule_is_jax_exact_result():
    """Three carried block-space windows at base 8, 32x48 (every cell and
    block conv far below 4M elements), cells and block convs on
    'pallas_int8' in both packages."""
    h, w = 32, 48
    model = JaxUNet(base_channels=BASE, num_encoders=3,
                    lstm_impl="pallas_int8", block_conv_impl="pallas_int8")
    params = model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, h // 2, w // 2, 20)),
        jax_zero_state(1, h, w, num_encoders=3, base_channels=BASE),
        block_input=True)["params"]
    sd, _ = params_from_jax(to_np(params), to_np(jax_head()[1]))
    ports = {}
    for impl in ("pallas_int8", "pallas", "pallas_int8_interpret"):
        ports[impl] = RecurrentUNet(base_channels=BASE, lstm_impl=impl,
                                    block_conv_impl=impl)
        ports[impl].load_state_dict(sd)
    rng = np.random.default_rng(3)
    xs = np.maximum(rng.normal(size=(3, 2, h, w, 5)), 0).astype(np.float32)
    st_j = jax_zero_state(2, h, w, num_encoders=3, base_channels=BASE)
    st = {k: zero_recurrent_state(2, h, w, num_encoders=3,
                                  base_channels=BASE, device="cpu")
          for k in ports}
    with torch.no_grad():
        for i in range(3):
            decode = i == 2
            img_j, st_j, lat_j = model.apply(
                {"params": params}, jax_s2d(jnp.asarray(xs[i])), st_j,
                decode=decode, block_input=True)
            x_blk = space_to_depth(torch.from_numpy(nchw(xs[i])))
            out = {k: m(x_blk, st[k], decode=decode, block_input=True)
                   for k, m in ports.items()}
            st = {k: o[1] for k, o in out.items()}
            img, _, lat = out["pallas_int8"]
            for s in (2, 4, 8):
                np.testing.assert_allclose(lat[s].numpy(), nchw(lat_j[s]),
                                           **TOL)
                assert torch.equal(lat[s], out["pallas"][2][s])
            for (hj, cj), (hp, cp) in zip(st_j, st["pallas_int8"]):
                np.testing.assert_allclose(hp.numpy(), nchw(hj), **TOL)
                np.testing.assert_allclose(cp.numpy(), nchw(cj), **TOL)
        np.testing.assert_allclose(img.numpy(), nchw(img_j), **TOL)
    q = out["pallas_int8_interpret"][2][8]
    assert (q - out["pallas"][2][8]).abs().max() > 1e-4


@pytest.mark.parametrize("impl,hw,want", [
    ("pallas_int8", (250, 256), "pallas_int8"),   # 4.1M elements
    ("pallas_int8", (60, 108), "pallas"),
    ("pallas_int8_interpret", (60, 108), "pallas_int8"),
    ("pallas_int8_interpret", (29, 100), "pallas"),   # no row tile of 29
    ("pallas", (250, 256), "pallas"),
])
def test_weights_are_prepared_for_the_routed_op(monkeypatch, impl, hw, want):
    """A cell and a block conv hand their op the name they were given and
    prepare the weights for the op the input's shape runs (the int8
    matrix only where the int8 kernel runs)."""
    seen = {}

    def cell(x, h, c, wgt, b, *, impl, prepared):
        seen["cell"] = (impl, prepared)
        return h, c

    def conv(x, wgt, b, *, relu, impl, prepared):
        seen["conv"] = (impl, prepared)
        return x

    monkeypatch.setattr(layers, "conv_lstm_cell", cell)
    monkeypatch.setattr(layers, "conv3x3_fused", conv)
    monkeypatch.setattr(layers.ConvLSTMCell, "_prepared_weight",
                        lambda self, name: f"weights for {name}")
    monkeypatch.setattr(layers.BlockConv, "_frozen_weights",
                        lambda self, name, dtype: (None, None,
                                                   f"weights for {name}"))
    x = torch.zeros(1, 64, *hw)
    zero = torch.zeros(1, 64, *hw)
    with torch.no_grad():
        layers.ConvLSTMCell(64, 64)(x, (zero, zero), impl)
        layers.ConvLayer(16, 64, 5, 2)(x, True, impl)
    for op in ("cell", "conv"):
        assert seen[op] == (impl, f"weights for {want}"), op
