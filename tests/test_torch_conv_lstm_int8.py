"""The int8 ConvLSTM cell of the port (CPU: its plain version) against JAX,
and the ``lstm_impl`` / ``lstm_impl_train`` cell selection.

Bounds:
- weight quantization vs ``quantize_gate_weights``: ``wq`` identical, ``ws``
  rtol 1e-6 (same f32 ops in the same order; the bound allows one ulp);
- plain int8 cell vs the Pallas int8 cell in interpret mode
  (``impl='pallas_int8_interpret'``): atol 1e-5 (identical integer
  accumulators, f32 epilogue and pointwise in other orders);
- plain int8 cell vs the port's exact cell: the JAX package's own bounds
  for its int8 cell (tests/test_conv_lstm_pallas.py): max |dh| < 0.05,
  mean |dh| < 6e-3, max |dc| < 0.08, 20-step drift of h < 0.06.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops.conv_lstm_pallas import conv_lstm_cell as jax_cell
from ess_tpu.ops.conv_lstm_pallas import quantize_gate_weights as jax_quant

from ess_tpu_torch.core.config import (Config, DatasetConfig,
                                       EventDatasetConfig, ModelConfig)
from ess_tpu_torch.ops.conv_lstm import (
    conv_lstm_cell, conv_lstm_int8_ref, conv_lstm_ref, gate_column_order,
    input_scale, quantize_gate_weights, resolve_lstm_impl)
from ess_tpu_torch.train.builder import build_modules, init_params


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


def make(b, h, w, cx, ch, seed=0, x_scale=1.0, relu=False, w_scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cx)) * x_scale
    if relu:
        x = np.maximum(x, 0.0)
    hp = np.tanh(rng.normal(size=(b, h, w, ch)))
    cp = rng.normal(size=(b, h, w, ch))
    kern = rng.normal(size=(3, 3, cx + ch, 4 * ch)) * w_scale
    bias = rng.normal(size=(4 * ch,)) * 0.05
    return tuple(a.astype(np.float32) for a in (x, hp, cp, kern, bias))


def to_torch(x, hp, cp, kern, bias):
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    return (nchw(x), nchw(hp), nchw(cp),
            torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous(),
            torch.from_numpy(bias))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cx,ch", [(8, 8), (32, 64), (64, 32)])
def test_quantize_gate_weights_matches_jax(cx, ch):
    x, _, _, kern, _ = make(2, 6, 7, cx, ch, seed=cx + ch)
    s_x = input_scale(torch.from_numpy(x))
    s_x_j = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-8) / 127.0
    assert float(s_x) == float(s_x_j)
    wq_j, ws_j = jax_quant(jnp.asarray(kern), s_x_j, cx, ch)
    w = torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous()
    wq, ws = quantize_gate_weights(w, s_x, cx)
    assert wq.dtype == torch.int8 and wq.shape == (4 * ch, 9 * (cx + ch))
    order = gate_column_order(ch).numpy()
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j).T[order])
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_j), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("shape", [(2, 12, 20, 16, 16), (1, 10, 11, 8, 24)])
def test_int8_cell_matches_jax_interpret(shape):
    args = make(*shape, seed=1, x_scale=2.0, relu=True,
                w_scale=(18 * shape[4]) ** -0.5)
    h, c = conv_lstm_int8_ref(*to_torch(*args))
    hj, cj = jax_cell(*map(jnp.asarray, args), impl="pallas_int8_interpret")
    np.testing.assert_allclose(nhwc(h), np.asarray(hj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(nhwc(c), np.asarray(cj), atol=1e-5, rtol=0)
    # the dispatcher runs the same plain cell on CPU tensors when asked for
    # the int8 math at every shape (these cells are below the JAX package's
    # size rule, where its own 'pallas_int8' is the exact cell)
    h2, c2 = conv_lstm_cell(*to_torch(*args), impl="pallas_int8_interpret")
    assert torch.equal(h2, h) and torch.equal(c2, c)


def test_int8_cell_error_bound_vs_exact():
    b, h, w, c = 2, 12, 20, 16
    args = to_torch(*make(b, h, w, c, c, seed=11, x_scale=2.0, relu=True,
                          w_scale=(18 * c) ** -0.5))
    h_ref, c_ref = conv_lstm_ref(*args)
    h_q, c_q = conv_lstm_int8_ref(*args)
    dh = (h_q - h_ref).abs()
    dc = (c_q - c_ref).abs()
    assert dh.max() < 0.05, dh.max()
    assert dh.mean() < 6e-3, dh.mean()
    assert dc.max() < 0.08, dc.max()


def test_int8_20_step_rollout_drift():
    b, h, w, c = 1, 10, 16, 8
    rng = np.random.default_rng(13)
    xs = torch.from_numpy(np.maximum(
        rng.normal(size=(20, b, c, h, w)) * 1.5, 0).astype(np.float32))
    kern = torch.from_numpy((rng.normal(size=(4 * c, 2 * c, 3, 3))
                             * (18 * c) ** -0.5).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(4 * c,)) * 0.05)
                            .astype(np.float32))
    hr = cr = hq = cq = torch.zeros(b, c, h, w)
    for t in range(20):
        hr, cr = conv_lstm_ref(xs[t], hr, cr, kern, bias)
        hq, cq = conv_lstm_int8_ref(xs[t], hq, cq, kern, bias)
    assert (hq - hr).abs().max() < 0.06


def test_int8_cell_backward_is_the_exact_cells():
    """As the JAX ``custom_vjp``: for the same cotangents, gradients through
    the int8 cell are those of the exact cell at the same inputs (f32,
    atol 1e-6)."""
    args = to_torch(*make(1, 6, 7, 8, 8, seed=4))
    g = torch.Generator().manual_seed(5)
    ct_h, ct_c = (torch.randn(1, 8, 6, 7, generator=g) for _ in range(2))

    def grads(fn):
        ins = [a.clone().requires_grad_(True) for a in args]
        hn, cn = fn(*ins)
        ((hn * ct_h).sum() + (cn * ct_c).sum()).backward()
        return [i.grad for i in ins]

    g_q = grads(lambda *a: conv_lstm_cell(*a, impl="pallas_int8_interpret"))
    g_r = grads(conv_lstm_ref)
    for a, b in zip(g_q, g_r):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_resolve_lstm_impl():
    assert resolve_lstm_impl("auto") == "pallas"
    for name in ("xla", "pallas", "pallas_int8"):
        assert resolve_lstm_impl(name) == name
    for bad in ("pallas_interpret", "int8", ""):
        with pytest.raises(ValueError):
            resolve_lstm_impl(bad)
    with pytest.raises(ValueError):
        conv_lstm_cell(*to_torch(*make(1, 4, 4, 8, 8)), impl="auto")


def small_cfg(**model_kw):
    return Config(
        dataset=DatasetConfig(sensor_b=EventDatasetConfig(
            name="DSEC_events", shape=(16, 32), nr_events_data=2)),
        model=ModelConfig(model_name="ess_supervised",
                          e2vid_base_channels=8, compute_dtype="float32",
                          **model_kw),
        task=dataclasses.replace(Config().task, semseg_num_classes=4))


def encoder0_latent(mods, recon, x):
    with torch.no_grad():
        _, _, latent = recon.rollout(x[None], decode=False)
    return latent[2]


@pytest.mark.parametrize("lstm_impl,lstm_impl_train,val_cell,train_cell", [
    ("auto", None, "exact", "exact"),
    ("pallas", "pallas_int8", "exact", "int8"),
    ("xla", "pallas_int8", "exact", "int8"),
    ("pallas_int8", None, "int8", "int8"),
    ("pallas_int8", "xla", "int8", "exact"),
])
def test_lstm_impl_selects_the_cell(lstm_impl, lstm_impl_train, val_cell,
                                    train_cell):
    """``model.lstm_impl`` picks the eval rollout's ConvLSTM cell and
    ``model.lstm_impl_train`` the train rollout's, over one parameter set:
    on CPU ``'pallas_int8'`` gives the plain int8 cell's result and
    ``'xla'``, ``'pallas'`` and ``'auto'`` the exact cell's (checked on the
    first encoder's state after one window from zero state). The cells here
    are below the JAX package's int8 size rule, so the config asks for the
    int8 math at every shape (``'pallas_int8_interpret'``) where the case
    names ``'pallas_int8'``."""
    every_shape = {"pallas_int8": "pallas_int8_interpret"}
    mods = build_modules(small_cfg(
        lstm_impl=every_shape.get(lstm_impl, lstm_impl),
        lstm_impl_train=every_shape.get(lstm_impl_train, lstm_impl_train)),
        device="cpu")
    init_params(mods, torch.Generator().manual_seed(0))
    assert mods.recon_train.model is mods.recon_val.model is mods.e2vid
    x = torch.relu(torch.randn(2, 5, 16, 32,
                               generator=torch.Generator().manual_seed(1)))
    enc = mods.e2vid.encoders[0]
    gates = enc.recurrent_block.Gates
    with torch.no_grad():
        feat = enc.conv(mods.e2vid.head(x))
        zero = torch.zeros(2, 16, 8, 16)
        want = {
            "exact": conv_lstm_ref(feat, zero, zero, gates.weight,
                                   gates.bias)[0],
            "int8": conv_lstm_int8_ref(feat, zero, zero, gates.weight,
                                       gates.bias)[0]}
    assert (want["exact"] - want["int8"]).abs().max() > 1e-3
    for recon, cell in ((mods.recon_val, val_cell),
                        (mods.recon_train, train_cell)):
        torch.testing.assert_close(encoder0_latent(mods, recon, x),
                                   want[cell], atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        build_modules(small_cfg(lstm_impl="pallas_interpret"), device="cpu")
