"""The port's fused 3x3 conv (CPU: its plain versions) against JAX.

The same numpy-seeded inputs go through
``ess_tpu.ops.conv3x3_pallas.conv3x3_fused`` with the Pallas kernel in
interpret mode and through the port's ``conv3x3_fused`` on CPU tensors, at
the shape of tests/test_conv3x3_pallas.py (24 -> 16 channels, 16x40), a
20-channel one (the head conv's block width) and an odd height.

Bounds:
- f32 inputs, exact conv: atol 1e-5 (same f32 products, other orders);
- bf16 inputs: within one bf16 ulp (both accumulate bf16 products in f32
  and round once);
- int8 conv: quantized weights identical (the count of differing values is
  reported), ``ws`` rtol 1e-6, outputs within 1e-5 of the output's absmax
  (identical integer accumulators, f32 epilogue in other orders);
- int8 against the exact conv: the JAX package's own bounds, max error
  below 0.02 and mean error below 2e-3 of the absmax;
- gradients of weight and bias against ``jax.grad`` of the JAX op:
  atol/rtol 1e-3, for the exact and the int8 conv (both differentiate the
  plain exact conv).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops.conv3x3_pallas import _quantize_weights as jax_quant
from ess_tpu.ops.conv3x3_pallas import conv3x3_fused as jax_fused
from ess_tpu.ops.conv3x3_pallas import conv3x3_ref as jax_ref

from ess_tpu_torch.ops import conv3x3 as c3
from ess_tpu_torch.ops.conv3x3 import (
    conv3x3_fused, conv3x3_int8_ref, conv3x3_ref, prepare_conv_weights,
    quantize_conv_weights, tap_channels)
from ess_tpu_torch.ops.conv_lstm import input_scale


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


SHAPES = {"24to16": (24, 16, 16, 40), "20to32": (20, 32, 8, 24),
          "odd": (24, 16, 13, 40)}


def data(shape, seed=0):
    cin, cout, h, w = SHAPES[shape]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, k, b


def to_torch(x, k, b, dtype=torch.float32):
    return (torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype),
            torch.from_numpy(k).permute(3, 2, 0, 1).contiguous(),
            None if b is None else torch.from_numpy(b))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def bf16_ulp(a, b):
    """One bf16 ulp at max(|a|, |b|)."""
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", ["24to16", "20to32"])
def test_exact_conv_matches_jax_interpret_f32(shape, relu):
    x, k, b = data(shape)
    want = jax_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                     relu=relu, impl="pallas_interpret")
    got = conv3x3_fused(*to_torch(x, k, b), relu=relu, impl="pallas")
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    assert (nhwc(got) >= 0).all() == relu


def test_exact_conv_no_bias_matches_jax_interpret():
    x, k, _ = data("24to16", seed=1)
    want = jax_fused(jnp.asarray(x), jnp.asarray(k), None, relu=True,
                     impl="pallas_interpret")
    got = conv3x3_fused(*to_torch(x, k, None), relu=True, impl="pallas")
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", ["24to16", "20to32"])
def test_exact_conv_matches_jax_interpret_bf16(shape):
    x, k, b = data(shape, seed=2)
    want = np.asarray(jax_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b),
        relu=True, impl="pallas_interpret").astype(jnp.float32))
    got = conv3x3_fused(*to_torch(x, k, b, torch.bfloat16), relu=True,
                        impl="pallas")
    assert got.dtype == torch.bfloat16
    assert (np.abs(nhwc(got) - want) <= bf16_ulp(nhwc(got), want)).all()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_conv_matches_jax_ref(shape):
    """``conv3x3_ref`` against the JAX ``conv3x3_ref``, also at a height no
    row tile of the TPU kernel divides (the port has no such gate)."""
    x, k, b = data(shape, seed=3)
    want = jax_ref(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), relu=False)
    got = conv3x3_ref(*to_torch(x, k, b), relu=False)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    # 'xla' is the plain conv on every device
    assert torch.equal(conv3x3_fused(*to_torch(x, k, b), relu=False,
                                     impl="xla"), got)


@pytest.mark.parametrize("shape", ["24to16", "20to32"])
def test_quantize_conv_weights_matches_jax(shape):
    x, k, _ = data(shape, seed=4)
    cin, cout = k.shape[2:]
    s_x = input_scale(torch.from_numpy(x))
    s_x_j = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-8) / 127.0
    assert float(s_x) == float(s_x_j)
    wq_j, ws_j = jax_quant(jnp.asarray(k).reshape(9 * cin, cout), s_x_j)
    w = to_torch(x, k, None)[1]
    wq, ws = quantize_conv_weights(
        w.permute(0, 2, 3, 1).reshape(cout, 9 * cin), s_x)
    differing = int((wq.numpy() != np.asarray(wq_j).T).sum())
    print(f"{differing} of {wq.numel()} quantized weights differ from JAX")
    assert wq.dtype == torch.int8 and differing == 0
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_j), rtol=1e-6,
                               atol=0)
    # the kernel's padded matrix quantizes to the same values, zeros between
    cp = tap_channels(cin, int8=True)
    wq_p, ws_p = quantize_conv_weights(prepare_conv_weights(w, int8=True),
                                       s_x)
    assert torch.equal(ws_p, ws)
    wq_p = wq_p.view(cout, 9, cp)
    assert torch.equal(wq_p[:, :, :cin].reshape(cout, 9 * cin), wq)
    assert not wq_p[:, :, cin:].any()


@pytest.mark.parametrize("relu,bias", [(True, True), (False, True),
                                       (True, False)])
@pytest.mark.parametrize("shape", ["24to16", "20to32"])
def test_int8_conv_matches_jax_interpret(shape, relu, bias):
    x, k, b = data(shape, seed=5)
    x = np.maximum(x, 0) * 2            # post-ReLU activations, as in E2VID
    b = b if bias else None
    want = np.asarray(jax_fused(
        jnp.asarray(x), jnp.asarray(k), None if b is None else jnp.asarray(b),
        relu=relu, impl="pallas_int8_interpret"))
    args = to_torch(x, k, b)
    got = conv3x3_int8_ref(*args, relu=relu)
    scale = np.abs(want).max()
    assert np.abs(nhwc(got) - want).max() <= 1e-5 * scale
    # the dispatcher runs the same plain conv on CPU tensors when asked for
    # the int8 math at every shape (these shapes are below the JAX package's
    # size rule, where its own 'pallas_int8' is the exact conv)
    assert torch.equal(conv3x3_fused(*args, relu=relu,
                                     impl="pallas_int8_interpret"), got)


def test_int8_conv_error_bound_vs_exact():
    x, k, b = data("24to16", seed=2)
    args = to_torch(x, k, b)
    ref = conv3x3_ref(*args, relu=True)
    err = (conv3x3_int8_ref(*args, relu=True) - ref).abs()
    scale = float(ref.abs().max()) + 1e-9
    assert err.max() / scale < 0.02, err.max() / scale
    assert err.mean() / scale < 2e-3, err.mean() / scale


@pytest.mark.parametrize("impl", ["pallas", "pallas_int8"])
def test_gradients_match_jax(impl):
    x, k, b = data("24to16", seed=3)

    def loss_j(k_, b_):
        return jnp.sum(jax_fused(jnp.asarray(x), k_, b_, relu=True,
                                 impl=impl + "_interpret") ** 2)

    gk_j, gb_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(k),
                                                  jnp.asarray(b))
    xt, wt, bt = to_torch(x, k, b)
    wt.requires_grad_(True)
    bt.requires_grad_(True)
    # the JAX '_interpret' names skip the size rule; so does the port's
    # 'pallas_int8_interpret'
    port_impl = impl if impl == "pallas" else impl + "_interpret"
    out = conv3x3_fused(xt, wt, bt, relu=True, impl=port_impl)
    gk, gb = torch.autograd.grad((out ** 2).sum(), (wt, bt))
    np.testing.assert_allclose(gk.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gk_j), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j), atol=1e-3,
                               rtol=1e-3)


def test_int8_conv_backward_is_the_exact_convs():
    """For the same cotangent, gradients through the int8 conv are those of
    the exact conv at the same inputs, x included and without a bias too
    (f32, atol 1e-6)."""
    x, k, b = data("20to32", seed=6)
    ct = torch.randn(2, 32, 8, 24, generator=torch.Generator().manual_seed(7))
    for bias in (b, None):
        def grads(fn):
            ins = [t.clone().requires_grad_(True)
                   for t in to_torch(x, k, bias) if t is not None]
            out = fn(ins[0], ins[1], ins[2] if len(ins) == 3 else None)
            return torch.autograd.grad((out * ct).sum(), ins)

        g_q = grads(lambda *a: conv3x3_fused(*a, relu=True,
                                             impl="pallas_int8_interpret"))
        g_r = grads(lambda *a: conv3x3_ref(*a, relu=True))
        assert len(g_q) == len(g_r) == (3 if bias is not None else 2)
        for a, r in zip(g_q, g_r):
            torch.testing.assert_close(a, r, atol=1e-6, rtol=1e-6)


def test_impl_names_and_kernel_size():
    x, k, b = data("24to16")
    args = to_torch(x, k, b)
    for bad in ("bogus", "", "int8"):
        with pytest.raises(ValueError):
            jax_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                      impl=bad)
        with pytest.raises(ValueError):
            conv3x3_fused(*args, impl=bad)
    # the port has no interpret mode: a CPU tensor runs the plain version;
    # 'pallas_int8_interpret' is the int8 conv at every shape
    for name in ("pallas_interpret", "auto"):
        with pytest.raises(ValueError):
            conv3x3_fused(*args, impl=name)
    assert c3.IMPLS == ("xla", "pallas", "pallas_int8",
                        "pallas_int8_interpret")
    w5 = torch.zeros(16, 24, 5, 5)
    for impl in c3.IMPLS:
        with pytest.raises(ValueError):
            conv3x3_fused(args[0], w5, args[2], impl=impl)
    with pytest.raises(ValueError):
        prepare_conv_weights(w5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", ["24to16", "20to32"])
def test_prepared_matrix_is_the_convs_tap_matrix(shape, int8):
    """The kernels' operand layout, in Python: the (C_out, 9*CP) prepared
    matrix times the nine shifted, zero-padded copies of x (each padded to
    CP channels) is the conv (f32, atol 1e-4). CP is one 64-byte chunk of
    the operand type."""
    x, k, b = data(shape, seed=8)
    cin, cout = k.shape[2:]
    xt, wt, _ = to_torch(x, k, b)
    cp = tap_channels(cin, int8=int8)
    assert cp == (64 if int8 else 32) and cp >= cin
    prep = prepare_conv_weights(wt, int8=int8)
    assert prep.shape == (cout, 9 * cp) and prep.is_contiguous()
    assert prep.dtype == (torch.float32 if int8 else torch.bfloat16)
    xp = torch.nn.functional.pad(xt, (1, 1, 1, 1, 0, cp - cin))
    h, w = xt.shape[2:]
    taps = [xp[:, :, dy:dy + h, dx:dx + w]
            for dy in range(3) for dx in range(3)]
    a = torch.cat(taps, dim=1)                         # (B, 9*CP, H, W)
    w_mat = wt.to(prep.dtype).float() if not int8 else wt
    got = torch.einsum("bkhw,nk->bnhw", a, prep.float())
    want = torch.nn.functional.conv2d(xt, w_mat, padding=1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
