"""ConvLSTM cell of the port (CPU: the plain version) against JAX.

The port's ``conv_lstm_cell`` on CPU tensors is held against the JAX
``conv_lstm_ref`` and the fused Pallas cell in interpret mode
(``impl='pallas_interpret'``) at the bounds of
tests/test_conv_lstm_pallas.py: f32 atol 1e-5 (same f32 math, other
summation order), bf16 h atol 2e-2 and c atol 3e-2 (one bf16 rounding of
the state each). The gate-weight preparation the CUDA kernel consumes is
checked here by replaying the kernel's im2row GEMM and epilogue indexing
in plain PyTorch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ess_tpu.ops.conv_lstm_pallas import conv_lstm_cell as jax_cell
from ess_tpu.ops.conv_lstm_pallas import conv_lstm_ref as jax_ref

from ess_tpu_torch.ops.conv_lstm import (
    conv_lstm_cell, conv_lstm_ref, gate_column_order, prepare_gate_weights)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


def make(b, h, w, cx, ch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cx)).astype(np.float32)
    hp = np.tanh(rng.normal(size=(b, h, w, ch))).astype(np.float32)
    cp = rng.normal(size=(b, h, w, ch)).astype(np.float32)
    kern = (rng.normal(size=(3, 3, cx + ch, 4 * ch)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * ch,)) * 0.1).astype(np.float32)
    return x, hp, cp, kern, bias


def to_torch(x, hp, cp, kern, bias, dtype=torch.float32):
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).to(dtype)
    return (nchw(x), nchw(hp), nchw(cp),
            torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous(),
            torch.from_numpy(bias))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [
    (2, 20, 18, 8, 8),
    (1, 8, 16, 8, 16),
    (2, 10, 11, 16, 8),
    (1, 15, 27, 8, 8),
])
def test_cell_matches_jax_f32(shape):
    args = make(*shape)
    h, c = conv_lstm_cell(*to_torch(*args))
    for impl in ("xla", "pallas_interpret"):
        hj, cj = (jax_ref(*map(jnp.asarray, args)) if impl == "xla" else
                  jax_cell(*map(jnp.asarray, args), impl=impl))
        np.testing.assert_allclose(nhwc(h), np.asarray(hj), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(nhwc(c), np.asarray(cj), atol=1e-5,
                                   rtol=1e-5)


def test_cell_matches_jax_bf16():
    args = make(2, 12, 20, 8, 8, seed=3)
    x, hp, cp, kern, bias = args
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    hj, cj = jax_cell(bf(x), bf(hp), bf(cp), jnp.asarray(kern),
                      jnp.asarray(bias), impl="pallas_interpret")
    h, c = conv_lstm_cell(*to_torch(*args, dtype=torch.bfloat16))
    assert h.dtype == torch.bfloat16 and c.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(h), np.asarray(hj, np.float32), atol=2e-2)
    np.testing.assert_allclose(nhwc(c), np.asarray(cj, np.float32), atol=3e-2)


def test_prepared_weights_replay_kernel_indexing():
    """The CUDA kernel's GEMM: k = (dy*3 + dx)*CIN + cin over
    concat(x, h) with zero padding, prepared column n holding gate
    (n % 32) // 8 of channel (n // 32) * 8 + n % 8 — replayed with plain
    tensor ops, it must give the reference cell's gates."""
    b, hh, ww, cx, ch = 2, 6, 7, 32, 64
    x, hp, cp, kern, bias = to_torch(*make(b, hh, ww, cx, ch, seed=5))
    wprep = prepare_gate_weights(kern, torch.float32)
    assert wprep.shape == (4 * ch, 9 * (cx + ch))
    xh = torch.cat([x, hp], dim=1)
    pad = F.pad(xh, (1, 1, 1, 1))
    taps = [pad[:, :, dy:dy + hh, dx:dx + ww]
            for dy in range(3) for dx in range(3)]
    a = torch.cat(taps, dim=1).permute(0, 2, 3, 1).reshape(-1, 9 * (cx + ch))
    gates_perm = a @ wprep.T                                  # (M, 4*CH)
    n = torch.arange(4 * ch)
    gate, chan = (n % 32) // 8, (n // 32) * 8 + n % 8
    gates = torch.empty_like(gates_perm)
    gates[:, gate * ch + chan] = gates_perm
    assert torch.equal(gate_column_order(ch), gate * ch + chan)
    want = F.conv2d(xh, kern, None, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(gates.view(b, hh, ww, 4 * ch), want,
                               atol=1e-4, rtol=1e-5)
    h_ref, c_ref = conv_lstm_ref(x, hp, cp, kern, bias)
    gi, gf, go, gg = (gates + bias).view(b, hh, ww, 4, ch).unbind(3)
    c_new = (torch.sigmoid(gf) * cp.permute(0, 2, 3, 1)
             + torch.sigmoid(gi) * torch.tanh(gg))
    h_new = torch.sigmoid(go) * torch.tanh(c_new)
    torch.testing.assert_close(h_new, h_ref.permute(0, 2, 3, 1), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(c_new, c_ref.permute(0, 2, 3, 1), atol=1e-5,
                               rtol=1e-5)
