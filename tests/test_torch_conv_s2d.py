"""The port's space-to-depth helpers against ``ess_tpu.ops.conv_s2d``.

``space_to_depth``, ``depth_to_space``, ``block_kernel`` and ``block_bias``
are reshuffles and gathers: exact against the JAX functions on the same
numpy-seeded inputs (the port is NCHW with OIHW weights, JAX NHWC with
HWIO). The identity "block conv == 5x5 conv" holds in f32 within 1e-5
(the two convs sum the same products in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ess_tpu.ops import conv_s2d as jax_s2d

from ess_tpu_torch.ops.conv_s2d import (
    block_bias, block_kernel, depth_to_space, space_to_depth)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


def nchw(a):
    return torch.from_numpy(np.moveaxis(np.asarray(a), -1, 1).copy())


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 8, 12, 5), (1, 6, 4, 32), (3, 2, 2, 1)])
def test_space_to_depth_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = space_to_depth(nchw(x))
    np.testing.assert_array_equal(nhwc(got),
                                  np.asarray(jax_s2d.space_to_depth(
                                      jnp.asarray(x))))
    assert got.is_contiguous(memory_format=torch.channels_last)
    # not pixel_unshuffle's channel order (unless there is one channel)
    if shape[-1] > 1:
        assert not torch.equal(got, F.pixel_unshuffle(nchw(x), 2))
    # a channels-last input gives the same blocks
    cl = nchw(x).contiguous(memory_format=torch.channels_last)
    assert torch.equal(space_to_depth(cl), got)


@pytest.mark.parametrize("shape", [(2, 4, 6, 20), (1, 3, 2, 128), (2, 1, 1, 4)])
def test_depth_to_space_matches_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = depth_to_space(nchw(x))
    np.testing.assert_array_equal(nhwc(got),
                                  np.asarray(jax_s2d.depth_to_space(
                                      jnp.asarray(x))))
    assert torch.equal(space_to_depth(got), nchw(x))


def test_s2d_rejects_odd_sizes():
    with pytest.raises(ValueError):
        space_to_depth(torch.zeros(1, 2, 3, 4))
    with pytest.raises(ValueError):
        depth_to_space(torch.zeros(1, 6, 2, 2))


@pytest.mark.parametrize("bo,stride", [(2, 1), (1, 2)])
@pytest.mark.parametrize("cin,cout", [(5, 8), (32, 16)])
def test_block_kernel_matches_jax(bo, stride, cin, cout):
    k = np.random.default_rng(2).normal(size=(5, 5, cin, cout)).astype(
        np.float32)
    want = np.asarray(jax_s2d.block_kernel(jnp.asarray(k), bi=2, bo=bo,
                                           stride=stride))
    w = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    got = block_kernel(w, bi=2, bo=bo, stride=stride)
    assert got.shape == (bo * bo * cout, 4 * cin, 3, 3)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
    if stride == 1:
        np.testing.assert_array_equal(want, np.asarray(
            jax_s2d.s2d_kernel(jnp.asarray(k))))
    else:
        np.testing.assert_array_equal(want, np.asarray(
            jax_s2d.s2d_kernel_stride2(jnp.asarray(k))))


def test_block_kernel_rejects_what_jax_rejects():
    w = torch.zeros(4, 3, 5, 5)
    with pytest.raises(ValueError):
        block_kernel(w, bi=2, bo=2, stride=2)          # stride*bo != bi
    with pytest.raises(ValueError):
        block_kernel(w, bi=4, bo=1, stride=4)          # even block kernel
    with pytest.raises(ValueError):
        block_kernel(torch.zeros(4, 3, 4, 4), bi=2, bo=2)
    with pytest.raises(AssertionError):
        jax_s2d.block_kernel(jnp.zeros((5, 5, 3, 4)), bi=4, bo=1, stride=4)


@pytest.mark.parametrize("bo", [1, 2])
def test_block_bias_matches_jax(bo):
    b = np.random.default_rng(3).normal(size=(7,)).astype(np.float32)
    np.testing.assert_array_equal(
        block_bias(torch.from_numpy(b), bo).numpy(),
        np.asarray(jax_s2d.block_bias(jnp.asarray(b), bo)))


@pytest.mark.parametrize("stride", [1, 2])
def test_block_conv_equals_5x5_conv(stride):
    """A 3x3 SAME conv over the s2d input with the remapped weights is the
    5x5 conv: stride 1 in 2x2 output blocks, stride 2 unblocked at half
    resolution; f32, atol 1e-5."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 16, 24, generator=g)
    w = torch.randn(8, 5, 5, 5, generator=g) * 0.2
    b = torch.randn(8, generator=g)
    want = F.conv2d(x, w, b, stride=stride, padding=2)
    bo = 2 // stride
    out = F.conv2d(space_to_depth(x),
                   block_kernel(w, bi=2, bo=bo, stride=stride),
                   block_bias(b, bo), padding=1)
    got = depth_to_space(out) if stride == 1 else out
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_block_kernel_passes_gradients():
    """The remap is a gather: the gradient of the block conv with respect to
    the 5x5 weight equals the 5x5 conv's (f32, atol 1e-5)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 3, 8, 8, generator=g)
    ct = torch.randn(1, 4, 8, 8, generator=g)
    w = (torch.randn(4, 3, 5, 5, generator=g) * 0.2).requires_grad_(True)
    (g_ref,) = torch.autograd.grad(
        (F.conv2d(x, w, padding=2) * ct).sum(), w)
    out = depth_to_space(F.conv2d(space_to_depth(x),
                                  block_kernel(w, bi=2, bo=2), padding=1))
    (g_blk,) = torch.autograd.grad((out * ct).sum(), w)
    torch.testing.assert_close(g_blk, g_ref, atol=1e-5, rtol=0)
