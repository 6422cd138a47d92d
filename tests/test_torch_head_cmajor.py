"""T1, the C-major head conv with its normalize fused, against JAX.

The JAX tool ``tools/bench_head.py`` builds its kernel ``kern`` inside
``main()``, so it cannot be imported: :func:`jax_kern` below is a
transcription of its lines 65-151 (the kernel body and its
``pl.pallas_call``), run with ``interpret=True`` on the CPU as the JAX
package's own tests run its kernels. The port's plain version
``head_cmajor_ref`` (what ``head_cmajor`` runs on CPU tensors) is held
against it in both output layouts, and against JAX ``conv5x5_s2d_blocks``
in f32 on the normalized NHWC input, plus the tiled bias and a ReLU, on a
small window (B=1, 20 channels of 24x32, C_out 128) with zeros at its
edges and random zeros inside.

Bounds: bf16 outputs at most one bf16 ulp apart on at least 99.9 % of the
values and max |d| within 2^-7 of the reference's absmax (both accumulate
the same bf16 products in f32 in another order and round once; a sum next
to a rounding boundary lands one step further), the bound of the fused 3x3
conv's tests. The weights are carried from JAX's HWIO to the port's OIHW
by the converter the model weights use (``io.convert.conv_state``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ess_tpu.ops.conv_lstm_pallas import pick_row_tile
from ess_tpu.ops.conv_s2d import conv5x5_s2d_blocks as jax_blocks
from ess_tpu.ops.conv_s2d import s2d_kernel as jax_s2d_kernel

from ess_tpu_torch.io.convert import conv_state
from ess_tpu_torch.ops import head_cmajor as hc
from ess_tpu_torch.ops.conv_s2d import (
    block_bias, block_kernel, conv5x5_s2d_blocks, s2d_kernel)
from ess_tpu_torch.tools import bench_head


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


SHIFT, SCALE = 0.1, 1.5
ULP_SHARE = 0.999
MAX_REL = 2.0 ** -7


def jax_kern(x_nchw, k5, bias, shift, scale, nchw_out):
    """``tools/bench_head.py`` lines 65-151 with the shapes taken from the
    inputs: the Pallas kernel on a (B, C, HH, WW) bf16 C-major window."""
    B, C, HH, WW = x_nchw.shape
    COUT = 4 * k5.shape[-1]
    w2 = jax_s2d_kernel(k5).astype(jnp.bfloat16)
    wflat = w2.reshape(9 * C, COUT)
    b4 = jnp.tile(bias, 4).astype(jnp.float32)
    th = pick_row_tile(HH)
    NT = HH // th

    def kern(x_blk, w_ref, b_ref, out_ref, F):
        it = pl.program_id(1)
        r0 = it * th

        def norm(v):
            vf = v.astype(jnp.float32)
            return jnp.where(vf != 0, (vf - shift) * scale,
                             0.0).astype(jnp.bfloat16)

        zrow = jnp.zeros((1, WW), jnp.bfloat16)
        for cin in range(C):
            top = jnp.where(it == 0, zrow,
                            norm(x_blk[0, cin, pl.ds(r0 - 1 + (it == 0), 1)]))
            mid = norm(x_blk[0, cin, pl.ds(r0, th)])
            bot = jnp.where(it == NT - 1, zrow,
                            norm(x_blk[0, cin,
                                       pl.ds(r0 + th - (it == NT - 1), 1)]))
            plane = jnp.concatenate([top, mid, bot], axis=0)
            for dy in range(3):
                rows = plane[dy:dy + th]
                for dx in range(3):
                    kidx = (dy * 3 + dx) * C + cin
                    if dx == 0:
                        F[kidx, :, 0:1] = jnp.zeros((th, 1), F.dtype)
                        F[kidx, :, 1:WW] = rows[:, 0:WW - 1]
                    elif dx == 1:
                        F[kidx] = rows
                    else:
                        F[kidx, :, 0:WW - 1] = rows[:, 1:WW]
                        F[kidx, :, WW - 1:WW] = jnp.zeros((th, 1), F.dtype)
        if nchw_out:
            acc = jax.lax.dot_general(
                w_ref[:], F[:].reshape(9 * C, th * WW),
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            out = jnp.maximum(acc + b_ref[:, 0:1], 0.0)
            out_ref[0] = out.reshape(COUT, th, WW).astype(out_ref.dtype)
        else:
            acc = jax.lax.dot_general(
                F[:].reshape(9 * C, th * WW), w_ref[:],
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            out = jnp.maximum(acc + b_ref[0], 0.0)
            out_ref[0] = out.reshape(th, WW, COUT).astype(out_ref.dtype)

    if nchw_out:
        out_spec = pl.BlockSpec((1, COUT, th, WW),
                                lambda b, it: (b, 0, it, 0),
                                memory_space=pltpu.VMEM)
        out_shape = jax.ShapeDtypeStruct((B, COUT, HH, WW), jnp.bfloat16)
        b_in = jnp.broadcast_to(b4[:, None], (COUT, 128)).copy()
        b_spec = pl.BlockSpec((COUT, 128), lambda b, it: (0, 0),
                              memory_space=pltpu.VMEM)
    else:
        out_spec = pl.BlockSpec((1, th, WW, COUT),
                                lambda b, it: (b, it, 0, 0),
                                memory_space=pltpu.VMEM)
        out_shape = jax.ShapeDtypeStruct((B, HH, WW, COUT), jnp.bfloat16)
        b_in = jnp.broadcast_to(b4[None, :], (8, COUT)).copy()
        b_spec = pl.BlockSpec((8, COUT), lambda b, it: (0, 0),
                              memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kern,
        grid=(B, NT),
        in_specs=[
            pl.BlockSpec((1, C, HH, WW), lambda b, it: (b, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((9 * C, COUT), lambda b, it: (0, 0),
                         memory_space=pltpu.VMEM),
            b_spec,
        ],
        out_specs=out_spec,
        out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((9 * C, th, WW), jnp.bfloat16)],
        interpret=True,
    )(x_nchw, wflat, b_in)


def inputs(seed, b=1, c=20, hh=24, ww=32, cout4=32):
    """A C-major bf16 window with a zero border and about half its values
    zero, a HWIO 5x5 kernel (5 bins -> cout4) and its bias, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, hh, ww)).astype(np.float32)
    x[np.abs(x) < 0.5] = 0.0
    x[:, :, [0, -1], :] = 0.0
    x[:, :, :, [0, -1]] = 0.0
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    k5 = (rng.standard_normal((5, 5, c // 4, cout4)) / np.sqrt(125)
          ).astype(np.float32)
    bias = (rng.standard_normal(cout4) * 0.1).astype(np.float32)
    return x, k5, bias


def port_weights(k5, bias):
    """HWIO numpy -> the port's block-space (C_out, C_in, 3, 3) weight and
    tiled bias, through the model weights' converter."""
    sd = conv_state({"kernel": k5, "bias": bias}, "head")
    return s2d_kernel(sd["head.weight"]), block_bias(sd["head.bias"], 2)


def assert_bf16_close(got, want):
    """At most one bf16 ulp on ULP_SHARE of the values, max |d| within
    MAX_REL of the reference's absmax."""
    got = torch.as_tensor(np.array(got, np.float32))
    want = torch.as_tensor(np.array(want, np.float32))
    assert got.shape == want.shape
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 8)
    d = (got - want).abs()
    assert (d <= ulp).float().mean().item() >= ULP_SHARE
    assert d.max().item() <= MAX_REL * want.abs().max().item()


@pytest.mark.parametrize("nchw_out", [False, True])
def test_plain_version_matches_jax_kernel(nchw_out):
    x, k5, bias = inputs(0)
    want = jax_kern(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k5),
                    jnp.asarray(bias), SHIFT, SCALE, nchw_out)
    w2, b4 = port_weights(k5, bias)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = hc.head_cmajor(xt, w2, b4, shift=SHIFT, scale=SCALE,
                         nchw_out=nchw_out)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert tuple(got.shape) == tuple(want.shape)
    assert_bf16_close(got.float(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("nchw_out", [False, True])
def test_plain_version_matches_jax_block_conv(nchw_out):
    """``conv5x5_s2d_blocks`` in f32 on the normalized NHWC window and the
    bf16-rounded kernel, plus the tiled bias (inside it) and a ReLU, rounded
    to bf16: the function the JAX tool's ``run_xla`` should compute (it
    keeps bf16 sums and no ReLU)."""
    x, k5, bias = inputs(1, b=2, hh=12, ww=40)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xn = hc.normalize_apply(xt, SHIFT, SCALE)
    k5_bf16 = jnp.asarray(k5).astype(jnp.bfloat16).astype(jnp.float32)
    ref = jax_blocks(jnp.asarray(xn.float().permute(0, 2, 3, 1).numpy()),
                     k5_bf16, jnp.asarray(bias), dtype=jnp.float32)
    ref = jnp.maximum(ref, 0.0).astype(jnp.bfloat16).astype(jnp.float32)
    w2, b4 = port_weights(k5, bias)
    got = hc.head_cmajor(xt, w2, b4, shift=SHIFT, scale=SCALE,
                         nchw_out=nchw_out).float()
    if nchw_out:
        got = got.permute(0, 2, 3, 1)
    assert_bf16_close(got, np.asarray(ref))


def test_normalize_apply_matches_jax():
    x, _, _ = inputs(2)
    vf = jnp.asarray(x)
    want = jnp.where(vf != 0, (vf - SHIFT) * SCALE, 0.0).astype(jnp.bfloat16)
    got = hc.normalize_apply(torch.from_numpy(x), SHIFT, SCALE)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("cin,cout", [(5, 32), (3, 8)])
def test_s2d_kernel_matches_jax(cin, cout):
    """``s2d_kernel`` is ``block_kernel(bi=2, bo=2, stride=1)`` and gives
    JAX's ``s2d_kernel`` on carried weights."""
    rng = np.random.default_rng(cin)
    k = rng.standard_normal((5, 5, cin, cout)).astype(np.float32)
    w = conv_state({"kernel": k}, "c")["c.weight"]
    got = s2d_kernel(w)
    assert torch.equal(got, block_kernel(w, bi=2, bo=2, stride=1))
    want = np.asarray(jax_s2d_kernel(jnp.asarray(k)))      # (3, 3, 4ci, 4co)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
    with pytest.raises(ValueError):
        s2d_kernel(w[:, :, :3, :3])


def test_conv5x5_s2d_blocks_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 14, 20)).astype(np.float32)  # NHWC s2d
    k = (rng.standard_normal((5, 5, 5, 16)) / 10).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jax_blocks(jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(b), dtype=jnp.float32))
    sd = conv_state({"kernel": k, "bias": b}, "c")
    got = conv5x5_s2d_blocks(torch.from_numpy(x).permute(0, 3, 1, 2),
                             sd["c.weight"], sd["c.bias"],
                             dtype=torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_head_cmajor_checks_its_operands():
    x, k5, bias = inputs(4)
    w2, b4 = port_weights(k5, bias)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with pytest.raises(ValueError):
        hc.head_cmajor(xt[:, :5], w2, b4, shift=0.0, scale=1.0,
                       nchw_out=True)
    with pytest.raises(ValueError):
        hc.head_cmajor(xt, w2, b4[:8], shift=0.0, scale=1.0, nchw_out=True)
    assert hc.launches == 0


def test_tool_main_runs_on_cpu():
    """The tool end to end on the CPU at a small shape: the three variants
    agree (``xla`` is the library conv on the normalized window, ``tform``
    and ``nchw`` the plain version of T1 here)."""
    res = bench_head.main([], device="cpu", shape=(1, 20, 12, 16, 128),
                          steps=2)
    assert sorted(res) == ["nchw", "tform", "xla"]
    for name, r in res.items():
        assert r["ms_per_call"] > 0
        assert r["max_abs_diff_vs_xla"] <= MAX_REL * r["absmax"], name
