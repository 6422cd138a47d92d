"""The ConvLSTM attribution variants of the port (CPU: their plain versions)
against the JAX package, and the two attribution tools end to end at a tiny
shape.

The JAX tool (tools/bench_lstm_breakdown.py) builds its kernel inside
``main()`` and has no interpret switch, so:

- ``full`` is held against ``conv_lstm_cell`` with ``impl=
  'pallas_interpret'`` (f32: atol 1e-5, another summation order) and
  ``'pallas_int8_interpret'`` (atol 1e-5: identical integer accumulators);
- ``ptw_mul``, ``ptw_bf16`` and ``no_ptw`` are held against a jnp
  transcription of that tool's epilogue, lines 83-109, applied to the f32
  gates of the JAX reference conv (``conv_lstm_ref``'s conv,
  conv_lstm_pallas.py:118-124), op by op outside ``jit`` so that every bf16
  operation rounds on its own. Bounds: ``no_ptw`` and ``ptw_mul`` atol 1e-5
  on gates of order 1 (f32, another summation order); ``ptw_bf16`` 2^-6 (two
  bf16 ulps of a value below 2: a gate that rounds to the other bf16
  neighbour moves the result by an ulp or two) on at least 99 % of the
  values and 2^-4 on all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops.conv_lstm_pallas import conv_lstm_cell as jax_cell

from ess_tpu_torch.ops import conv_lstm
from ess_tpu_torch.tools import bench_level, bench_lstm_breakdown as bd


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


def make(b=2, h=12, w=20, c=16, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, h, w, c)).astype(f)
    hp = np.tanh(rng.normal(size=(b, h, w, c))).astype(f)
    cp = (rng.normal(size=(b, h, w, c)) * 0.5).astype(f)
    kern = (rng.normal(size=(3, 3, 2 * c, 4 * c)) * (18 * c) ** -0.5).astype(f)
    bias = (rng.normal(size=(4 * c,)) * 0.05).astype(f)
    return x, hp, cp, kern, bias


def to_torch(x, hp, cp, kern, bias):
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    return (nchw(x), nchw(hp), nchw(cp),
            torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous(),
            torch.from_numpy(bias))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def jax_gates(x, hp, kern, bias):
    """conv_lstm_pallas.py:118-124: the f32 gates of the reference cell."""
    xh = jnp.concatenate([jnp.asarray(x), jnp.asarray(hp)], axis=-1)
    return jax.lax.conv_general_dilated(
        xh, jnp.asarray(kern), window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32) + jnp.asarray(bias)


def jax_epilogue(gates, c_prev, mode, ch):
    """tools/bench_lstm_breakdown.py:83-109 on f32 gates (the outputs cast
    to f32, the state's dtype here)."""
    if mode in ("no_ptw", "no_build"):
        return gates[..., 0 * ch:1 * ch], gates[..., 1 * ch:2 * ch]
    if mode == "ptw_bf16":
        gates = gates.astype(jnp.bfloat16)
    i = gates[..., 0 * ch:1 * ch]
    f = gates[..., 1 * ch:2 * ch]
    o = gates[..., 2 * ch:3 * ch]
    g = gates[..., 3 * ch:4 * ch]
    cp = jnp.asarray(c_prev).astype(gates.dtype)
    if mode == "ptw_mul":
        c_new = f * cp + i * g
        h_new = o * c_new
    elif mode == "ptw_bf16":
        half = jnp.bfloat16(0.5)
        sig = lambda v: jnp.tanh(v * half) * half + half
        c_new = sig(f) * cp + sig(i) * jnp.tanh(g)
        h_new = sig(o) * jnp.tanh(c_new)
    else:
        c_new = jax.nn.sigmoid(f) * cp + jax.nn.sigmoid(i) * jnp.tanh(g)
        h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
    return h_new.astype(jnp.float32), c_new.astype(jnp.float32)


@pytest.mark.parametrize("int8", [False, True])
def test_full_variant_is_the_cell(int8):
    args = make(seed=1)
    t_args = to_torch(*args)
    h, c = bd.cell_variant_ref(*t_args, mode="full", int8=int8)
    impl = "pallas_int8_interpret" if int8 else "pallas_interpret"
    hj, cj = jax_cell(*map(jnp.asarray, args), impl=impl)
    np.testing.assert_allclose(nhwc(h), np.asarray(hj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(nhwc(c), np.asarray(cj), atol=1e-5, rtol=0)
    # and the port's own plain cells, bit for bit
    ref = conv_lstm.conv_lstm_int8_ref if int8 else conv_lstm.conv_lstm_ref
    h2, c2 = ref(*t_args)
    assert torch.equal(h, h2) and torch.equal(c, c2)
    # on CPU tensors the wrapper runs the plain version
    h3, c3 = bd.cell_variant(*t_args, mode="full", int8=int8)
    assert torch.equal(h, h3) and torch.equal(c, c3)


@pytest.mark.parametrize("mode", ["ptw_mul", "no_ptw", "ptw_bf16"])
def test_variant_matches_jax_epilogue(mode):
    args = make(seed=2)
    x, hp, cp, kern, bias = args
    ch = x.shape[-1]
    h, c = bd.cell_variant_ref(*to_torch(*args), mode=mode, int8=False)
    hj, cj = jax_epilogue(jax_gates(x, hp, kern, bias), cp, mode, ch)
    for got, want in ((nhwc(h), np.asarray(hj)), (nhwc(c), np.asarray(cj))):
        d = np.abs(got - want)
        if mode == "ptw_bf16":
            assert d.max() <= 2.0 ** -4, d.max()
            assert (d <= 2.0 ** -6).mean() >= 0.99, (d <= 2.0 ** -6).mean()
        else:
            assert d.max() <= 1e-5, d.max()


@pytest.mark.parametrize("mode", ["ptw_mul", "no_ptw", "ptw_bf16"])
def test_int8_variant_is_the_epilogue_on_the_int8_gates(mode):
    """The int8 variants apply the same epilogues to the int8 cell's gates,
    which ``full`` above holds against the Pallas int8 kernel."""
    args = to_torch(*make(seed=3))
    gates = conv_lstm.gates_int8_ref(args[0], args[1], args[3], args[4])
    h, c = bd.cell_variant_ref(*args, mode=mode, int8=True)
    h2, c2 = bd.variant_pointwise(gates, args[2], mode)
    assert torch.equal(h, h2.float()) and torch.equal(c, c2.float())
    # the variants differ from the cell and from each other
    hf, _ = bd.cell_variant_ref(*args, mode="full", int8=True)
    assert (h - hf).abs().max() > 1e-3


def test_variant_modes_are_checked():
    args = to_torch(*make(b=1, h=4, w=4, c=8))
    with pytest.raises(ValueError):
        bd.cell_variant(*args, mode="ptw", int8=False)
    with pytest.raises(ValueError):
        conv_lstm.launch_variant(*args, mode="full", int8=False)   # CPU
    assert bd.MODES == conv_lstm.MODES and "no_build" not in bd.COMPARED
    h, c = bd.cell_variant(*args, mode="no_build", int8=False)
    h2, c2 = bd.cell_variant(*args, mode="no_ptw", int8=False)
    assert torch.equal(h, h2) and torch.equal(c, c2)


@pytest.mark.parametrize("int8", ["0", "1"])
def test_breakdown_tool_runs_on_cpu(capsys, int8):
    shapes = [(1, 8, 6, 8), (1, 16, 4, 6)]
    res = bd.main([f"--int8={int8}", "--layers=0,1"], device="cpu",
                  shapes=shapes, steps=2)
    out = capsys.readouterr().out
    assert "plain versions, host clock" in out
    assert f"L1 (B1 4x6x16) int8={int8 == '1'}" in out
    for mode in bd.MODES:
        assert f"  {mode:9s}:" in out
        assert res[1][mode] > 0
    assert "operand gather" in out and "output undefined" in out
    with pytest.raises(ValueError):
        bd.main(["--layers=3"], device="cpu", shapes=shapes, steps=1)


def test_level_tool_runs_on_cpu(capsys):
    layers = [((1, 16, 8, 12), 8, True), ((1, 8, 16, 12), 8, False)]
    res = bench_level.main([], device="cpu", layers=layers[:2] + layers[:1],
                           steps=2)
    out = capsys.readouterr().out
    assert "plain versions, host clock" in out
    for li in (0, 1, 2):
        for name in ("split", "fused"):
            assert f"L{li} {name}: single-step |dh| vs f32 ref" in out
            r = res[li][name]
            # the JAX test's int8 bounds (tests/test_level_pallas.py:28-37)
            assert r["dh_max"] < 0.06 and r["dc_max"] < 0.12
            assert r["dh_mean"] < 5e-3 and r["ms_per_step"] > 0
    assert out.count(" ms / 2 steps") == 6


def test_tools_need_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        bd.main(["--layers=0"])
    with pytest.raises(RuntimeError):
        bench_level.main(["--layers=0"])
