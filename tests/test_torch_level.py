"""The fused encoder level of the port (CPU: its plain version) against the
JAX package's Pallas kernel in interpret mode and its reference chain.

Bounds:
- ``pick_row_tile``: equal; ``quant_cols``: ``wq`` identical, ``ws`` rtol
  1e-6 (the same f32 operations; the bound allows one ulp);
  ``s2d_kernel_stride2``: equal (a gather of the same weights) and equal to
  ``block_kernel(bi=2, bo=1, stride=2)``; ``conv5x5_s2d_stride2``: atol 1e-5
  in f32 (another summation order);
- ``encoder_level_ref`` vs the JAX one: atol 1e-5 in f32;
- plain fused level vs ``encoder_level_int8(..., interpret=True)``: the
  integer accumulators are exact in both, so the two agree to f32 rounding
  (1e-5 in f32, one bf16 ulp after the bf16 store) except where a value sits
  on a quantization tie: there one of x's or u's int8 codes moves by one
  step, which moves the gates of the pixels around it by about one
  quantization step of one operand (~1e-3 of a gate). At most
  ``TIE_SHARE`` of the elements may lie beyond the rounding bound and none
  beyond ``TIE_MAX``;
- plain fused level vs the f32 reference chain: the JAX test's bounds
  (tests/test_level_pallas.py: max |dh| 0.06, max |dc| 0.12, mean |dh|
  5e-3);
- gradients through the level vs ``jax.vjp`` of the JAX reference chain
  with the same cotangents: atol 1e-4, rtol 1e-4 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops import conv_lstm_pallas as jcl
from ess_tpu.ops import conv_s2d as js2d
from ess_tpu.ops import level_pallas as jlv

from ess_tpu_torch.ops import conv_lstm as cl
from ess_tpu_torch.ops import conv_s2d as s2d
from ess_tpu_torch.ops import level as lv


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


TIE_SHARE = 2e-3
TIE_MAX = 2e-2
F32_ATOL = 1e-5
BF16_ATOL = 2.0 ** -8      # one bf16 ulp of a value below 1 (c may reach 2)


def level_data(b=2, ho=8, wo=16, cin=6, ch=8, seed=0):
    """The JAX test's recipe (tests/test_level_pallas.py::_level_data),
    NHWC / HWIO numpy arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.normal(size=(b, 2 * ho, 2 * wo, cin)).astype(f)
    h = np.tanh(rng.normal(size=(b, ho, wo, ch)).astype(f))
    c = rng.normal(size=(b, ho, wo, ch)).astype(f) * f(0.5)
    ek = rng.normal(size=(5, 5, cin, ch)).astype(f) / f(np.sqrt(25 * cin))
    eb = rng.normal(size=(ch,)).astype(f) * f(0.1)
    gk = (rng.normal(size=(3, 3, 2 * ch, 4 * ch)).astype(f)
          / f(np.sqrt(9 * 2 * ch)))
    gb = rng.normal(size=(4 * ch,)).astype(f) * f(0.05)
    return u, h, c, ek, eb, gk, gb


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(
        dtype)


def oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k)).permute(3, 2, 0, 1) \
        .contiguous()


def to_torch(u, h, c, ek, eb, gk, gb, dtype=torch.float32):
    return (nchw(u, dtype), nchw(h, dtype), nchw(c, dtype), oihw(ek),
            torch.from_numpy(eb), oihw(gk), torch.from_numpy(gb))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def run_both(data, *, u_s2d, dtype="float32"):
    """(h, c) of the port's level on CPU and of the JAX kernel in interpret
    mode, as float32 NHWC arrays."""
    u, h, c, ek, eb, gk, gb = data
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tu, th_, tc, *tw = to_torch(*data, dtype=tdt)
    ju = jnp.asarray(u).astype(jdt)
    if u_s2d:
        tu = s2d.space_to_depth(tu)
        ju = js2d.space_to_depth(ju)
    out = lv.encoder_level_int8(tu, (th_, tc), *tw, u_s2d=u_s2d)
    jout = jlv.encoder_level_int8(
        ju, (jnp.asarray(h).astype(jdt), jnp.asarray(c).astype(jdt)),
        *map(jnp.asarray, (ek, eb, gk, gb)), u_s2d=u_s2d, interpret=True)
    assert out is not None and jout is not None
    h2, (h2b, c2) = out
    assert h2b is h2 and h2.dtype == tdt and c2.dtype == tdt
    jh, (_, jc) = jout
    return ((nhwc(h2), nhwc(c2)),
            (np.asarray(jh.astype(jnp.float32)),
             np.asarray(jc.astype(jnp.float32))))


def check_against_kernel(got, want, atol):
    for a, b in zip(got, want):
        d = np.abs(a - b)
        assert d.max() <= TIE_MAX, d.max()
        assert (d > atol).mean() <= TIE_SHARE, (d > atol).mean()


@pytest.mark.parametrize("height", [220, 110, 55, 39, 8, 7, 29, 480, 1])
def test_pick_row_tile_matches_jax(height):
    assert cl.pick_row_tile(height) == jcl.pick_row_tile(height)


def test_pick_row_tile_dsec_levels():
    assert [cl.pick_row_tile(h) for h in (220, 110, 55, 39)] == [22, 22, 11,
                                                                 13]
    assert cl.pick_row_tile(29) is None


@pytest.mark.parametrize("k,n", [(72, 8), (1152, 64), (40, 12)])
def test_quant_cols_matches_jax(k, n):
    w2 = np.random.default_rng(k + n).normal(size=(k, n)).astype(np.float32)
    w2[:, 0] = 0.0                                   # the 1e-20 floor
    wq, ws = cl.quant_cols(torch.from_numpy(w2))
    wq_j, ws_j = jcl.quant_cols(jnp.asarray(w2))
    assert wq.dtype == torch.int8
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j))
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_j), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("cin,cout", [(6, 8), (32, 16)])
def test_s2d_kernel_stride2_matches_jax(cin, cout):
    ek = np.random.default_rng(cin).normal(size=(5, 5, cin, cout)).astype(
        np.float32)
    w = s2d.s2d_kernel_stride2(oihw(ek))
    want = np.asarray(js2d.s2d_kernel_stride2(jnp.asarray(ek)))
    assert w.shape == (cout, 4 * cin, 3, 3)
    np.testing.assert_array_equal(w.permute(2, 3, 1, 0).numpy(), want)
    # it is the general remap at bi=2, bo=1, stride=2
    assert torch.equal(w, s2d.block_kernel(oihw(ek), bi=2, bo=1, stride=2))
    with pytest.raises(ValueError):
        s2d.s2d_kernel_stride2(torch.zeros(8, 6, 3, 3))


@pytest.mark.parametrize("bias", [True, False])
def test_conv5x5_s2d_stride2_matches_jax(bias):
    u, _, _, ek, eb, _, _ = level_data(seed=7)
    b = eb if bias else None
    got = s2d.conv5x5_s2d_stride2(
        s2d.space_to_depth(nchw(u)), oihw(ek),
        None if b is None else torch.from_numpy(b), dtype=torch.float32)
    want = js2d.conv5x5_s2d_stride2(
        js2d.space_to_depth(jnp.asarray(u)), jnp.asarray(ek),
        None if b is None else jnp.asarray(b), dtype=jnp.float32)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    # and equals the stride-2 conv of the full-resolution input
    direct = torch.nn.functional.conv2d(
        nchw(u), oihw(ek), None if b is None else torch.from_numpy(b),
        stride=2, padding=2)
    torch.testing.assert_close(got, direct, atol=1e-5, rtol=0)


@pytest.mark.parametrize("u_s2d", [False, True])
def test_encoder_level_ref_matches_jax(u_s2d):
    data = level_data(seed=8)
    u, h, c, ek, eb, gk, gb = data
    tu, th_, tc, *tw = to_torch(*data)
    ju = jnp.asarray(u)
    if u_s2d:
        tu, ju = s2d.space_to_depth(tu), js2d.space_to_depth(ju)
    h2, c2 = lv.encoder_level_ref(tu, th_, tc, *tw, u_s2d=u_s2d)
    jh, jc = jlv.encoder_level_ref(ju, *map(jnp.asarray, (h, c, ek, eb, gk,
                                                          gb)), u_s2d=u_s2d)
    np.testing.assert_allclose(nhwc(h2), np.asarray(jh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(nhwc(c2), np.asarray(jc), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("u_s2d", [False, True])
def test_level_matches_jax_kernel(u_s2d, seed):
    got, want = run_both(level_data(seed=seed), u_s2d=u_s2d)
    check_against_kernel(got, want, F32_ATOL)


@pytest.mark.parametrize("u_s2d", [False, True])
def test_level_three_row_tiles(u_s2d):
    """HO = 39 -> th = 13: an interior group and both image edges."""
    assert cl.pick_row_tile(39) == 13
    got, want = run_both(level_data(b=1, ho=39, wo=10, cin=4, ch=8, seed=2),
                         u_s2d=u_s2d)
    check_against_kernel(got, want, F32_ATOL)


@pytest.mark.parametrize("u_s2d", [False, True])
def test_level_bf16_inputs(u_s2d):
    got, want = run_both(level_data(b=1, ho=26, wo=12, cin=4, ch=8, seed=3),
                         u_s2d=u_s2d, dtype="bfloat16")
    check_against_kernel(got, want, BF16_ATOL)


def test_level_zero_state_first_window():
    u, h, c, *w = level_data(seed=3)
    z = np.zeros_like(h)
    got, want = run_both((u, z, z, *w), u_s2d=False)
    check_against_kernel(got, want, F32_ATOL)


@pytest.mark.parametrize("u_s2d", [False, True])
def test_level_error_bound_vs_reference_chain(u_s2d):
    """The JAX test's int8 bounds, against the port's own reference chain."""
    tu, th_, tc, *tw = to_torch(*level_data(seed=2))
    if u_s2d:
        tu = s2d.space_to_depth(tu)
    h_ref, c_ref = lv.encoder_level_ref(tu, th_, tc, *tw, u_s2d=u_s2d)
    h2, (_, c2) = lv.encoder_level_int8(tu, (th_, tc), *tw, u_s2d=u_s2d)
    assert (h2 - h_ref).abs().max() < 0.06
    assert (c2 - c_ref).abs().max() < 0.12
    assert (h2 - h_ref).abs().mean() < 5e-3


def test_level_geometry_none():
    """Where the JAX entry returns None, so does the port's."""
    data = level_data(ho=7, seed=4)
    u, h, c, ek, eb, gk, gb = data
    tu, th_, tc, *tw = to_torch(*data)
    args = [jnp.asarray(a) for a in (ek, eb, gk, gb)]
    # 13 input rows for 7 output rows
    assert jlv.encoder_level_int8(jnp.asarray(u)[:, :13], (
        jnp.asarray(h), jnp.asarray(c)), *args, u_s2d=False,
        interpret=True) is None
    assert lv.encoder_level_int8(tu[:, :, :13], (th_, tc), *tw,
                                 u_s2d=False) is None
    # no row tile divides 29 rows
    d29 = level_data(b=1, ho=29, wo=4, cin=4, seed=4)
    t29 = to_torch(*d29)
    assert jlv.encoder_level_int8(
        jnp.asarray(d29[0]), (jnp.asarray(d29[1]), jnp.asarray(d29[2])),
        *map(jnp.asarray, d29[3:]), u_s2d=False, interpret=True) is None
    assert lv.encoder_level_int8(t29[0], (t29[1], t29[2]), *t29[3:],
                                 u_s2d=False) is None
    # a 3x3 encoder kernel
    assert lv.encoder_level_int8(tu, (th_, tc), tw[0][:, :, :3, :3], *tw[1:],
                                 u_s2d=False) is None
    # a width that does not match the state raises
    with pytest.raises(ValueError):
        lv.encoder_level_int8(tu[:, :, :, :-2], (th_, tc), *tw, u_s2d=False)


def test_level_prepared_weights():
    data = level_data(seed=6)
    tu, th_, tc, *tw = to_torch(*data)
    prep = lv.prepare_level_weights(*tw)
    ch, cu = 8, 24
    assert prep.we_q.shape == (ch, 9 * cu) and prep.we_q.dtype == torch.int8
    assert prep.wx_q.shape == prep.wh_q.shape == (4 * ch, 9 * ch)
    assert prep.sbe.shape == (2, ch) and prep.sbg.shape == (3, 4 * ch)
    # against the JAX per-call prep (level_pallas.py:168-177)
    ek, gk = jnp.asarray(data[3]), jnp.asarray(data[5])
    we_q, wse = jcl.quant_cols(js2d.s2d_kernel_stride2(ek).reshape(9 * cu, ch))
    wx_q, wsx = jcl.quant_cols(gk[:, :, :ch, :].reshape(9 * ch, 4 * ch))
    order = cl.gate_column_order(ch).numpy()
    np.testing.assert_array_equal(prep.we_q.numpy(), np.asarray(we_q).T)
    np.testing.assert_array_equal(prep.wx_q.numpy(), np.asarray(wx_q).T[order])
    np.testing.assert_allclose(prep.sbe[0].numpy(), np.asarray(wse),
                               rtol=1e-6)
    np.testing.assert_allclose(prep.sbg[0].numpy(), np.asarray(wsx),
                               rtol=1e-6)
    a = lv.encoder_level_int8(tu, (th_, tc), *tw, u_s2d=False)
    b = lv.encoder_level_int8(tu, (th_, tc), *tw, u_s2d=False, prepared=prep)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])
    c = lv.encoder_level_int8_ref(tu, th_, tc, *tw, u_s2d=False)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1][1], c[1])


def test_level_gradients_are_the_reference_chains():
    data = level_data(seed=5)
    u, h, c, ek, eb, gk, gb = data
    tu, th_, tc, tek, teb, tgk, tgb = to_torch(*data)
    tek.requires_grad_(True)
    tgk.requires_grad_(True)
    h2, (_, c2) = lv.encoder_level_int8(tu, (th_, tc), tek, teb, tgk, tgb,
                                        u_s2d=False)
    with torch.no_grad():
        h_ng, (_, c_ng) = lv.encoder_level_int8(tu, (th_, tc), tek, teb, tgk,
                                                tgb, u_s2d=False)
    assert torch.equal(h2, h_ng) and torch.equal(c2, c_ng)
    (h2.sum() + 0.5 * c2.sum()).backward()

    def f_ref(ek_, gk_):
        return jlv.encoder_level_ref(
            jnp.asarray(u), jnp.asarray(h), jnp.asarray(c), ek_,
            jnp.asarray(eb), gk_, jnp.asarray(gb), u_s2d=False)

    _, vjp = jax.vjp(f_ref, jnp.asarray(ek), jnp.asarray(gk))
    d_ek, d_gk = vjp((jnp.ones_like(jnp.asarray(h)),
                      jnp.full_like(jnp.asarray(c), 0.5)))
    np.testing.assert_allclose(tek.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(d_ek), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tgk.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(d_gk), atol=1e-4, rtol=1e-4)


def test_level_five_step_chain():
    """A carried chain: the port's plain level and the JAX kernel, each on
    its own state, stay within the tie bound over 5 steps; a tie that moves
    one code at a step moves the later states too, so the share bound grows
    with the chain."""
    data = level_data(b=1, ho=26, wo=12, cin=4, ch=8, seed=9)
    u, h, c, ek, eb, gk, gb = data
    tu, th_, tc, *tw = to_torch(*data)
    prep = lv.prepare_level_weights(*tw)
    jw = [jnp.asarray(a) for a in (ek, eb, gk, gb)]
    ju, jh, jc = jnp.asarray(u), jnp.asarray(h), jnp.asarray(c)
    for _ in range(5):
        th_, (_, tc) = lv.encoder_level_int8(tu, (th_, tc), *tw, u_s2d=False,
                                             prepared=prep)
        jh, (_, jc) = jlv.encoder_level_int8(ju, (jh, jc), *jw, u_s2d=False,
                                             interpret=True)
    for a, b in ((nhwc(th_), np.asarray(jh)), (nhwc(tc), np.asarray(jc))):
        d = np.abs(a - b)
        assert d.max() <= TIE_MAX, d.max()
        assert (d > 1e-4).mean() <= 5 * TIE_SHARE, (d > 1e-4).mean()
