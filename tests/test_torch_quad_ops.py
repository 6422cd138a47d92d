"""The block-space ops and layers of the quad-block rollout, the blocked
head and the blocked decoder / stem against the JAX package's.

Each function is a remap of the same parameters, so each is held against
its JAX form on the same numpy-seeded inputs (NCHW / OIHW here, NHWC /
HWIO there): the reshuffles (``space_to_depth4``, ``depth_to_space4``,
``segment_input_perm``, ``gates_kernel_s2d``, ``gates_bias_s2d``,
``tile_upsample2x_s2d``, ``tile_upsample2x_s2d_to_s4d``,
``fold_up2x_into_conv``, the label folds, ``s4d_logits_class_minor``) bit
for bit; every computed one (the block convs at ``bi=4``, the s2d cell, the
blocked batch and instance norms, the conv forms of ``ConvLayer`` and
``UpsampleConvLayer``) in f32 within ``TOL`` (atol 2e-5, rtol 1e-5: the
same products summed in other orders) and against the standard form it
stands for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ess_tpu.models import layers as jax_layers
from ess_tpu.ops import conv_s2d as jax_s2d
from ess_tpu.train import losses as jax_losses

from ess_tpu_torch.io.convert import conv_state
from ess_tpu_torch.models import layers
from ess_tpu_torch.ops import conv_s2d
from ess_tpu_torch.ops.conv_lstm import conv_lstm_ref
from ess_tpu_torch.train import losses


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


TOL = dict(atol=2e-5, rtol=1e-5)


def normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.moveaxis(np.asarray(a), -1, 1).copy())


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def oihw(k):
    return torch.from_numpy(np.asarray(k).transpose(3, 2, 0, 1).copy())


def hwio(w):
    return w.detach().permute(2, 3, 1, 0).numpy()


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -------------------------------------------------------- reshuffles ------

@pytest.mark.parametrize("fn", ["space_to_depth4", "depth_to_space4",
                                "tile_upsample2x_s2d",
                                "tile_upsample2x_s2d_to_s4d"])
def test_reshuffles_match_jax(fn):
    rng = np.random.default_rng(0)
    x = normal(rng, (2, 8, 12, 32))
    got = getattr(conv_s2d, fn)(nchw(x))
    np.testing.assert_array_equal(nhwc(got),
                                  np.asarray(getattr(jax_s2d, fn)(x)))


def test_space_to_depth4_inverts_and_rejects():
    x = torch.randn(2, 3, 8, 12)
    assert torch.equal(conv_s2d.depth_to_space4(conv_s2d.space_to_depth4(x)),
                       x)
    with pytest.raises(ValueError):
        conv_s2d.space_to_depth4(torch.zeros(1, 2, 6, 8))
    with pytest.raises(ValueError):
        conv_s2d.depth_to_space4(torch.zeros(1, 20, 2, 2))


@pytest.mark.parametrize("bi,segs", [(2, (3, 5)), (4, (2, 6, 1))])
def test_segment_input_perm_matches_jax(bi, segs):
    np.testing.assert_array_equal(conv_s2d.segment_input_perm(bi, segs),
                                  jax_s2d.segment_input_perm(bi, segs))


def test_gate_remap_matches_jax():
    rng = np.random.default_rng(1)
    cx, ch = 3, 5
    k = normal(rng, (3, 3, cx + ch, 4 * ch))
    b = normal(rng, (4 * ch,))
    np.testing.assert_array_equal(
        hwio(conv_s2d.gates_kernel_s2d(oihw(k))),
        np.asarray(jax_s2d.gates_kernel_s2d(jnp.asarray(k))))
    np.testing.assert_array_equal(
        conv_s2d.gates_bias_s2d(torch.from_numpy(b)).numpy(),
        np.asarray(jax_s2d.gates_bias_s2d(jnp.asarray(b))))


@pytest.mark.parametrize("k", [3, 5])
def test_fold_up2x_into_conv_matches_jax(k):
    w = normal(np.random.default_rng(2), (k, k, 4, 6))
    np.testing.assert_array_equal(
        hwio(conv_s2d.fold_up2x_into_conv(oihw(w))),
        np.asarray(jax_s2d.fold_up2x_into_conv(jnp.asarray(w))))


# -------------------------------------------------- computed forms --------

def test_up2x_bilinear_s2d_matches_jax_and_the_resize():
    x = normal(np.random.default_rng(3), (2, 5, 7, 6))
    got = conv_s2d.up2x_bilinear_s2d(nchw(x))
    np.testing.assert_allclose(nhwc(got),
                               np.asarray(jax_s2d.up2x_bilinear_s2d(x)),
                               **TOL)
    want = conv_s2d.space_to_depth(layers.upsample2x_bilinear(nchw(x)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("k", [3, 5])
def test_up2x_conv_fused_matches_jax_and_upsample_then_conv(k):
    rng = np.random.default_rng(4)
    x, w, b = normal(rng, (2, 5, 6, 4)), normal(rng, (k, k, 4, 6)), normal(
        rng, (6,))
    got = conv_s2d.up2x_conv_fused(nchw(x), oihw(w), torch.from_numpy(b))
    np.testing.assert_allclose(
        nhwc(got), np.asarray(jax_s2d.up2x_conv_fused(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))), **TOL)
    up = F.conv2d(layers.upsample2x_nearest(nchw(x)), oihw(w),
                  torch.from_numpy(b), padding=k // 2)
    np.testing.assert_allclose(got.numpy(),
                               conv_s2d.space_to_depth(up).numpy(), **TOL)


def test_conv5x5_s2d_matches_jax():
    rng = np.random.default_rng(5)
    x, w, b = normal(rng, (2, 8, 12, 5)), normal(rng, (5, 5, 5, 7)), normal(
        rng, (7,))
    got = conv_s2d.conv5x5_s2d(nchw(x), oihw(w), torch.from_numpy(b),
                               dtype=torch.float32)
    want = jax_s2d.conv5x5_s2d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), dtype=jnp.float32)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


# the block kernels the quad-block rollout, the blocked head and the
# blocked stem run: (k, bi, bo, stride)
QUAD_REMAPS = {"s4d_head": (5, 4, 4, 1), "s4d_to_s2d": (5, 4, 2, 2),
               "stem": (7, 4, 2, 2), "logits": (1, 4, 4, 1),
               "s4d_3x3": (3, 4, 4, 1), "s2d_3x3": (3, 2, 2, 1)}


@pytest.mark.parametrize("name", sorted(QUAD_REMAPS))
def test_block_kernel_at_the_quad_remaps(name):
    """The remap equals JAX's bit for bit, and the blocked conv on the
    blocked input equals the conv of the image, relaid (JAX's
    ``tests/test_quad_block.py`` identities)."""
    k, bi, bo, stride = QUAD_REMAPS[name]
    rng = np.random.default_rng(6)
    x, w = normal(rng, (2, 16, 24, 3)), normal(rng, (k, k, 3, 7))
    w2 = conv_s2d.block_kernel(oihw(w), bi=bi, bo=bo, stride=stride)
    np.testing.assert_array_equal(
        hwio(w2), np.asarray(jax_s2d.block_kernel(
            jnp.asarray(w), bi=bi, bo=bo, stride=stride)))
    s2d_in = conv_s2d.space_to_depth4 if bi == 4 else conv_s2d.space_to_depth
    got = F.conv2d(s2d_in(nchw(x)), w2, padding=w2.shape[-1] // 2)
    ref = F.conv2d(nchw(x), oihw(w), stride=stride, padding=k // 2)
    back = {4: conv_s2d.depth_to_space4, 2: conv_s2d.depth_to_space,
            1: lambda t: t}[bo]
    np.testing.assert_allclose(back(got).numpy(), ref.numpy(), atol=3e-5)


def test_block_kernel_rejects_an_even_block_kernel():
    with pytest.raises(ValueError, match="odd block-kernel"):
        conv_s2d.block_kernel(torch.zeros(7, 3, 5, 5), bi=4, bo=1, stride=4)


@pytest.mark.parametrize("segs", [None, (6, 2)], ids=["whole", "segments"])
def test_block_conv_in_segments_follows_the_concat(segs):
    """A 3x3 conv on ``[s2d(a) | s2d(b)]`` with ``in_segments`` equals the
    conv of ``concat(a, b)``, as JAX's ``_BlockConv``."""
    rng = np.random.default_rng(7)
    a, b = normal(rng, (2, 8, 12, 6)), normal(rng, (2, 8, 12, 2))
    conv = layers.Conv2d(8, 5, 3, padding=1)
    blk = layers.BlockConv(conv, None, in_segments=segs)
    if segs is None:
        x_blk = conv_s2d.space_to_depth(torch.cat([nchw(a), nchw(b)], 1))
    else:
        x_blk = torch.cat([conv_s2d.space_to_depth(nchw(a)),
                           conv_s2d.space_to_depth(nchw(b))], 1)
    with torch.no_grad():
        got = conv_s2d.depth_to_space(blk(x_blk))
        want = conv(torch.cat([nchw(a), nchw(b)], 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_int8_interpret"])
def test_s2d_cell_matches_jax_and_the_standard_cell(impl):
    """``ConvLSTMCell(state_block=2)`` against JAX's on the same gate
    parameters (the exact cell within TOL, the int8 cell's quantized gates
    within 1e-3 of JAX's interpret-mode int8 cell), and the exact s2d cell
    against the standard cell on the same state, relaid."""
    rng = np.random.default_rng(8)
    cx, ch = 32, 32
    x, h, c = (normal(rng, (2, 8, 12, n)) for n in (4 * cx, 4 * ch, 4 * ch))
    h = np.tanh(h)
    cell = jax_layers.ConvLSTMCell(
        ch, impl="xla" if impl == "xla" else "pallas_int8_interpret",
        state_block=2)
    params = to_np(cell.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             (jnp.asarray(h), jnp.asarray(c)))["params"])
    hj, (_, cj) = cell.apply({"params": params}, jnp.asarray(x),
                             (jnp.asarray(h), jnp.asarray(c)))
    port = layers.ConvLSTMCell(cx, ch)
    port.load_state_dict(conv_state(params["gates"], "Gates"))
    with torch.no_grad():
        hp, (_, cp) = port(nchw(x), (nchw(h), nchw(c)), impl, state_block=2)
    tol = TOL if impl == "xla" else dict(atol=1e-3, rtol=0)
    np.testing.assert_allclose(nhwc(hp), np.asarray(hj), **tol)
    np.testing.assert_allclose(nhwc(cp), np.asarray(cj), **tol)
    if impl == "xla":
        d2s = conv_s2d.depth_to_space
        with torch.no_grad():
            hs, cs = conv_lstm_ref(d2s(nchw(x)), d2s(nchw(h)), d2s(nchw(c)),
                                   port.Gates.weight, port.Gates.bias)
        np.testing.assert_allclose(d2s(hp).numpy(), hs.numpy(), **TOL)
        np.testing.assert_allclose(d2s(cp).numpy(), cs.numpy(), **TOL)


def test_s2d_cell_gradient_flows_through_the_remap():
    """Under autograd the s2d cell's gate gradient is the standard cell's:
    the remap is a gather of the parameters."""
    rng = np.random.default_rng(9)
    x, h, c = (torch.from_numpy(normal(rng, (1, 4 * 4, 4, 6)))
               for _ in range(3))
    port = layers.ConvLSTMCell(4, 4)
    h1, (_, c1) = port(x, (h, c), "xla", state_block=2)
    g_blk = torch.autograd.grad((h1 * c1).sum(), port.Gates.weight)[0]
    d2s = conv_s2d.depth_to_space
    h2, c2 = conv_lstm_ref(d2s(x), d2s(h), d2s(c), port.Gates.weight,
                           port.Gates.bias)
    g_std = torch.autograd.grad((h2 * c2).sum(), port.Gates.weight)[0]
    np.testing.assert_allclose(g_blk.numpy(), g_std.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_blocked_batch_norm_matches_jax(train):
    """``BatchNorm2d`` with ``block=2`` against JAX ``TorchBatchNorm(
    block=2)``: output and (train) the running statistics (torch's
    unbiased running variance in both), and the standard norm of the
    unfolded tensor."""
    rng = np.random.default_rng(10)
    x = normal(rng, (2, 6, 8, 4 * 5)) * 2 + 1
    bn = jax_layers.TorchBatchNorm(use_running_average=not train, block=2)
    variables = to_np(bn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = {k: v + rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
              for k, v in variables["params"].items()}
    stats = {k: v + rng.uniform(0, 0.5, v.shape).astype(np.float32)
             for k, v in variables["batch_stats"].items()}
    want, mut = bn.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), mutable=["batch_stats"])
    port = layers.BatchNorm2d(5)
    std = layers.BatchNorm2d(5)
    for m in (port, std):
        m.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                           "bias": torch.from_numpy(params["bias"]),
                           "running_mean": torch.from_numpy(stats["mean"]),
                           "running_var": torch.from_numpy(stats["var"]),
                           "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = port(nchw(x), train, 2)
        ref = std(conv_s2d.depth_to_space(nchw(x)), train)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(conv_s2d.depth_to_space(got).numpy(),
                               ref.numpy(), **TOL)
    new = mut["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["mean"]), **TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new["var"]), **TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               std.running_var.numpy(), **TOL)
    assert int(port.num_batches_tracked) == int(train)


@pytest.mark.parametrize("block", [2, 4])
def test_instance_norm_blocked_matches_jax(block):
    x = normal(np.random.default_rng(11), (2, 3, 5, block * block * 6))
    got = layers.instance_norm_blocked(nchw(x), block)
    np.testing.assert_allclose(
        nhwc(got), np.asarray(jax_layers.instance_norm_blocked(
            jnp.asarray(x), block)), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl,k,stride", [
    ("xla", 5, 1), ("s2d", 5, 1), ("xla_im2col", 5, 1), ("xla_im2col", 3, 1),
    ("auto", 5, 1), ("auto", 5, 2), ("s2d", 3, 1)])
def test_conv_layer_conv_impl_matches_jax(impl, k, stride):
    """Every ``conv_impl`` of ``ConvLayer`` against JAX's ``ConvLayer`` at
    the same value: the same function over the same parameters."""
    rng = np.random.default_rng(12)
    x = normal(rng, (2, 8, 12, 5))
    jl = jax_layers.ConvLayer(7, k, stride, conv_impl=impl)
    params = to_np(jl.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    port = layers.ConvLayer(5, 7, k, stride, conv_impl=impl)
    port.load_state_dict(conv_state(params["Conv_0"], "conv2d"))
    with torch.no_grad():
        got = port(nchw(x))
    want = jl.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_conv_layer_unknown_conv_impl_raises():
    with pytest.raises(ValueError, match="conv_impl"):
        layers.ConvLayer(5, 7, 5, conv_impl="pallas")
    with pytest.raises(ValueError, match="conv_impl"):
        layers.UpsampleConvLayer(8, 4, conv_impl="s2d")


@pytest.mark.parametrize("features,impl", [(6, "auto"), (6, "xla"),
                                           (128, "auto")])
def test_upsample_conv_layer_matches_jax(features, impl):
    """The decoder's ``UpsampleConvLayer``: ``'auto'`` blocks a 5x5 conv
    with fewer than 128 outputs, as JAX's; both forms against JAX's at the
    same value and against each other."""
    rng = np.random.default_rng(13)
    x = normal(rng, (2, 5, 6, 8))
    jl = jax_layers.UpsampleConvLayer(features, conv_impl=impl)
    params = to_np(jl.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    port = layers.UpsampleConvLayer(8, features, conv_impl=impl)
    port.load_state_dict(conv_state(params["Conv_0"], "conv2d"))
    assert port.blocked == (impl == "auto" and features < 128)
    other = layers.UpsampleConvLayer(8, features, conv_impl="xla")
    other.load_state_dict(port.state_dict())
    with torch.no_grad():
        got, std = port(nchw(x)), other(nchw(x))
    want = jl.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), std.numpy(), atol=1e-4,
                               rtol=1e-4)


# ------------------------------------------------------ label folds -------

def test_label_folds_match_jax():
    rng = np.random.default_rng(14)
    labels = rng.integers(0, 11, (2, 8, 12)).astype(np.int64)
    labels[0, :2] = 255
    np.testing.assert_array_equal(
        losses.fold_labels_up2x(torch.from_numpy(labels)).numpy(),
        np.asarray(jax_losses.fold_labels_up2x(jnp.asarray(labels))))
    np.testing.assert_array_equal(
        losses.fold_labels_s4d(torch.from_numpy(labels)).numpy(),
        np.asarray(jax_losses.fold_labels_s4d(jnp.asarray(labels))))
    logits = normal(rng, (2, 2, 3, 16 * 5))
    got = losses.s4d_logits_class_minor(nchw(logits), 5)
    np.testing.assert_array_equal(
        nhwc(got), np.asarray(jax_losses.s4d_logits_class_minor(
            jnp.asarray(logits), 5)))
    with pytest.raises(ValueError):
        losses.s4d_logits_class_minor(nchw(logits), 4)


@pytest.mark.parametrize("fold", ["up2x", "s4d"])
def test_folded_losses_are_the_standard_loss(fold):
    """CE + dice with the ignore label on folded logits and labels equal
    the loss of the standard layout, in value and gradient, and JAX's
    loss on its folds."""
    rng = np.random.default_rng(15)
    nc, hh, ww = 5, 8, 12
    labels = rng.integers(0, nc, (2, hh, ww)).astype(np.int64)
    labels[1, 3:5] = 255
    x = torch.from_numpy(normal(rng, (2, nc, hh, ww))).requires_grad_()
    if fold == "up2x":   # (B, C, h, 4w) in (j, r, s) order
        b4 = x.reshape(2, nc, hh // 2, 2, ww // 2, 2).permute(
            0, 1, 2, 4, 3, 5).reshape(2, nc, hh // 2, 2 * ww)
        lab = losses.fold_labels_up2x(torch.from_numpy(labels))
        jl = jax_losses.fold_labels_up2x(jnp.asarray(labels))
    else:                # the blocked head's s4d logits
        b4 = losses.s4d_logits_class_minor(conv_s2d.space_to_depth4(x), nc)
        lab = losses.fold_labels_s4d(torch.from_numpy(labels))
        jl = jax_losses.fold_labels_s4d(jnp.asarray(labels))
    kw = dict(num_classes=nc, ignore_label=255)
    folded = losses.task_loss(b4, lab, **kw)
    std = losses.task_loss(x, torch.from_numpy(labels), **kw)
    np.testing.assert_allclose(float(folded.detach()), float(std.detach()),
                               rtol=1e-6)
    g_f = torch.autograd.grad(folded, x)[0]
    g_s = torch.autograd.grad(std, x)[0]
    np.testing.assert_allclose(g_f.numpy(), g_s.numpy(), atol=1e-7)
    want = jax_losses.task_loss(jnp.asarray(nhwc(b4)), jl, **kw)
    np.testing.assert_allclose(float(folded.detach()), float(want),
                               rtol=1e-5)
