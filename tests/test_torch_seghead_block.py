"""The segmentation head's blocked and fused-final forms, the blocked ResNet
stem and the E2VID's ``head_conv_impl`` against the JAX package's, and
each against the standard form it stands for.

Every form is an exact remap of the same parameters (carried across from
JAX's by ``io/convert.py``), so each is held against JAX's form on the same
numpy-seeded latents, f32. Bounds, each with its reason:

- head outputs atol 2e-5 / rtol 1e-5 against JAX's form and against the
  port's standard head relaid (JAX's own bound for its blocked head,
  tests/test_seghead_block.py);
- losses on folded logits rtol 1e-5, head gradients atol 5e-6 against the
  standard head's (JAX's bound) and 1e-5 against JAX's gradient of its
  form;
- the ResNet front with the blocked stem (train mode, running statistics,
  the parameter gradients) within tests/test_torch_resnet.py's bounds
  (latents atol 2e-5, statistics atol 1e-5, gradients atol 1e-4 /
  rtol 1e-4);
- the train steps with and without the fused-final head (and the UDA step
  also with and without the blocked stem): losses rtol 1e-5, updated
  parameters atol 1e-5, a hundredth of one step at the tiny config's lr
  of 1e-3 (RAdam divides each gradient by its running RMS, so the f32
  summation orders of the two forms move an update by a share of lr, not
  of the gradient).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.models import RecurrentUNet as JaxUNet
from ess_tpu.models import SegmentationHead as JaxHead
from ess_tpu.models import zero_recurrent_state as jax_zero_state
from ess_tpu.models.resnet import ResNet18Encoder as JaxEncoder
from ess_tpu.train import losses as jax_losses

from ess_tpu_torch.core.config import Config as PortConfig
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.models.resnet import ResNet18Encoder
from ess_tpu_torch.models.seghead import SegmentationHead
from ess_tpu_torch.ops.conv_s2d import space_to_depth, space_to_depth4
from ess_tpu_torch.train import losses
from ess_tpu_torch.train import supervised as sup
from ess_tpu_torch.train import uda
from ess_tpu_torch.train.builder import build_modules, init_params, init_state


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


B, H, W, NCLS, TCH = 2, 32, 48, 5, 64
TOL = dict(atol=2e-5, rtol=1e-5)


def nchw(a):
    return torch.from_numpy(np.moveaxis(np.asarray(a), -1, 1).copy())


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def latent_np(seed=7):
    rng = np.random.default_rng(seed)
    return {s: rng.normal(size=(B, H // s, W // s, TCH * s // 8)).astype(
        np.float32) for s in (2, 4, 8)}


@functools.lru_cache(maxsize=None)
def e2vid_params():
    """JAX E2VID parameters at the head's width (``params_from_jax`` maps
    both trees together)."""
    model = JaxUNet(base_channels=TCH // 8, num_encoders=3)
    st = jax_zero_state(1, 16, 16, num_encoders=3, base_channels=TCH // 8)
    return to_np(model.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 5)),
                            st)["params"])


def head_state(params):
    return params_from_jax(e2vid_params(), params)[1]


def heads(skip_type):
    """(JAX head, its params, the port head loaded with them)."""
    head = JaxHead(num_classes=NCLS, input_features=TCH, skip_type=skip_type)
    lat = {s: jnp.asarray(v) for s, v in latent_np().items()}
    params = to_np(head.init(jax.random.PRNGKey(0), lat)["params"])
    sd = head_state(params)
    port = SegmentationHead(NCLS, input_features=TCH, skip_type=skip_type)
    port.load_state_dict(sd)
    return head, params, port


def labels_np(seed=3):
    lab = np.random.default_rng(seed).integers(0, NCLS + 1, (B, H, W))
    return np.where(lab == NCLS, 255, lab).astype(np.int64)


FORMS = {"block": (dict(block_space=True), losses.fold_labels_s4d,
                   lambda t: losses.s4d_logits_class_minor(t, NCLS),
                   jax_losses.fold_labels_s4d,
                   lambda a: jax_losses.s4d_logits_class_minor(a, NCLS)),
         "fused": (dict(fused_final=True), losses.fold_labels_up2x,
                   lambda t: t, jax_losses.fold_labels_up2x, lambda a: a)}


@pytest.mark.parametrize("skip_type", ["concat", "sum"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_head_form_matches_jax_and_the_standard_head(form, skip_type):
    """Outputs, the task loss on folded labels and every parameter's
    gradient of the port's form against JAX's form and against the port's
    standard head."""
    kw, fold, to_minor, jfold, jminor = FORMS[form]
    head, params, port = heads(skip_type)
    lat_np = latent_np()
    lat_p = {s: nchw(v) for s, v in lat_np.items()}
    lat_j = {s: jnp.asarray(v) for s, v in lat_np.items()}
    labels = labels_np()
    nc = dict(num_classes=NCLS, ignore_label=255)

    def jloss(p):
        out = head.apply({"params": p}, lat_j, **kw)
        return jax_losses.task_loss(jminor(out[1]),
                                    jfold(jnp.asarray(labels, jnp.int32)),
                                    **nc), out

    (lj, out_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    out_p = port(lat_p, **kw)
    out_s = port(lat_p)
    np.testing.assert_allclose(nhwc(out_p[4]), np.asarray(out_j[4]), **TOL)
    np.testing.assert_allclose(nhwc(out_p[2]), np.asarray(out_j[2]), **TOL)
    np.testing.assert_allclose(nhwc(out_p[1]), np.asarray(out_j[1]), **TOL)
    if form == "block":
        np.testing.assert_allclose(out_p[2].detach().numpy(),
                                   space_to_depth(out_s[2]).detach().numpy(),
                                   **TOL)
        std1 = space_to_depth4(out_s[1])
    else:
        np.testing.assert_allclose(out_p[2].detach().numpy(),
                                   out_s[2].detach().numpy(), **TOL)
        std1 = out_s[1].reshape(B, NCLS, H // 2, 2, W // 2, 2).permute(
            0, 1, 2, 4, 3, 5).reshape(B, NCLS, H // 2, 2 * W)
    np.testing.assert_allclose(out_p[1].detach().numpy(),
                               std1.detach().numpy(), **TOL)

    lab = torch.from_numpy(labels)
    l_p = losses.task_loss(to_minor(out_p[1]), fold(lab), **nc)
    l_s = losses.task_loss(out_s[1], lab, **nc)
    np.testing.assert_allclose(float(l_p.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(l_p.detach()), float(l_s.detach()),
                               rtol=1e-5)
    names = [n for n, _ in port.named_parameters()]
    g_p = torch.autograd.grad(l_p, list(port.parameters()))
    g_s = torch.autograd.grad(l_s, list(port.parameters()))
    g_jsd = head_state(to_np(g_j))
    for n, a, b in zip(names, g_p, g_s):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-6, rtol=0,
                                   err_msg=n)
        np.testing.assert_allclose(a.numpy(), g_jsd[n].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=n)


def test_head_forms_raise_where_jax_asserts():
    _, _, port = heads("concat")
    lat = {s: nchw(v) for s, v in latent_np().items()}
    with pytest.raises(ValueError):
        port(lat, block_space=True, fused_final=True)
    plain = SegmentationHead(NCLS, input_features=TCH, skip_connect=False)
    with pytest.raises(ValueError):
        plain(lat, block_space=True)


# --- the blocked ResNet stem ---------------------------------------------

def test_blocked_stem_matches_jax_and_the_plain_stem():
    """The ResNet front with ``stem_impl='auto'`` (4x4-blocked stem, layer1
    in 2x2 blocks, batch norms pooled over subpixels) in train mode against
    JAX's ``stem_impl='auto'`` front and the port's ``'xla'`` one: latents,
    running statistics and every parameter's gradient."""
    x = np.random.default_rng(4).normal(size=(2, 32, 48, 1)).astype(
        np.float32)
    enc = JaxEncoder(base_width=16, stem_impl="auto")
    variables = to_np(enc.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want, mut = enc.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    want_sd = front_from_jax(variables["params"], to_np(mut["batch_stats"]))
    fronts = {}
    for impl in ("auto", "xla"):
        f = ResNet18Encoder(base_width=16, stem_impl=impl)
        f.load_state_dict(front_from_jax(variables["params"],
                                         variables["batch_stats"]))
        fronts[impl] = f
    img = nchw(x)
    assert fronts["auto"].blocked(img) and not fronts["xla"].blocked(img)
    outs = {k: f(img, train=True) for k, f in fronts.items()}
    for s in (2, 4, 8):
        np.testing.assert_allclose(nhwc(outs["auto"][s]),
                                   np.asarray(want[s]), atol=2e-5)
        np.testing.assert_allclose(outs["auto"][s].detach().numpy(),
                                   outs["xla"][s].detach().numpy(),
                                   atol=2e-5)
    for k, v in fronts["auto"].state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(
                v.numpy(), fronts["xla"].state_dict()[k].numpy(),
                atol=1e-5, rtol=1e-5, err_msg=k)
    grads = {k: torch.autograd.grad(sum(o[s].square().mean()
                                        for s in (2, 4, 8)),
                                    list(fronts[k].parameters()))
             for k, o in outs.items()}
    for (n, _), a, b in zip(fronts["auto"].named_parameters(),
                            grads["auto"], grads["xla"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=n)
    # odd geometries take the plain stem, and unknown names raise
    assert not fronts["auto"].blocked(torch.zeros(1, 1, 30, 48))
    with pytest.raises(ValueError, match="stem_impl"):
        ResNet18Encoder(base_width=16, stem_impl="s2d")


# --- the steps -----------------------------------------------------------

def tiny_cfg(model_name):
    from tests.test_train_steps import tiny_config
    from tests.test_torch_eval_step import port_config
    cfg = tiny_config(model_name, event_name="DSEC_events")
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset,
        sensor_a=dataclasses.replace(cfg.dataset.sensor_a, shape=(32, 48)),
        sensor_b=dataclasses.replace(cfg.dataset.sensor_b, shape=(32, 48))))
    port = port_config(cfg)
    assert isinstance(port, PortConfig)
    return port


def built(cfg, **forms):
    mods = build_modules(cfg, device="cpu", **forms)
    init_params(mods, torch.Generator().manual_seed(0))
    return mods


def dense_batch(rng, uda_step):
    ev = torch.from_numpy(rng.normal(size=(B, 2, H, W, 5)).astype(
        np.float32))
    lab = torch.from_numpy(labels_np(5))
    if not uda_step:
        return {"events": ev, "label": lab}
    img = torch.from_numpy(rng.normal(size=(B, 1, H, W)).astype(np.float32))
    return {"events_b": ev, "label_b": lab, "image_a": img,
            "label_a": torch.from_numpy(labels_np(6))}


@pytest.mark.parametrize("step_kind", ["supervised", "uda"])
def test_steps_with_jax_default_forms_equal_the_standard_forms(
        step_kind, monkeypatch):
    """Two train steps on JAX's default forms (the fused-final head; in the
    UDA step also the blocked stem and decoder conv) and on the standard
    ones from the same seeded weights: the same losses and updates; the
    first runs the fused head, the second the standard one. The builder's
    defaults are the keep rule's (``builder.DEFAULT_FORMS``): the standard
    head, stem and decoder conv."""
    name = "ess" if step_kind == "uda" else "ess_supervised"
    cfg = tiny_cfg(name)
    mods = built(cfg, fused_final=True, stem_impl="auto",
                 decoder_conv_impl="auto")
    std = built(cfg, fused_final=False, stem_impl="xla",
                decoder_conv_impl="xla")
    assert mods.fused_final and not std.fused_final
    default = built(cfg)
    assert not default.fused_final
    assert not any(d.blocked for d in default.e2vid.decoders)
    if default.front_a is not None:
        assert default.front_a.stem_impl == "xla"
    calls = []
    real = SegmentationHead.forward

    def spy(self, latent, **kw):
        calls.append(kw.get("fused_final", False))
        return real(self, latent, **kw)

    monkeypatch.setattr(SegmentationHead, "forward", spy)
    make = uda.make_train_step if step_kind == "uda" else \
        sup.make_train_step
    rng = np.random.default_rng(2)
    batches = [dense_batch(rng, step_kind == "uda") for _ in range(2)]
    runs = []
    for m in (mods, std):
        st = init_state(m)
        step = make(m)
        runs.append([{k: float(v) for k, v in step(st, b).items()
                      if v.ndim == 0} for b in batches])
        calls.append(None)
    fused_calls = calls[:calls.index(None)]
    assert fused_calls and all(fused_calls)
    assert not any(calls[calls.index(None) + 1:-1])
    for a, b in zip(*runs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    parts = [(mods.head, std.head)]
    if step_kind == "uda":
        assert (mods.front_a.stem_impl, std.front_a.stem_impl) == (
            "auto", "xla")
        parts.append((mods.front_a, std.front_a))
    for a, b in parts:
        for (n, p), q in zip(a.state_dict().items(),
                             b.state_dict().values()):
            np.testing.assert_allclose(p.float().numpy(),
                                       q.float().numpy(), atol=1e-5,
                                       err_msg=n)


# --- head_conv_impl ------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "xla", "s2d", "xla_im2col"])
def test_head_conv_impl_from_the_config_matches_jax(impl):
    """``model.head_conv_impl`` reaches the E2VID head conv through the
    builder; a standard-layout window (decode on) against JAX's
    ``RecurrentUNet(head_conv_impl=...)`` on the same parameters."""
    cfg = tiny_cfg("ess_supervised")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                head_conv_impl=impl))
    mods = build_modules(cfg, device="cpu")
    assert mods.e2vid.head.conv_impl == impl
    model = JaxUNet(base_channels=8, num_encoders=3, head_conv_impl=impl,
                    lstm_impl="xla")
    x = np.random.default_rng(9).normal(size=(B, H, W, 5)).astype(np.float32)
    st = jax_zero_state(B, H, W, num_encoders=3, base_channels=8)
    params = to_np(model.init(jax.random.PRNGKey(3), jnp.asarray(x),
                              st)["params"])
    mods.e2vid.load_state_dict(params_from_jax(
        params, to_np(JaxHead(num_classes=6, input_features=64).init(
            jax.random.PRNGKey(2), {s: jnp.zeros((1, 8 // s, 8 // s, 8 * s))
                                    for s in (2, 4, 8)})["params"]))[0])
    img_j, _, lat_j = model.apply({"params": params}, jnp.asarray(x), st)
    port_st = mods.recon_val.init_state(B, "cpu")
    with torch.no_grad():
        img_p, _, lat_p = mods.e2vid(nchw(x), port_st, lstm_impl="xla")
    np.testing.assert_allclose(nhwc(lat_p[1]), np.asarray(lat_j[1]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(img_p), np.asarray(img_j), atol=1e-4,
                               rtol=1e-4)


def test_unknown_head_conv_impl_raises_at_build():
    cfg = tiny_cfg("ess_supervised")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                head_conv_impl="pallas"))
    with pytest.raises(ValueError, match="conv_impl"):
        build_modules(cfg, device="cpu")
