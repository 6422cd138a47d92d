"""The UDA slice: the port's ESS UDA steps against JAX ``ess_tpu.train.uda``
and its losses against ``ess_tpu.train.losses``.

The slice runs ``tiny_config(model_name='ess')`` (E2VID base 8, so a
16-wide image front, 6 classes, f32) at a 24x128 sensor for both sensors
(one band of one x-slot), B=2, T=2, on a host-folded ``x_slots=True``
batch with no augmentation. The cycle weights differ from each other and
from 1 (emb 0.5, task 0.3, pred 0.7), so a term routed to the wrong
parameters or scaled by the wrong weight shows. On the exact train cell
the JAX step runs on the same batch with its voxelizer and ConvLSTM
kernels in interpret mode; on the int8 train cell it runs on the windows
the port's pipeline built, as a dense batch, because int8 rounding is
discontinuous and the two voxelizers differ by f32 noise
(``tests/test_torch_train_step.py``). The
port runs its plain versions on CPU with the JAX weights
(``params_from_jax``, ``front_from_jax``). The JAX front evaluates its stem
and layer1 in 2x2 block space at this shape, the port as plain convs.

The train step is parametrized over DSEC (front features detached on the
image branch, symmetric JS in the front's loss) against a non-DSEC sensor B
with ``train_on_event_labels`` (the image task loss reaches the front, the
sensor-B task loss the head), and over the exact and int8 train cells.

Bounds (same f32 math, other summation orders and conv formulations):
- every loss entry rtol 1e-4;
- gradients, per parameter tensor, within 5 % of the tensor's largest
  JAX gradient plus 3e-5 (the head's biases before an instance norm have
  a zero gradient in exact math and ~1e-5 of rounding): after one train
  step, whose RAdam update is ``p - lr g`` (lr 1e-2), the implied gradient
  ``(p0 - p) / lr``; and, in ``test_uda_gradients_match_jax``, the routed
  gradients themselves against ``jax.grad`` of JAX's single total on the
  same rollout outputs. At these tiny shapes some ReLU inputs lie within
  f32 rounding of 0, so the two packages' forwards (and JAX's jitted and
  eager forms) switch a few different units on, which moves a tensor's
  gradient by up to 2.6 % (seen at batch seed 3, weights 4; an all-f64
  central difference on the port converges to the port's gradient). A
  term routed to the wrong parameters or weighted wrongly moves them by
  far more: six such edits of ``train/uda.py`` (DSEC routing off, a
  missing detach, ``t_img`` dropped from the front, symmetric JS in the
  front's loss off DSEC, ``e_loss`` into the head, a swapped cycle
  weight) each fail this file;
- BN running statistics atol 1e-5, E2VID bit-identical;
- eval steps: losses rtol 1e-4, ``latent8`` and ``img_fake`` atol 1e-4,
  argmax and confusion matrices equal except at pixels whose top-2 logit
  gap is below 1e-4;
- losses in value rtol 1e-5, in gradient atol 1e-6 / rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.ops.voxel_pallas import host_band_bin_folded
from ess_tpu.train import losses as jax_losses
from ess_tpu.train import uda as jax_uda
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch import bench, resolve_device
from ess_tpu_torch.core.config import load_config
from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.models.resnet import ResNet18Encoder
from ess_tpu_torch.train import losses
from ess_tpu_torch.train.builder import build_modules, init_params, init_state
from ess_tpu_torch.train.uda import (make_eval_step_a, make_eval_step_b,
                                     make_train_step, uda_losses)
from tests.test_torch_eval_step import port_config
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_train_steps import tiny_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

B, T, N, H, W, CLASSES = 2, 2, 600, 24, 128, 6
LR = 1e-2
GRAD_REL = 0.05
SENSORS = {"dsec": "DSEC_events", "other": "synthetic_events"}


def uda_config(sensor: str, lstm_impl_train=None):
    cfg = tiny_config(model_name="ess", event_name=SENSORS[sensor],
                      weight_cycle_emb_loss=0.5, weight_cycle_task_loss=0.3,
                      weight_cycle_pred_loss=0.7)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr_front=LR,
                                                lr_back=LR))
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset,
            sensor_a=dataclasses.replace(cfg.dataset.sensor_a, shape=(H, W)),
            sensor_b=dataclasses.replace(cfg.dataset.sensor_b, shape=(H, W),
                                         nr_events_data=T)),
        model=dataclasses.replace(
            cfg.model, lstm_impl="pallas_interpret",
            lstm_impl_train=lstm_impl_train,
            train_on_event_labels=sensor == "other"))


def uda_batch(rng):
    """Host-folded sensor-B events with labels, and sensor-A images with
    labels (NHWC for JAX), ignored rows in both label maps."""
    raw = np.zeros((B, T, N, 4), np.float32)
    raw[..., 0] = rng.uniform(0, W - 1, (B, T, N))
    raw[..., 1] = rng.uniform(0, H - 1, (B, T, N))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (B, T, N)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (B, T, N))
    valid = np.ones((B, T, N), bool)
    valid[..., N - N // 10:] = False
    rs, vs, os_ = zip(*(host_band_bin_folded(raw[i], valid[i], height=H,
                                             width=W, bins=5, x_slots=True)
                        for i in range(B)))
    rs, vs, os_ = np.stack(rs), np.stack(vs), np.stack(os_)
    labels = rng.integers(0, CLASSES, (2, B, H, W)).astype(np.int64)
    labels[:, :, :3] = 255
    return {"ev_x": rs[..., 0], "ev_y": rs[..., 1], "ev_t": rs[..., 2],
            "ev_p": rs[..., 3], "ev_valid": vs, "ev_band_offsets": os_,
            "label_b": labels[0], "label_a": labels[1],
            "image_a": rng.normal(size=(B, H, W, 1)).astype(np.float32)}


def port_batch(cols):
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    batch["image_a"] = batch["image_a"].permute(0, 3, 1, 2)
    return batch


def jax_pipeline() -> JaxPipeline:
    return JaxPipeline(JaxPipelineConfig(
        sensor_height=H, sensor_width=W, num_bins=5, trilinear=True,
        normalize=True, use_pallas=True, pallas_interpret=True,
        voxel_oh_dtype="float32"))


def port_pipeline() -> EventPipeline:
    return EventPipeline(PipelineConfig(sensor_height=H, sensor_width=W,
                                        num_bins=5, trilinear=True,
                                        normalize=True))


def close_gradients(name, got, want, *, atol):
    """``got`` within GRAD_REL of ``want``'s largest magnitude, plus
    ``atol``."""
    err = float((got - want).abs().max())
    bound = GRAD_REL * float(want.abs().max()) + atol
    assert err <= bound, (name, err, bound)


def port_modules(cfg, state):
    """The port's modules of ``cfg`` with the JAX state's weights."""
    mods = build_modules(port_config(cfg), device="cpu")
    sd_e, sd_h = params_from_jax(jax.device_get(state.e2vid_params),
                                 jax.device_get(state.back_params))
    mods.e2vid.load_state_dict(sd_e)
    mods.head.load_state_dict(sd_h)
    mods.front_a.load_state_dict(front_from_jax(
        jax.device_get(state.front_params),
        jax.device_get(state.front_batch_stats)))
    return mods


@pytest.mark.parametrize("lstm_impl_train", [None, "pallas_int8_interpret"],
                         ids=["exact", "int8"])
@pytest.mark.parametrize("sensor", ["dsec", "other"])
def test_uda_train_step_matches_jax(sensor, lstm_impl_train):
    cfg = uda_config(sensor, lstm_impl_train)
    cols = uda_batch(np.random.default_rng(0))
    batch = port_batch(cols)
    pipe = port_pipeline()

    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_modules(cfg, state)
    assert pmods.recon_train.lstm_impl == (
        "pallas" if lstm_impl_train is None else "pallas_int8_interpret")
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()}
    for k in ("label_a", "label_b"):
        jbatch[k] = jbatch[k].astype(jnp.int32)
    if lstm_impl_train is not None:
        windows, _ = pipe.build_all(batch)
        jbatch = {"events_b": jnp.asarray(
            windows.permute(1, 0, 3, 4, 2).numpy()),
            **{k: jbatch[k] for k in ("image_a", "label_a", "label_b")}}
    new_state, want = jax.device_get(
        jax_uda.make_train_step(mods, jax_pipeline())(state, jbatch))
    want_front = front_from_jax(new_state.front_params,
                                new_state.front_batch_stats)
    _, want_head = params_from_jax(new_state.e2vid_params,
                                   new_state.back_params)

    pstate = init_state(pmods)
    front0 = {k: v.clone() for k, v in pmods.front_a.state_dict().items()}
    head0 = {k: v.clone() for k, v in pmods.head.state_dict().items()}
    e2vid0 = {k: v.clone() for k, v in pmods.e2vid.state_dict().items()}
    got = make_train_step(pmods, pipe)(pstate, batch)
    assert pstate.step == 1
    assert pmods.opt_front.step_count == pmods.opt_back.step_count == 1

    assert sorted(got) == sorted(want)
    assert ("semseg_sensor_b_loss" in got) == (sensor == "other")
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    for module, before, after in ((pmods.front_a, front0, want_front),
                                  (pmods.head, head0, want_head)):
        for k, v in module.state_dict().items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == 2, k     # two train passes of the front
            elif "running" in k:
                np.testing.assert_allclose(v.numpy(), after[k].numpy(),
                                           atol=1e-5, rtol=0, err_msg=k)
                assert not torch.equal(v, before[k]), k
            else:
                close_gradients(k, (before[k] - v) / LR,
                                (before[k] - after[k]) / LR, atol=3e-5)
    for k, v in pmods.e2vid.state_dict().items():
        assert torch.equal(v, e2vid0[k]), k


def test_uda_gradients_match_jax():
    """The gradient routing alone, without optimizer or jit: on the port's
    rollout outputs, the port's front gradient (of ``e_loss``, plus
    ``t_img`` off DSEC) and head gradient (of ``t_img + t_ev``) against
    ``jax.grad`` of JAX ``uda_losses``' single total, run eagerly."""
    cfg = uda_config("other")
    cols = uda_batch(np.random.default_rng(3))
    batch = port_batch(cols)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(4))
    pmods = port_modules(cfg, state)
    pbatch = {k: v for k, v in batch.items() if k.startswith("ev_")}
    pbatch["label"] = batch["label_b"]
    with torch.no_grad():
        windows, labels_b = port_pipeline().build_all(pbatch)
        img_fake, _, latent_real = pmods.recon_train.rollout(windows)
    _, front_loss, back_loss = uda_losses(
        pmods, pmods.front_a, pmods.head, img_a=batch["image_a"],
        labels_a=batch["label_a"], img_fake=img_fake,
        latent_real=latent_real, labels_b=labels_b)
    names_f, params_f = zip(*pmods.front_a.named_parameters())
    names_h, params_h = zip(*pmods.head.named_parameters())
    got = dict(zip(names_f, torch.autograd.grad(front_loss, params_f,
                                                retain_graph=True)))
    got_h = dict(zip(names_h, torch.autograd.grad(back_loss, params_h)))

    nhwc = lambda x: jnp.asarray(x.permute(0, 2, 3, 1).numpy())

    def total(front_params, back_params):
        return jax_uda.uda_losses(
            mods, front_params, back_params, state.front_batch_stats,
            img_a=jnp.asarray(cols["image_a"]),
            labels_a=jnp.asarray(cols["label_a"], jnp.int32),
            img_fake=nhwc(img_fake),
            latent_real={k: nhwc(v) for k, v in latent_real.items()},
            labels_b=jnp.asarray(labels_b.numpy(), jnp.int32))[0]

    g_front, g_head = jax.device_get(jax.grad(total, argnums=(0, 1))(
        state.front_params, state.back_params))
    want = front_from_jax(g_front, state.front_batch_stats)
    _, want_h = params_from_jax(state.e2vid_params, g_head)
    for grads, ref in ((got, want), (got_h, want_h)):
        for k, g in grads.items():
            close_gradients(k, g, ref[k], atol=3e-5)


def test_uda_eval_steps_match_jax():
    cfg = uda_config("dsec")
    cols = uda_batch(np.random.default_rng(1))
    batch = port_batch(cols)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(2))
    pmods = port_modules(cfg, state)
    label_a, label_b = cols["label_a"], cols["label_b"]

    want_a = jax.device_get(jax_uda.make_eval_step_a(mods)(state, {
        "image": jnp.asarray(cols["image_a"]),
        "label": jnp.asarray(label_a, jnp.int32)}))
    got_a = make_eval_step_a(pmods)(
        {"image": batch["image_a"], "label": batch["label_a"]})
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()
              if k.startswith("ev_")}
    jbatch["label"] = jnp.asarray(label_b, jnp.int32)
    want_b = jax.device_get(
        jax_uda.make_eval_step_b(mods, jax_pipeline())(state, jbatch))
    pbatch = {k: v for k, v in batch.items() if k.startswith("ev_")}
    pbatch["label"] = batch["label_b"]
    got_b = make_eval_step_b(pmods, port_pipeline())(pbatch)

    assert sorted(got_a) == sorted(want_a)
    assert sorted(got_b) == sorted(want_b)
    for got, want in ((got_a, want_a), (got_b, want_b)):
        for k, v in want.items():
            if k.endswith("_loss"):
                np.testing.assert_allclose(float(got[k]), float(v),
                                           rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["latent8"].numpy(),
                                   np.moveaxis(want["latent8"], -1, 1),
                                   atol=1e-4)
    np.testing.assert_allclose(got_b["img_fake"].numpy(),
                               np.moveaxis(want_b["img_fake"], -1, 1),
                               atol=1e-4)

    # argmax and confusion matrices may differ only where the top-2 logit
    # gap is below 1e-4 (a valid pixel there moves at most two counts)
    with torch.inference_mode():
        logits_a = pmods.head(pmods.front_a(batch["image_a"]))[1]
        windows, _ = port_pipeline().build_all(pbatch)
        img_fake, _, latent_ev = pmods.recon_val.rollout(windows)
        logits_b = pmods.head(latent_ev)[1]
        logits_c = pmods.head(pmods.front_a(img_fake))[1]
    for logits, label, pred, pred_want, cm, cm_want in (
            (logits_a, label_a, got_a["pred"], want_a["pred"], got_a["cm_a"],
             want_a["cm_a"]),
            (logits_b, label_b, got_b["pred"], want_b["pred"], got_b["cm_b"],
             want_b["cm_b"]),
            (logits_c, label_b, None, None, got_b["cm_cycle"],
             want_b["cm_cycle"])):
        top2 = logits.topk(2, dim=1).values
        close = (top2[:, 0] - top2[:, 1] < 1e-4).numpy()
        if pred is not None:
            assert np.all((pred.numpy() == pred_want) | close)
        assert float(cm.sum()) == float((label != 255).sum())
        assert (np.abs(np.asarray(cm_want) - cm.numpy()).sum()
                <= 2 * (close & (label != 255)).sum())


def logits_labels(seed: int):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(2, 10, 14, CLASSES)) * 3).astype(np.float32)
    b = (rng.normal(size=(2, 10, 14, CLASSES)) * 3).astype(np.float32)
    label = rng.integers(0, CLASSES, (2, 10, 14))
    label[:, :2] = 255
    return a, b, label


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_(True)


@pytest.mark.parametrize("name", ["cross_entropy_loss", "dice_loss",
                                  "symmetric_js_divergence", "l1_loss"])
def test_losses_match_jax(name):
    """Value and gradient in both arguments (in the logits for the task
    losses) against the JAX functions."""
    a, b, label = logits_labels(7)
    if name in ("cross_entropy_loss", "dice_loss"):
        kw = {"ignore_label": 255}
        if name == "dice_loss":
            kw["num_classes"] = CLASSES
        jfn = lambda x, y: getattr(jax_losses, name)(x, jnp.asarray(label),
                                                     **kw)
        tfn = lambda x, y: getattr(losses, name)(x, torch.from_numpy(label),
                                                 **kw)
    else:
        jfn, tfn = getattr(jax_losses, name), getattr(losses, name)
    want, (ga_j, gb_j) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    at, bt = nchw(a), nchw(b)
    got = tfn(at, bt)
    ga, gb = torch.autograd.grad(got, (at, bt), allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, g_j in ((ga, ga_j), (gb, gb_j)):
        if g is None:
            assert not np.asarray(g_j).any()
            continue
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(g_j), atol=1e-6, rtol=1e-5)


def test_task_loss_is_the_sum_of_its_terms():
    a, _, label = logits_labels(8)
    x, lab = torch.from_numpy(a).permute(0, 3, 1, 2), torch.from_numpy(label)
    total = losses.task_loss(x, lab, num_classes=CLASSES)
    parts = (losses.dice_loss(x, lab, num_classes=CLASSES)
             + losses.cross_entropy_loss(x, lab))
    np.testing.assert_allclose(float(total), float(parts), rtol=1e-6)


def test_dsec_config_builds_the_front():
    """``configs/settings_DSEC.yaml`` (``model_name: 'ess'``) builds on the
    CPU with the image front at E2VID's widths, both optimizers and the
    440x640 rollouts; without a device and a GPU the builder raises."""
    cfg = load_config("configs/settings_DSEC.yaml")
    assert cfg.model.model_name == "ess"
    mods = build_modules(cfg, device="cpu")
    assert isinstance(mods.front_a, ResNet18Encoder)
    assert mods.front_a.conv1.weight.shape == (64, 1, 7, 7)
    assert mods.front_a.layer3[1].conv2.weight.shape == (256, 256, 3, 3)
    assert mods.front_a.dtype == torch.bfloat16
    assert mods.opt_front.param_groups[0]["lr"] == cfg.optim.lr_front
    assert (mods.recon_train.height, mods.recon_train.width) == (440, 640)
    assert (mods.recon_val.height, mods.recon_val.width) == (440, 640)
    init_params(mods, torch.Generator().manual_seed(0))
    bn = mods.front_a.layer2[0].downsample[1]
    assert torch.equal(bn.weight, torch.ones(128))
    assert torch.equal(bn.running_var, torch.ones(128))
    std = mods.front_a.conv1.weight.std().item()
    assert 0.8 / 7 < std < 1.2 / 7
    state = init_state(mods)
    assert state.front is mods.front_a and state.opt_front is mods.opt_front
    sup = build_modules(cfg.replace(model=dataclasses.replace(
        cfg.model, model_name="ess_supervised")), device="cpu")
    assert sup.front_a is None and init_state(sup).front is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_modules(cfg)
        with pytest.raises(RuntimeError):
            resolve_device()


def test_bench_uda_config():
    """The bench's UDA configuration (``bench_extra.py``'s DSEC UDA shape)
    builds on the CPU: 440x640 sensor A and rollouts, the int8 train cell,
    the exact eval cell, no augmentation, a 64-wide front in bf16."""
    cfg = bench.make_uda_cfg(2)
    assert cfg.model.model_name == "ess"
    assert not cfg.model.data_augmentation_train
    assert cfg.dataset.sensor_a.shape == (440, 640)
    assert cfg.optim.batch_size_a == cfg.optim.batch_size_b == 2
    mods = build_modules(cfg, device="cpu")
    assert mods.recon_train.lstm_impl == "pallas_int8"
    assert mods.recon_val.lstm_impl is None
    assert mods.e2vid.lstm_impl == "pallas"
    assert (mods.recon_train.height, mods.recon_train.width) == (440, 640)
    assert mods.front_a.conv1.weight.shape == (64, 1, 7, 7)
    assert mods.front_a.dtype == torch.bfloat16
    assert not bench.make_pipeline().cfg.random_flip
