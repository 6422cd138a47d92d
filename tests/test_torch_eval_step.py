"""The whole eval slice: the port's eval step against JAX ``make_eval_step``.

``tiny_config`` (base 8, 6 classes) in f32 at a 48x256 sensor (2 bands x
2 x-slots, so JAX runs its slotted voxelizer kernel), B=2, T=3, on a
host-folded ``x_slots=True`` batch. The JAX side runs both Pallas kernels
in interpret mode (voxelizer with f32 tent planes, ConvLSTM cell); the port
runs its plain versions on CPU with the same weights (``params_from_jax``).

Bounds: loss rtol 1e-4, ``latent8`` and ``img_fake`` atol 1e-4 (same f32
math, other summation orders); predictions and the confusion matrix agree
except at pixels whose top-2 logit gap is below 1e-4, where the argmax may
flip.

Both packages roll out in block space by default, their block convs on the
library conv. ``test_eval_step_block_conv_matches_jax`` holds the other
forms under the same bounds: the JAX step with its Pallas block conv in
interpret mode against the port with ``block_conv_impl='pallas'`` (plain
version on CPU), and the port's standard 5x5 layout (``block_space=False``)
against the JAX default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.ops.resize import resize_nearest as jax_resize
from ess_tpu.ops.voxel_pallas import host_band_bin_folded
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state
from ess_tpu.train.losses import task_loss as jax_loss
from ess_tpu.train.metrics import confusion_matrix as jax_cm

from ess_tpu_torch.core import config as tcfg
from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.ops.resize import resize_nearest
from ess_tpu_torch.train.builder import build_modules, with_block_conv_impl
from ess_tpu_torch.train.losses import task_loss
from ess_tpu_torch.train.metrics import confusion_matrix
from ess_tpu_torch.train.supervised import make_eval_step
from tests.test_train_steps import tiny_config
from tests.test_torch_host_bin import use_private_jax_native


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


# the JAX side loads its own copy of the native library (test_torch_host_bin)
_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

B, T, N, H, W, CLASSES = 2, 3, 1500, 48, 256, 6


def folded_batch(rng):
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
    label = rng.integers(0, CLASSES, (B, H, W)).astype(np.int64)
    label[:, :4] = 255                                  # ignored rows
    return {"ev_x": rs[..., 0], "ev_y": rs[..., 1], "ev_t": rs[..., 2],
            "ev_p": rs[..., 3], "ev_valid": vs, "ev_band_offsets": os_,
            "label": label}


def port_config(cfg):
    """The same Config through the port's dataclasses. The JAX package's
    CPU-test name ``'pallas_interpret'`` becomes the port's ``'pallas'``: a
    port cell runs its plain version on CPU tensors by itself.
    ``'pallas_int8_interpret'`` stays: in both packages it is the int8 cell
    at every shape, below the size rule of ``'pallas_int8'`` too."""
    def conv(obj, cls):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name in ("lstm_impl", "lstm_impl_train") and \
                    v == "pallas_interpret":
                v = "pallas"
            kw[f.name] = (conv(v, getattr(tcfg, type(v).__name__))
                          if dataclasses.is_dataclass(v) else v)
        return cls(**kw)
    return conv(cfg, tcfg.Config)


def jax_with_block_conv(mods, impl, impl_train=None):
    """The JAX modules with the rollouts' models cloned onto
    ``block_conv_impl`` (``e2vid.clone``), over the same parameter tree."""
    impl_train = impl if impl_train is None else impl_train
    return dataclasses.replace(
        mods,
        recon_val=dataclasses.replace(
            mods.recon_val,
            model=mods.recon_val.model.clone(block_conv_impl=impl)),
        recon_train=dataclasses.replace(
            mods.recon_train,
            model=mods.recon_train.model.clone(block_conv_impl=impl_train)))


def test_eval_step_matches_jax():
    check_eval_step()


@pytest.mark.parametrize("form", ["pallas", "standard_layout"])
def test_eval_step_block_conv_matches_jax(form):
    check_eval_step(form)


def check_eval_step(form="block_xla"):
    cfg = tiny_config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset, sensor_b=dataclasses.replace(
                cfg.dataset.sensor_b, shape=(H, W), nr_events_data=T)),
        model=dataclasses.replace(cfg.model, lstm_impl="pallas_interpret"))
    cols = folded_batch(np.random.default_rng(0))

    mods = jax_build(cfg)
    assert mods.recon_val.block_space
    if form == "pallas":
        mods = jax_with_block_conv(mods, "pallas_interpret")
    state = init_state(mods, jax.random.PRNGKey(0))
    jpipe = JaxPipeline(JaxPipelineConfig(
        sensor_height=H, sensor_width=W, num_bins=5, trilinear=True,
        normalize=True, use_pallas=True, pallas_interpret=True,
        voxel_oh_dtype="float32"))
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()}
    jbatch["label"] = jbatch["label"].astype(jnp.int32)
    want = jax.device_get(jax_sup.make_eval_step(mods, jpipe)(state, jbatch))

    pmods = build_modules(port_config(cfg), device="cpu")
    assert pmods.recon_val.block_space
    assert pmods.recon_val.block_conv_impl is None
    assert pmods.e2vid.block_conv_impl == "xla"
    if form == "pallas":
        pmods = with_block_conv_impl(pmods, "pallas")
        assert pmods.recon_val.block_conv_impl == "pallas"
    elif form == "standard_layout":
        pmods = dataclasses.replace(pmods, recon_val=dataclasses.replace(
            pmods.recon_val, block_space=False))
    sd_e, sd_h = params_from_jax(jax.device_get(state.e2vid_params),
                                 jax.device_get(state.back_params))
    pmods.e2vid.load_state_dict(sd_e)
    pmods.head.load_state_dict(sd_h)
    pipe = EventPipeline(PipelineConfig(sensor_height=H, sensor_width=W,
                                        num_bins=5, trilinear=True,
                                        normalize=True))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    got = make_eval_step(pmods, pipe)(batch)

    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["latent8"].numpy(),
                               np.moveaxis(want["latent8"], -1, 1), atol=1e-4)
    np.testing.assert_allclose(got["img_fake"].numpy(),
                               np.moveaxis(want["img_fake"], -1, 1),
                               atol=1e-4)

    # argmax may flip only where the top-2 logit gap is below 1e-4
    with torch.inference_mode():
        windows, _ = pipe.build_all(batch)
        _, _, latent = pmods.recon_val.rollout(windows)
        logits = pmods.head(latent)[1]
    top2 = logits.topk(2, dim=1).values
    close = (top2[:, 0] - top2[:, 1] < 1e-4).numpy()
    pred_p, pred_j = got["pred"].numpy(), np.asarray(want["pred"])
    assert np.all((pred_p == pred_j) | close)
    label = cols["label"]
    assert float(got["cm"].sum()) == float((label != 255).sum())
    kw = dict(num_classes=CLASSES, ignore_label=255)
    delta = (np.asarray(jax_cm(jnp.asarray(np.where(close, pred_j, 0)),
                               jnp.asarray(np.where(close, label, 255)),
                               **kw))
             - confusion_matrix(torch.from_numpy(np.where(close, pred_p, 0)),
                                torch.from_numpy(np.where(close, label, 255)),
                                **kw).numpy())
    np.testing.assert_array_equal(np.asarray(want["cm"]) - got["cm"].numpy(),
                                  delta)


@pytest.mark.parametrize("losses", [("dice", "cross_entropy"), ("dice",),
                                    ("cross_entropy",)])
def test_loss_confusion_resize_match_jax(losses):
    """The step's pieces on their own: task loss (f32 math, rtol 1e-5),
    confusion matrix (exact counts) and nearest resize (exact gather)
    against the JAX functions, with ignored pixels."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(2, 12, 20, CLASSES)).astype(np.float32) * 3
    label = rng.integers(0, CLASSES, (2, 12, 20))
    label[:, :3] = 255
    kw = dict(num_classes=CLASSES, ignore_label=255, losses=losses)
    want = float(jax_loss(jnp.asarray(logits), jnp.asarray(label), **kw))
    got = float(task_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                          torch.from_numpy(label), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    pred = logits.argmax(-1)
    np.testing.assert_array_equal(
        confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label),
                         num_classes=CLASSES).numpy(),
        np.asarray(jax_cm(jnp.asarray(pred), jnp.asarray(label),
                          num_classes=CLASSES)))

    for h, w in ((24, 40), (7, 9), (5, 33)):
        np.testing.assert_array_equal(
            resize_nearest(torch.from_numpy(logits).permute(0, 3, 1, 2),
                           h, w).permute(0, 2, 3, 1).numpy(),
            np.asarray(jax_resize(jnp.asarray(logits), h, w)))
        np.testing.assert_array_equal(
            resize_nearest(torch.from_numpy(label), h, w).numpy(),
            np.asarray(jax_resize(jnp.asarray(label), h, w)))
