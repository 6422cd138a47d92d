"""The train slice: the port's supervised train step against JAX
``make_train_step``, and its pieces (loss gradients, flip augmentation).

The slice runs ``tiny_config`` (base 8, 6 classes, f32, lr_back 1e-3) at a
48x256 sensor, B=2, T=3, on a host-folded ``x_slots=True`` batch with the
flip augmentation on, for three steps; the port runs its plain versions on
CPU with the JAX weights (``params_from_jax``) and receives the flip bits
that JAX draws from ``fold_in(PRNGKey(seed), step)``. It is parametrised
over the train rollout's cell:

- exact (``lstm_impl_train=None``): the JAX step runs on the same folded
  batch, its voxelizer and ConvLSTM kernels in interpret mode;
- int8 (``'pallas_int8_interpret'`` in both packages: the int8 cell at
  every shape, these being below the size rule of ``'pallas_int8'``): the
  JAX step runs on the windows the port's pipeline built (flipped) and the
  flipped labels, as a dense batch. Int8 rounding is discontinuous: the
  two voxelizers differ by f32 noise (up to 1.4e-4 in the normalized grid,
  whose nonzero standardization sums in another order), which moves some
  quantized activations by one step and the loss by up to 6e-4 relative.
  The voxelizer and the flip are held against JAX by the exact case and
  ``test_flip_matches_jax_build_all``.

``test_train_step_block_conv_matches_jax`` runs the int8 case with the
rollout's block convs (head and first encoder) on the int8 conv too: JAX
``block_conv_impl='pallas_int8_interpret'`` beside the int8 cell, the port
``with_block_conv_impl(mods, 'pallas', 'pallas_int8_interpret')`` (plain
versions on CPU), under the same bounds.

Bounds:
- per-step loss rtol 1e-4; head parameters atol 1e-5 after three RAdam
  steps; E2VID parameters bit-identical (frozen in both);
- ``task_loss`` gradients vs ``jax.grad``: atol 1e-6, rtol 1e-5 (same f32
  math, other summation orders);
- flip: windows atol 2e-3 / rtol 1e-4 (the f32 voxelizer bound of
  tests/test_torch_voxel.py) against JAX ``build_all``, exactly the
  unflipped windows mirrored, and labels exact, with the same draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import AugmentParams as JaxAugment
from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state
from ess_tpu.train.losses import task_loss as jax_loss

from ess_tpu_torch.data.pipeline import (AugmentParams, EventPipeline,
                                         PipelineConfig)
from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.train.builder import (build_modules, init_state,
                                         with_block_conv_impl)
from ess_tpu_torch.train.losses import task_loss
from ess_tpu_torch.train.supervised import make_train_step
from tests.test_torch_eval_step import (B, CLASSES, H, T, W, folded_batch,
                                        jax_with_block_conv, port_config)
from tests.test_train_steps import tiny_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


STEPS = 3


def jax_pipeline(flip: bool) -> JaxPipeline:
    return JaxPipeline(JaxPipelineConfig(
        sensor_height=H, sensor_width=W, num_bins=5, trilinear=True,
        normalize=True, use_pallas=True, pallas_interpret=True,
        voxel_oh_dtype="float32", random_flip=flip))


def jax_flips(cfg, pipe, step: int) -> np.ndarray:
    """The flip bits JAX's train step draws at ``step``."""
    rng = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step)
    return np.asarray(pipe.sample_augment(rng, B, train=True).flip)


def slice_config(lstm_impl_train):
    cfg = tiny_config()
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset, sensor_b=dataclasses.replace(
                cfg.dataset.sensor_b, shape=(H, W), nr_events_data=T)),
        model=dataclasses.replace(cfg.model, lstm_impl="pallas_interpret",
                                  lstm_impl_train=lstm_impl_train))


@pytest.mark.parametrize("lstm_impl_train", ["pallas_int8_interpret", None])
def test_train_step_matches_jax(lstm_impl_train):
    check_train_step(lstm_impl_train)


def test_train_step_block_conv_matches_jax():
    check_train_step("pallas_int8_interpret",
                     block_conv_train="pallas_int8_interpret")


def check_train_step(lstm_impl_train, block_conv_train=None):
    cfg = slice_config(lstm_impl_train)
    cols = folded_batch(np.random.default_rng(0))
    jpipe = jax_pipeline(flip=True)
    flips = [jax_flips(cfg, jpipe, s) for s in range(STEPS)]
    assert any(f.any() for f in flips) and not all(f.all() for f in flips)

    pipe = EventPipeline(PipelineConfig(sensor_height=H, sensor_width=W,
                                        num_bins=5, trilinear=True,
                                        normalize=True, random_flip=True))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    augs = [AugmentParams(flip=torch.from_numpy(f.copy())) for f in flips]

    mods = jax_build(cfg)
    if block_conv_train is not None:
        mods = jax_with_block_conv(mods, "pallas_interpret",
                                   block_conv_train)
        assert mods.recon_train.model.lstm_impl == "pallas_int8_interpret"
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    e2vid0, head0 = (jax.device_get(state.e2vid_params),
                     jax.device_get(state.back_params))
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()}
    jbatch["label"] = jbatch["label"].astype(jnp.int32)
    jstep = jax_sup.make_train_step(mods, jpipe)
    want = []
    for s in range(STEPS):
        if lstm_impl_train is not None:
            windows, label = pipe.build_all(batch, aug=augs[s])
            jbatch = {"events": jnp.asarray(windows.permute(1, 0, 3, 4, 2)
                                            .numpy()),
                      "label": jnp.asarray(label.numpy(), jnp.int32)}
        state, out = jstep(state, jbatch)
        want.append(float(out["loss"]))
    want_e2vid, want_head = params_from_jax(
        jax.device_get(state.e2vid_params), jax.device_get(state.back_params))

    pcfg = port_config(cfg)
    pmods = build_modules(pcfg, device="cpu")
    assert pmods.recon_train.lstm_impl == (
        "pallas" if lstm_impl_train is None else "pallas_int8_interpret")
    if block_conv_train is not None:
        pmods = with_block_conv_impl(pmods, "pallas", block_conv_train)
        assert pmods.recon_train.block_conv_impl == block_conv_train
        assert pmods.recon_val.block_conv_impl == "pallas"
        assert pmods.recon_train.model is pmods.e2vid
    sd_e, sd_h = params_from_jax(e2vid0, head0)
    pmods.e2vid.load_state_dict(sd_e)
    pmods.head.load_state_dict(sd_h)
    pstate = init_state(pmods)
    step = make_train_step(pmods, pipe)
    got = []
    for s in range(STEPS):
        out = step(pstate, batch, augs[s])
        assert float(out["semseg_sensor_b_loss"]) == float(out["loss"])
        got.append(float(out["loss"]))
    assert pstate.step == STEPS and pmods.opt_back.step_count == STEPS

    np.testing.assert_allclose(got, want, rtol=1e-4)
    for k, v in pmods.head.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_head[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
        assert not torch.equal(v, sd_h[k]) or k.endswith("bias"), k
    for k, v in pmods.e2vid.state_dict().items():
        assert torch.equal(v, want_e2vid[k]) and torch.equal(v, sd_e[k]), k
        assert not pmods.e2vid.get_parameter(k).requires_grad


def test_train_step_samples_its_own_flips():
    """Without explicit draws the step samples flips from a generator seeded
    by ``cfg.seed`` and the step: the same state and batch give the same
    loss, and the draws differ across steps."""
    cfg = port_config(slice_config(None))
    cols = folded_batch(np.random.default_rng(1))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    pipe = EventPipeline(PipelineConfig(sensor_height=H, sensor_width=W,
                                        num_bins=5, trilinear=True,
                                        normalize=True, random_flip=True))
    losses = []
    for _ in range(2):
        mods = build_modules(cfg, device="cpu")
        torch.manual_seed(0)
        for p in list(mods.e2vid.parameters()) + list(mods.head.parameters()):
            p.data.normal_(0, 0.1)
        losses.append(float(make_train_step(mods, pipe)(init_state(mods),
                                                        batch)["loss"]))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    draws = [pipe.sample_augment(torch.Generator().manual_seed(s), 64,
                                 train=True).flip for s in range(2)]
    assert not torch.equal(*draws) and 0.25 < draws[0].float().mean() < 0.75
    assert pipe.sample_augment(torch.Generator(), 4, train=False).flip is None


@pytest.mark.parametrize("losses", [("dice", "cross_entropy"), ("dice",),
                                    ("cross_entropy",)])
def test_task_loss_gradients_match_jax(losses):
    rng = np.random.default_rng(21)
    logits = (rng.normal(size=(2, 10, 14, CLASSES)) * 3).astype(np.float32)
    label = rng.integers(0, CLASSES, (2, 10, 14))
    label[:, :2] = 255
    label[1, :, -3:] = 255
    kw = dict(num_classes=CLASSES, ignore_label=255, losses=losses)
    val_j, g_j = jax.value_and_grad(
        lambda lg: jax_loss(lg, jnp.asarray(label), **kw))(
            jnp.asarray(logits))
    lt = torch.from_numpy(logits).permute(0, 3, 1, 2).requires_grad_(True)
    val = task_loss(lt, torch.from_numpy(label), **kw)
    (g,) = torch.autograd.grad(val, lt)
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(g_j),
                               atol=1e-6, rtol=1e-5)


def test_flip_matches_jax_build_all():
    cols = folded_batch(np.random.default_rng(2))
    jpipe = jax_pipeline(flip=True)
    rng = jax.random.PRNGKey(3)
    flip = np.asarray(jpipe.sample_augment(rng, B, train=True).flip)
    assert flip.any() and not flip.all()
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()}
    grids_j, label_j = jpipe.build_all(jbatch, rng, train=True)

    pipe = EventPipeline(PipelineConfig(sensor_height=H, sensor_width=W,
                                        num_bins=5, trilinear=True,
                                        normalize=True, random_flip=True))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    aug = AugmentParams(flip=torch.from_numpy(flip))
    windows, label = pipe.build_all(batch, aug=aug)
    np.testing.assert_allclose(windows.permute(1, 0, 3, 4, 2).numpy(),
                               np.asarray(grids_j), atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(label.numpy(), np.asarray(label_j))
    np.testing.assert_array_equal(
        pipe.apply_label_transform(torch.from_numpy(cols["label"]),
                                   aug).numpy(),
        np.asarray(jpipe.apply_label_transform(
            jnp.asarray(cols["label"]), JaxAugment(flip=jnp.asarray(flip)))))
    unflipped, _ = pipe.build_all(batch)
    for b in range(B):
        want = unflipped[:, b].flip(-1) if flip[b] else unflipped[:, b]
        assert torch.equal(windows[:, b], want)
