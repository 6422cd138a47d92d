"""The supervised and the UDA train step with each of the voxelizer's
opt-in pins against the JAX package's steps (split from
tests/test_torch_voxel_pins.py, whose builds, pipelines and bounds these
tests use).

Bounds: the supervised train step (two steps, JAX's flips) and the UDA
train step with each pin, against JAX's steps on the same weights: the
bounds of tests/test_torch_rollout_events.py (losses rtol 1e-4, head
parameters atol 1e-5; UDA gradients within 5 % of the largest plus 3e-5,
batch-norm statistics atol 1e-5); the stack and raw forms' train losses
and head updates equal the standard build's bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train import uda as jax_uda
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data.pipeline import AugmentParams, EventPipeline
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.ops import voxel_folded as vf
from ess_tpu_torch.train import supervised as sup
from ess_tpu_torch.train import uda
from ess_tpu_torch.train.builder import init_state
from tests import test_torch_uda as tu
from tests.test_torch_eval_step import folded_batch
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread
from tests.test_torch_packed_steps import (jax_batch, port_modules,
                                           torch_batch)
from tests.test_torch_train_step import jax_flips, slice_config
from tests.test_torch_voxel_pins import PINS, dsec_pipelines

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

STEPS = 2


@pytest.mark.parametrize("pin", sorted(PINS))
def test_train_step_with_pin_matches_jax(pin):
    cfg = slice_config(None)
    cols = folded_batch(np.random.default_rng(11))
    jpipe, pipe = dsec_pipelines(pin, crop=0)
    flips = [jax_flips(cfg, jpipe, s) for s in range(STEPS)]
    assert any(f.any() for f in flips)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_modules(cfg, state)
    pmods_std = port_modules(cfg, state)
    jstep = jax_sup.make_train_step(mods, jpipe)
    jbatch = jax_batch(cols)
    want = []
    for _ in range(STEPS):
        state, out = jstep(state, jbatch)
        want.append(float(out["loss"]))
    _, want_head = params_from_jax(jax.device_get(state.e2vid_params),
                                   jax.device_get(state.back_params))

    batch = torch_batch(cols)
    augs = [AugmentParams(flip=torch.from_numpy(f.copy())) for f in flips]
    form = sup.rollout_form(pmods.recon_train, batch, pipe, train=True)
    assert form == (pin if pin != "int8" else "standard")
    std_pipe = EventPipeline(dataclasses.replace(
        pipe.cfg, stack_windows=None, raw_windows=None))
    runs = []
    for m, p in ((pmods, pipe), (pmods_std, std_pipe)):
        st = init_state(m)
        step = sup.make_train_step(m, p)
        runs.append([float(step(st, batch, augs[s])["loss"])
                     for s in range(STEPS)])
    np.testing.assert_allclose(runs[0], want, rtol=1e-4)
    for k, v in pmods.head.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_head[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    if pin != "int8":
        # the stack and raw forms are the standard build, bit for bit
        assert runs[0] == runs[1]
        for k, v in pmods.head.state_dict().items():
            assert torch.equal(v, pmods_std.head.state_dict()[k]), k


UDA_W = 256     # two x-slots, so the stack build serves the UDA step


def uda_cols(rng):
    """tests/test_torch_uda.py's UDA batch at 24 x UDA_W."""
    b, t, n, h = tu.B, tu.T, tu.N, tu.H
    raw = np.zeros((b, t, n, 4), np.float32)
    raw[..., 0] = rng.uniform(0, UDA_W - 1, (b, t, n))
    raw[..., 1] = rng.uniform(0, h - 1, (b, t, n))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (b, t, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (b, t, n))
    valid = np.ones((b, t, n), bool)
    valid[..., n - n // 10:] = False
    rs, vs_, os_ = zip(*(vf.host_band_bin_folded(
        raw[i], valid[i], height=h, width=UDA_W, bins=5, x_slots=True)
        for i in range(b)))
    rs, vs_, os_ = np.stack(rs), np.stack(vs_), np.stack(os_)
    labels = rng.integers(0, tu.CLASSES, (2, b, h, UDA_W)).astype(np.int64)
    labels[:, :, :3] = 255
    return {"ev_x": rs[..., 0], "ev_y": rs[..., 1], "ev_t": rs[..., 2],
            "ev_p": rs[..., 3], "ev_valid": vs_, "ev_band_offsets": os_,
            "label_b": labels[0], "label_a": labels[1],
            "image_a": rng.normal(size=(b, h, UDA_W, 1)).astype(np.float32)}


@pytest.mark.parametrize("pin", sorted(PINS))
def test_uda_train_step_with_pin_matches_jax(pin):
    cfg = tu.uda_config("dsec")
    shape = (tu.H, UDA_W)
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset,
        sensor_a=dataclasses.replace(cfg.dataset.sensor_a, shape=shape),
        sensor_b=dataclasses.replace(cfg.dataset.sensor_b, shape=shape)))
    cols = uda_cols(np.random.default_rng(0))
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = tu.port_modules(cfg, state)
    oh = PINS[pin].get("voxel_oh_dtype", "float32")
    pins = {k: v for k, v in PINS[pin].items() if k != "voxel_oh_dtype"}
    geo = dict(sensor_width=UDA_W, voxel_oh_dtype=oh, **pins)
    jpipe = JaxPipeline(dataclasses.replace(tu.jax_pipeline().cfg, **geo))
    pipe = EventPipeline(dataclasses.replace(tu.port_pipeline().cfg, **geo))
    new_state, want = jax.device_get(jax_uda.make_train_step(mods, jpipe)(
        state, jax_batch(cols)))
    want_front = front_from_jax(new_state.front_params,
                                new_state.front_batch_stats)
    _, want_head = params_from_jax(new_state.e2vid_params,
                                   new_state.back_params)
    batch = tu.port_batch(cols)
    b_batch = {k: v for k, v in batch.items() if k.startswith("ev_")}
    assert sup.rollout_form(pmods.recon_train, b_batch, pipe,
                            train=True) == (pin if pin != "int8"
                                            else "standard")
    head0 = {k: v.clone() for k, v in pmods.head.state_dict().items()}
    front0 = {k: v.clone() for k, v in pmods.front_a.state_dict().items()}
    losses = uda.make_train_step(pmods, pipe)(init_state(pmods), batch)
    assert sorted(losses) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    for module, before, after in ((pmods.front_a, front0, want_front),
                                  (pmods.head, head0, want_head)):
        for k, v in module.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), after[k].numpy(),
                                           atol=1e-5, rtol=0, err_msg=k)
            else:
                tu.close_gradients(k, (before[k] - v) / tu.LR,
                                   (before[k] - after[k]) / tu.LR, atol=3e-5)
