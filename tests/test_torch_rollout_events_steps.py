"""The supervised, eval and UDA steps with ``precompute=False`` (each
window voxelized just before its step) against JAX's ``_rollout(...,
precompute=False)`` (its steps patched to pass it) and against the port's
precomputed steps on the same batch and draws (split from
tests/test_torch_rollout_events.py, whose batches these tests use).

``tiny_config`` (base 8, 6 classes, f32) at a 48x256 sensor, B=2, T=3,
with the weights carried over by ``params_from_jax``; the JAX side runs
its Pallas voxelizers and cells in interpret mode. Bounds: the eval step
(loss rtol 1e-4, ``latent8`` and ``img_fake`` atol 1e-4, the argmax equal
where the top-2 logit gap is at least 1e-4), the supervised train step on
the exact cell with JAX's flip draws over three steps (losses rtol 1e-4,
head parameters atol 1e-5: ``tests/test_torch_train_step.py``) and the
UDA train step on the DSEC routing (every loss rtol 1e-4, the implied
gradients within 5 % of the largest plus 3e-5, batch-norm statistics atol
1e-5: ``tests/test_torch_uda.py``), on the folded wire and, for the eval
step, the packed tile wire.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ess_tpu.train import supervised as jax_sup
from ess_tpu.train import uda as jax_uda
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data.pipeline import AugmentParams
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.train import supervised as sup
from ess_tpu_torch.train import uda
from ess_tpu_torch.train.builder import init_state
from tests import test_torch_uda as tu
from tests.test_torch_eval_step import folded_batch
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread
from tests.test_torch_packed_steps import (
    jax_batch, port_modules, port_pipeline, torch_batch)
from tests.test_torch_rollout_events import wire_batch
from tests.test_torch_train_step import jax_flips, jax_pipeline, slice_config

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

STEPS = 3

def in_loop(module, monkeypatch):
    """JAX's steps of ``module`` with ``_rollout(precompute=False)``."""
    monkeypatch.setattr(module, "_rollout", functools.partial(
        jax_sup._rollout, precompute=False))


@pytest.mark.parametrize("wire", ["band", "packed_tile"])
def test_in_loop_eval_step_matches_jax(wire, monkeypatch):
    cfg = slice_config(None)
    cols = wire_batch(wire, 1)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    in_loop(jax_sup, monkeypatch)
    want = jax.device_get(jax_sup.make_eval_step(mods, jax_pipeline(False))(
        state, jax_batch(cols)))
    pmods = port_modules(cfg, state)
    pipe = port_pipeline()
    batch = torch_batch(cols)
    got = sup.make_eval_step(pmods, pipe, precompute=False)(batch)
    pre = sup.make_eval_step(pmods, pipe)(batch)

    for ref, tol in ((want, 1e-4), (jax.device_get(pre), 1e-5)):
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                                   rtol=tol)
        for k in ("latent8", "img_fake"):
            r = np.asarray(ref[k])
            if ref is want:
                r = np.moveaxis(r, -1, 1)
            np.testing.assert_allclose(got[k].numpy(), r, atol=tol, rtol=0,
                                       err_msg=k)
    with torch.inference_mode():
        windows, _ = pipe.build_all(batch)
        logits = pmods.head(pmods.recon_val.rollout(windows)[2])[1]
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] >= 1e-4).numpy()
    np.testing.assert_array_equal(got["pred"].numpy()[clear],
                                  np.asarray(want["pred"])[clear])
    np.testing.assert_array_equal(got["pred"].numpy()[clear],
                                  pre["pred"].numpy()[clear])
    assert float(got["cm"].sum()) == float((cols["label"] != 255).sum())


def test_in_loop_train_step_matches_jax(monkeypatch):
    cfg = slice_config(None)
    cols = folded_batch(np.random.default_rng(2))
    jpipe = jax_pipeline(flip=True)
    flips = [jax_flips(cfg, jpipe, s) for s in range(STEPS)]
    assert any(f.any() for f in flips) and not all(f.all() for f in flips)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_modules(cfg, state)
    pmods2 = port_modules(cfg, state)
    in_loop(jax_sup, monkeypatch)
    jstep = jax_sup.make_train_step(mods, jpipe)
    jbatch = jax_batch(cols)
    want = []
    for _ in range(STEPS):
        state, out = jstep(state, jbatch)
        want.append(float(out["loss"]))
    _, want_head = params_from_jax(jax.device_get(state.e2vid_params),
                                   jax.device_get(state.back_params))

    pipe = port_pipeline(random_flip=True)
    batch = torch_batch(cols)
    augs = [AugmentParams(flip=torch.from_numpy(f.copy())) for f in flips]
    runs = []
    for m, precompute in ((pmods, False), (pmods2, True)):
        st = init_state(m)
        step = sup.make_train_step(m, pipe, precompute=precompute)
        runs.append([float(step(st, batch, augs[s])["loss"])
                     for s in range(STEPS)])
    np.testing.assert_allclose(runs[0], want, rtol=1e-4)
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)
    heads = (pmods2.head.state_dict(), want_head)
    for k, v in pmods.head.state_dict().items():
        for ref in heads:
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)


def test_in_loop_uda_train_step_matches_jax(monkeypatch):
    cfg = tu.uda_config("dsec")
    cols = tu.uda_batch(np.random.default_rng(0))
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    # the port's modules first: the JAX step donates its state
    port_mods = {pre: tu.port_modules(cfg, state) for pre in (False, True)}
    in_loop(jax_uda, monkeypatch)
    new_state, want = jax.device_get(jax_uda.make_train_step(
        mods, tu.jax_pipeline())(state, jax_batch(cols)))
    want_front = front_from_jax(new_state.front_params,
                                new_state.front_batch_stats)
    _, want_head = params_from_jax(new_state.e2vid_params,
                                   new_state.back_params)

    batch = tu.port_batch(cols)
    got = {}
    for precompute in (False, True):
        pmods = port_mods[precompute]
        head0 = {k: v.clone() for k, v in pmods.head.state_dict().items()}
        front0 = {k: v.clone() for k, v in pmods.front_a.state_dict().items()}
        losses = uda.make_train_step(pmods, tu.port_pipeline(),
                                     precompute=precompute)(
            init_state(pmods), batch)
        got[precompute] = (losses, pmods)
    losses, pmods = got[False]
    assert sorted(losses) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(float(losses[k]),
                                   float(got[True][0][k]), rtol=1e-5,
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
