"""The YAML's model and event options through the port's steps, against the
JAX package's.

Each option changes one key of ``tiny_config`` (base 8, 6 classes, f32) at
a 32x32 sensor, B=2, T=2, on raw events (the tile wire without offsets,
which JAX voxelizes with its XLA scatter and the port with B3's plain
version): ``event_representation`` ``'histogram'`` and ``'ev_segnet'``,
``e2vid_recurrent_block: 'convgru'``, ``e2vid_norm: 'IN'``,
``skip_connect_task: False`` and ``skip_connect_task_type: 'sum'``. Both
packages start from the JAX weights (``params_from_jax``,
``front_from_jax``).

- The supervised train step and the UDA train step, the JAX step on the
  windows the port's pipeline built (a dense batch: the windows are held
  against JAX's by ``tests/test_torch_representations.py`` and by the
  eval step below; the seeded backbone's latent is small, std ~1e-3, and
  the head's gradient at it moves by up to a few % for a 2e-5 relative
  change of it): every loss rtol 1e-4, and the gradients each step hands
  its optimizer (captured by patching the steps' ``apply_updates``), per
  parameter tensor within 1e-4 of the tensor's largest JAX gradient plus
  1e-7 plus, for the supervised head, twice the port's own f32 error
  there (its f32 gradient against the same head's in f64 at the same
  latent: 1e-3 relative at the histogram's seed, 3e-6 at the others). A
  conv bias before an instance norm (all the head's but the logits') has
  a zero gradient in exact math: both packages' values are rounding,
  held under IN_BIAS_NOISE (``tests/test_torch_uda.py``'s allowance for
  them). The UDA front is held within GRAD_FRONT (1e-3) instead: at these
  tiny shapes a few ReLU inputs of the image front lie within f32
  rounding of 0 and switch differently in the two packages
  (``tests/test_torch_uda.py``; 1.3e-4 read here).
- The supervised eval step on raw events (each package's voxelizer):
  loss rtol 1e-4, ``latent8`` within 1e-4 of its largest value,
  ``img_fake`` atol 1e-4.
- Streaming: three windows through ``make_streaming_steps`` (encode,
  encode with one stream starting a new sequence, score) on raw events:
  the carried state (one tensor a level for the GRU) atol 1e-4, and the
  confusion matrix with the same total, at most STREAM_MOVED of the
  scored pixels in another cell (an argmax at a near tie can flip:
  ``ev_segnet``'s latent differs by 2e-5 of its largest value, its time
  deviation channels summing in another order; one pixel read).
- ``e2vid_norm: 'BN'``: the JAX package builds it but its rollout raises
  (its batch norms read a ``batch_stats`` collection ``init_state`` does
  not keep); the port raises when it builds.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ScopeCollectionNotFound

from ess_tpu.train import streaming as jax_streaming
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train import uda as jax_uda
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state
from ess_tpu.train.builder import make_pipeline as jax_make_pipeline

from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.train import streaming, supervised, uda
from ess_tpu_torch.train.builder import (build_modules, init_state,
                                         make_pipeline)
from ess_tpu_torch.train.losses import task_loss
from tests.test_torch_eval_step import port_config
from tests.test_torch_loop import one_torch_thread
from tests.test_train_steps import tiny_config

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

B, T, N, H, W, CLASSES = 2, 2, 1200, 32, 32, 6
LOSS_RTOL = 1e-4
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
IN_BIAS_NOISE = 3e-5
STREAM_MOVED = 0.0025
GRAD_FRONT = 1e-3
OPTIONS = {
    "histogram": ("dataset", dict(event_representation="histogram")),
    "ev_segnet": ("dataset", dict(event_representation="ev_segnet")),
    "convgru": ("model", dict(e2vid_recurrent_block="convgru")),
    "IN": ("model", dict(e2vid_norm="IN")),
    "plain_head": ("model", dict(skip_connect_task=False)),
    "sum_skips": ("model", dict(skip_connect_task_type="sum")),
}


def option_config(option, model_name="ess_supervised"):
    cfg = tiny_config(model_name)
    ds = cfg.dataset
    cfg = cfg.replace(dataset=dataclasses.replace(
        ds, sensor_a=dataclasses.replace(ds.sensor_a, shape=(H, W)),
        sensor_b=dataclasses.replace(ds.sensor_b, shape=(H, W),
                                     nr_events_data=T)))
    where, kw = OPTIONS[option]
    if where == "dataset":
        return cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, sensor_b=dataclasses.replace(cfg.dataset.sensor_b,
                                                      **kw)))
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def raw_batch(rng):
    """Raw events (float coordinates in the frame, a tenth invalid),
    labels with ignored rows, and a sensor-A image batch (NHWC)."""
    cols = {"ev_x": rng.uniform(0, W - 1, (B, T, N)),
            "ev_y": rng.uniform(0, H - 1, (B, T, N)),
            "ev_t": np.sort(rng.uniform(0, 1e4, (B, T, N)), -1),
            "ev_p": rng.integers(0, 2, (B, T, N))}
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    cols["ev_valid"] = rng.random((B, T, N)) > 0.1
    labels = rng.integers(0, CLASSES, (2, B, H, W)).astype(np.int32)
    labels[:, :, :3] = 255
    cols.update(label=labels[0], label_a=labels[1],
                image_a=rng.normal(size=(B, H, W, 1)).astype(np.float32))
    return cols


def port_batch(cols):
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    batch["image_a"] = batch["image_a"].permute(0, 3, 1, 2)
    return batch


def both_modules(cfg):
    """(JAX modules, JAX state, the port's modules with its weights)."""
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = build_modules(port_config(cfg), device="cpu")
    sd_e, sd_h = params_from_jax(jax.device_get(state.e2vid_params),
                                 jax.device_get(state.back_params))
    pmods.e2vid.load_state_dict(sd_e)
    pmods.head.load_state_dict(sd_h)
    if pmods.front_a is not None:
        pmods.front_a.load_state_dict(front_from_jax(
            jax.device_get(state.front_params),
            jax.device_get(state.front_batch_stats)))
    return mods, state, pmods


def dense_batch(cfg, cols):
    """JAX's dense batch of the windows the port's train pipeline builds
    from ``cols`` (``{"events": (B, T, H, W, C), "label"}``)."""
    with torch.no_grad():
        windows, label = make_pipeline(port_config(cfg), train=True
                                       ).build_all(port_batch(cols))
    return {"events": jnp.asarray(windows.permute(1, 0, 3, 4, 2).numpy()),
            "label": jnp.asarray(label.numpy())}


def captured_updates(monkeypatch, module):
    """Patch ``module.apply_updates`` to record each (params, grads) and
    update nothing."""
    calls = []
    monkeypatch.setattr(module, "apply_updates",
                        lambda params, grads, *a: calls.append(
                            (list(params), list(grads))))
    return calls


def jax_gradient_state(monkeypatch, module):
    """Patch the JAX step module's ``apply_updates`` so that the new state
    holds the gradients in place of the parameters."""
    monkeypatch.setattr(module, "apply_updates",
                        lambda params, grads, opt, opt_state: (grads,
                                                               opt_state))


def named(module, call):
    names = {id(p): k for k, p in module.named_parameters()}
    params, grads = call
    return {names[id(p)]: g for p, g in zip(params, grads)}


def close_gradients(got, want, rel=GRAD_REL, f32_error=None):
    """Each of ``got`` within ``rel`` of ``want``'s largest magnitude plus
    GRAD_ATOL plus twice ``f32_error[name]``; conv biases before an
    instance norm both under IN_BIAS_NOISE."""
    assert set(got) <= set(want)
    for k, g in got.items():
        w = want[k]
        if k.startswith("decoder_scale_") and k.endswith(".bias") \
                and not k.startswith("decoder_scale_5."):
            noise = max(float(g.abs().max()), float(w.abs().max()))
            assert noise <= IN_BIAS_NOISE, (k, noise)
            continue
        err = float((g - w).abs().max())
        bound = rel * float(w.abs().max()) + GRAD_ATOL
        if f32_error is not None:
            bound += 2 * f32_error[k]
        assert err <= bound, (k, err, bound)


def head_f32_error(pmods, cfg, batch):
    """Per head parameter, max |f32 gradient - f64 gradient| of the
    supervised task loss at the latent the train step rolls out."""
    with torch.no_grad():
        windows, labels = make_pipeline(port_config(cfg), train=True
                                        ).build_all(batch)
        _, _, latent = pmods.recon_train.rollout(windows, decode=False)

    def grads(head, latent):
        loss = task_loss(head(latent)[1], labels, num_classes=CLASSES,
                         ignore_label=255, losses=cfg.optim.task_loss)
        names, params = zip(*head.named_parameters())
        return dict(zip(names, torch.autograd.grad(loss, params)))

    head64 = copy.deepcopy(pmods.head).double()
    head64.dtype = torch.float64
    g32 = grads(pmods.head, latent)
    g64 = grads(head64, {k: v.double() for k, v in latent.items()})
    return {k: float((g32[k].double() - g64[k]).abs().max()) for k in g32}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_supervised_steps_match_jax(monkeypatch, option):
    cfg = option_config(option)
    cols = raw_batch(np.random.default_rng(0))
    mods, state, pmods = both_modules(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()}
    ev_want = jax.device_get(jax_sup.make_eval_step(
        mods, jax_make_pipeline(cfg, train=False))(state, jbatch))
    jax_gradient_state(monkeypatch, jax_sup)
    grad_state, out = jax.device_get(jax_sup.make_train_step(mods)(
        state, dense_batch(cfg, cols)))
    _, want = params_from_jax(grad_state.e2vid_params,
                              grad_state.back_params)

    pcfg = port_config(cfg)
    batch = port_batch(cols)
    calls = captured_updates(monkeypatch, supervised)
    got = supervised.make_train_step(
        pmods, make_pipeline(pcfg, train=True))(init_state(pmods), batch)
    np.testing.assert_allclose(float(got["loss"]), float(out["loss"]),
                               rtol=LOSS_RTOL)
    assert len(calls) == 1
    close_gradients(named(pmods.head, calls[0]), want,
                    f32_error=head_f32_error(pmods, cfg, batch))

    ev = supervised.make_eval_step(pmods, make_pipeline(pcfg, train=False))(
        batch)
    np.testing.assert_allclose(float(ev["loss"]), float(ev_want["loss"]),
                               rtol=LOSS_RTOL)
    l8 = np.moveaxis(ev_want["latent8"], -1, 1)
    np.testing.assert_allclose(ev["latent8"].numpy(), l8,
                               atol=1e-4 * np.abs(l8).max())
    np.testing.assert_allclose(ev["img_fake"].numpy(),
                               np.moveaxis(ev_want["img_fake"], -1, 1),
                               atol=1e-4)


@pytest.mark.parametrize("option", ["histogram", "ev_segnet", "convgru",
                                    "IN", "plain_head"])
def test_uda_train_step_matches_jax(monkeypatch, option):
    cfg = option_config(option, "ess")
    cols = raw_batch(np.random.default_rng(1))
    mods, state, pmods = both_modules(cfg)
    jbatch = dense_batch(cfg, cols)
    jbatch["events_b"] = jbatch.pop("events")
    jbatch["label_b"] = jbatch.pop("label")
    jbatch.update({k: jnp.asarray(cols[k]) for k in ("image_a", "label_a")})
    jax_gradient_state(monkeypatch, jax_uda)
    grad_state, want = jax.device_get(jax_uda.make_train_step(mods)(
        state, jbatch))
    _, want_head = params_from_jax(grad_state.e2vid_params,
                                   grad_state.back_params)
    want_front = front_from_jax(grad_state.front_params,
                                grad_state.front_batch_stats)

    batch = port_batch(cols)
    batch["label_b"] = batch.pop("label")
    calls = captured_updates(monkeypatch, uda)
    got = uda.make_train_step(
        pmods, make_pipeline(port_config(cfg), train=True))(
            init_state(pmods), batch)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    front, head = calls
    close_gradients(named(pmods.head, head), want_head)
    close_gradients(named(pmods.front_a, front), want_front, GRAD_FRONT)


def windows(rng, n_windows):
    """Single-window batches of raw events, ``is_first`` set for both
    streams at window 0 and for stream 1 at window 1."""
    out = []
    for i in range(n_windows):
        cols = raw_batch(rng)
        w = {k: cols[k][:, 0] for k in ("ev_x", "ev_y", "ev_t", "ev_p",
                                        "ev_valid")}
        w["is_first"] = np.array([i == 0, i <= 1])
        w["label"] = cols["label"]
        out.append(w)
    return out


@pytest.mark.parametrize("option", list(OPTIONS))
def test_streaming_matches_jax(option):
    cfg = option_config(option)
    mods, state, pmods = both_modules(cfg)
    enc_j, score_j = jax_streaming.make_streaming_steps(
        mods, jax_make_pipeline(cfg, train=False))
    enc_p, score_p = streaming.make_streaming_steps(
        pmods, make_pipeline(port_config(cfg), train=False))
    st_j = mods.recon_val.init_state(B)
    st_p = pmods.recon_val.init_state(B, "cpu")
    ws = windows(np.random.default_rng(2), 3)
    for i, w in enumerate(ws):
        jw = {k: jnp.asarray(v) for k, v in w.items()}
        pw = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in w.items()}
        if i < len(ws) - 1:
            jw.pop("label")
            st_j = enc_j(state, st_j, jw)
            st_p = enc_p(st_p, pw)
        else:
            st_j, cm_j = score_j(state, st_j, jw)
            st_p, cm_p = score_p(st_p, pw)
    flat_p = [t for s in st_p for t in (s if isinstance(s, tuple) else (s,))]
    flat_j = jax.tree_util.tree_leaves(jax.device_get(st_j))
    assert len(flat_p) == len(flat_j) == (
        3 if option == "convgru" else 6)
    for p, j in zip(flat_p, flat_j):
        np.testing.assert_allclose(p.numpy(), np.moveaxis(j, -1, 1),
                                   atol=1e-4)
    cm_p, cm_j = cm_p.numpy(), np.asarray(cm_j)
    assert cm_p.sum() == cm_j.sum() > 0
    assert np.abs(cm_p - cm_j).sum() / 2 <= STREAM_MOVED * cm_j.sum()


def test_batch_norm_raises_in_both_packages():
    cfg = tiny_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, e2vid_norm="BN"))
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    with pytest.raises(ScopeCollectionNotFound):
        mods.recon_val.rollout(state.e2vid_params,
                               jnp.zeros((1, 2, 16, 16, 5)))
    with pytest.raises(ValueError, match="'BN'"):
        build_modules(port_config(cfg), device="cpu")
