"""The int8 cell's drift in a carried rollout (the train rollout's default
cell, ``lstm_impl_train='pallas_int8'``) against the exact cell, in both
packages, through ``rollout_events``.

E2VID at its published width (base 32, three ConvLSTM levels) on a
128x160 sensor, f32, seeded weights (``init_state`` of the JAX package,
carried across by ``params_from_jax``), B=1, 60 carried windows of 20k
synthetic events (moving bars and background noise, 1/64-pixel lattice
coordinates, window-relative times) through the trilinear voxelizer with
per-window normalization. Each window goes through ``rollout_events`` on
its own with the state carried in (``init_state``), once on the exact
cell and once on the int8 cell: JAX ``'pallas_interpret'`` and
``'pallas_int8_interpret'`` (at 128x160 the input is below the int8 size
rule, ``ops/conv_lstm.py::int8_size_rule``, so ``'pallas_int8'`` would
compute the exact cell), the port ``'pallas'`` and
``'pallas_int8_interpret'`` on their plain versions. The drift of a
window is max |h_int8 - h_exact| over the three levels' hidden states
after it (and the same for c).

- The JAX side runs all 60 windows (~10 s here). The two packages' exact
  states agree within 1e-4 at every window (the streaming test's bound,
  ``tests/test_torch_streaming.py``; they read ~3e-6). Their int8 cells
  are held against each other window by window: the int8 states within
  INT8_H / INT8_C (read: 0.0019 / 0.0034 at most; int8 rounding is
  discontinuous, and the two formulations round a few values apart), and
  the drifts within DRIFT_AGREE of JAX's (read: 4.5 % at most).
- The port's drift stays below H_BOUND (h) and C_BOUND (c) over all 60
  windows (read: 0.0394 / 0.0621 at most, JAX's 0.0394 / 0.0616; the
  drift does not grow with the windows, it stays within 0.019-0.040).
  ``chip_smoke.py`` phase 10 reads the same drift on the H100 at
  440x640, B=8, on B2 and B2-int8 (recorded in PERF.md).
- Two faults planted in the port's int8 cell in a scratch copy each fail
  this file: the weights quantized with one per-tensor scale instead of
  one per output column (int8 states 0.0074-0.025 from JAX's: INT8_H;
  the drift itself barely moves, 0.0407, as the seeded columns have
  like norms), and x's scale kept from the first window of each level
  (drift 0.0745 / 0.114: H_BOUND, C_BOUND; states 0.025-0.046 from
  JAX's).

``tests/test_torch_conv_lstm_int8.py::test_int8_20_step_rollout_drift``
holds a single 20-step cell at a test size; this file holds the whole
carried rollout.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import AugmentParams as JaxAugment
from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data.pipeline import (AugmentParams, EventPipeline,
                                         PipelineConfig)
from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.train.builder import build_modules
from tests.test_torch_eval_step import port_config
from tests.test_torch_loop import one_torch_thread
from tests.test_train_steps import tiny_config

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

H, W, BASE, WINDOWS, N = 128, 160, 32, 60, 20_000
H_BOUND = 0.055        # max |h_int8 - h_exact| over the levels, a window
C_BOUND = 0.09
INT8_H = 0.005         # the two packages' int8 states, a window
INT8_C = 0.01
DRIFT_AGREE = 0.2      # |port - JAX| over JAX's drift, a window


def drift_events(seed: int, b: int, t_dim: int, n: int, h: int, w: int):
    """(B, T, N) event columns: 80 % on the leading (positive) and trailing
    (negative) edges of four bars moving across the frame, 20 % uniform
    noise; coordinates on the 1/64 lattice inside the frame, sorted
    window-relative times."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, h - 40, 4), rng.uniform(0, w - 40, 4),
                      rng.uniform(16, 40, 4), rng.uniform(16, 40, 4),
                      rng.uniform(-2, 2, 4), rng.uniform(-1, 1, 4)], 1)
    shape = (b, t_dim, n)
    tau = np.sort(rng.uniform(0, 1, shape), -1)
    box = boxes[rng.integers(0, 4, shape)]
    lead = rng.integers(0, 2, shape)
    step = np.arange(t_dim)[None, :, None] + tau
    x = box[..., 1] + box[..., 3] * lead + box[..., 4] * step
    y = box[..., 0] + rng.uniform(0, 1, shape) * box[..., 2] \
        + box[..., 5] * step
    noise = rng.uniform(0, 1, shape) < 0.2
    x = np.where(noise, rng.uniform(0, w, shape), np.mod(x, w))
    y = np.where(noise, rng.uniform(0, h, shape), np.mod(y, h))
    lattice = lambda v, hi: np.clip(np.round(v * 64) / 64, 0, hi - 1)
    p = np.where(noise, rng.integers(0, 2, shape), lead)
    return {"ev_x": lattice(x, w).astype(np.float32),
            "ev_y": lattice(y, h).astype(np.float32),
            "ev_t": (tau * 1e4).astype(np.float32),
            "ev_p": p.astype(np.float32),
            "ev_valid": np.ones(shape, bool)}


def drift_config():
    cfg = tiny_config()
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, sensor_b=dataclasses.replace(
            cfg.dataset.sensor_b, shape=(H, W), nr_events_data=WINDOWS)),
        model=dataclasses.replace(
            cfg.model, e2vid_base_channels=BASE,
            lstm_impl="pallas_interpret",
            lstm_impl_train="pallas_int8_interpret"))


def carried(rollout, soa, t_dim, init):
    """The recurrent state after each window: ``rollout(window_soa,
    state) -> state`` on each one-window slice in turn."""
    state, out = init, []
    for i in range(t_dim):
        state = rollout({k: v[:, i:i + 1] for k, v in soa.items()}, state)
        out.append(state)
    return out


def to_np(states, nhwc: bool):
    """Per window, the (h, c) of each level as NCHW numpy arrays."""
    fix = (lambda a: np.moveaxis(np.asarray(a), -1, 1)) if nhwc else (
        lambda a: a.numpy())
    return [[(fix(h), fix(c)) for h, c in st] for st in states]


def drift(a, b):
    """(max |dh|, max |dc|) over the levels of one window's states."""
    return (max(float(np.abs(ha - hb).max()) for (ha, _), (hb, _)
                in zip(a, b)),
            max(float(np.abs(ca - cb).max()) for (_, ca), (_, cb)
                in zip(a, b)))


@pytest.fixture(scope="module")
def runs():
    cfg = drift_config()
    cols = drift_events(0, 1, WINDOWS, N, H, W)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    geo = dict(sensor_height=H, sensor_width=W, num_bins=5, trilinear=True,
               normalize=True)
    # coordinates lie inside the frame, where JAX's scatter voxelizer and
    # the kernels agree
    jfn = JaxPipeline(JaxPipelineConfig(use_pallas=False, **geo)
                      ).make_window_fn(JaxAugment())
    jsoa = {k: jax.numpy.asarray(v) for k, v in cols.items()}
    out = {}
    for name, recon in (("jax_exact", mods.recon_val),
                        ("jax_int8", mods.recon_train)):
        step = jax.jit(lambda p, s, st, r=recon: r.rollout_events(
            p, s, jfn, st)[1])
        out[name] = to_np(carried(
            lambda s, st: step(state.e2vid_params, s, st), jsoa, WINDOWS,
            recon.init_state(1)), True)

    pmods = build_modules(port_config(cfg), device="cpu")
    sd_e, _ = params_from_jax(jax.device_get(state.e2vid_params),
                              jax.device_get(state.back_params))
    pmods.e2vid.load_state_dict(sd_e)
    assert pmods.recon_val.lstm_impl is None
    assert pmods.e2vid.lstm_impl == "pallas"
    assert pmods.recon_train.lstm_impl == "pallas_int8_interpret"
    fn = EventPipeline(PipelineConfig(**geo)).make_window_fn(AugmentParams())
    soa = {k: torch.from_numpy(v) for k, v in cols.items()}
    with torch.no_grad():
        for name, recon in (("exact", pmods.recon_val),
                            ("int8", pmods.recon_train)):
            out[name] = to_np(carried(
                lambda s, st, r=recon: r.rollout_events(
                    s, fn, st, decode=False)[1],
                soa, WINDOWS, recon.init_state(1, "cpu")), False)
        # one rollout over all windows carries the same state
        whole = pmods.recon_train.rollout_events(soa, fn, decode=False)[1]
    out["whole_int8"] = to_np([whole], False)[0]
    return out


def test_exact_states_match_jax(runs):
    for i, (got, want) in enumerate(zip(runs["exact"], runs["jax_exact"])):
        for (hp, cp), (hj, cj) in zip(got, want):
            np.testing.assert_allclose(hp, hj, atol=1e-4, rtol=0,
                                       err_msg=f"h, window {i}")
            np.testing.assert_allclose(cp, cj, atol=1e-4, rtol=0,
                                       err_msg=f"c, window {i}")


def test_int8_drift_matches_jax(runs):
    for i in range(WINDOWS):
        dh, dc = drift(runs["int8"][i], runs["jax_int8"][i])
        assert dh <= INT8_H and dc <= INT8_C, (i, dh, dc)
        got = drift(runs["int8"][i], runs["exact"][i])
        want = drift(runs["jax_int8"][i], runs["jax_exact"][i])
        for g, w_ in zip(got, want):
            assert w_ > 0, f"window {i}: JAX's int8 cell computed exactly"
            assert abs(g - w_) <= DRIFT_AGREE * w_, (i, got, want)


def test_int8_drift_bound_over_60_windows(runs):
    drifts = [drift(a, b) for a, b in zip(runs["int8"], runs["exact"])]
    print("int8 drift per window (max |dh|, max |dc|):",
          [(round(h, 4), round(c, 4)) for h, c in drifts])
    for i, (dh, dc) in enumerate(drifts):
        assert dh > 0, f"window {i}: the int8 cell computed exactly"
        assert dh <= H_BOUND and dc <= C_BOUND, (i, dh, dc)
    for (h1, c1), (h2, c2) in zip(runs["whole_int8"], runs["int8"][-1]):
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_array_equal(c1, c2)
