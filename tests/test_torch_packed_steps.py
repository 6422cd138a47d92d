"""The steps, streaming and the train CLI on the packed u16 wire, against
the JAX package.

Packed batches come from the native packed ingests (``ingest`` of
tests/test_torch_packed_wire.py: seeded events, a jittered rectify map),
on the folded wire (B1's records) and on the tile wire (B3's events). Both
packages decode them where they lie and voxelize with the time taken as
normalized; the JAX side runs its Pallas kernels in interpret mode with f32
tent planes, the port its plain versions on CPU tensors, with the weights
carried across by ``params_from_jax``. The bounds are those of the f32-wire
test of each function:

- the supervised eval step (``tiny_config``, 48x256, B=2, T=3): loss rtol
  1e-4, ``latent8`` and ``img_fake`` atol 1e-4, the argmax equal where the
  top-2 logit gap is at least 1e-4 (tests/test_torch_eval_step.py);
- the supervised train step on the exact cell, three steps with JAX's flip
  draws: losses rtol 1e-4, the head's parameters atol 1e-5
  (tests/test_torch_train_step.py);
- the UDA train step (DSEC routing, 24x128, B=2, T=2, the folded wire) and
  its eval step B:
  every loss rtol 1e-4, the implied gradients within 5 % of the largest
  plus 3e-5, batch-norm statistics atol 1e-5; eval ``latent8`` and
  ``img_fake`` atol 1e-4 (tests/test_torch_uda.py);
- ``run_streaming_eval`` over seven packed windows with two scored and a
  reset mid stream: the final state within 1e-4
  (tests/test_torch_streaming.py); the confusion matrix may move 8 of the
  24576 scored pixels, where the f32-wire test finds it equal: on the
  packed tile wire one pixel is a near-tie that the two summation orders
  of the grid's normalization settle apart (none on the folded wire).

The train CLI on a packed DSEC YAML is in tests/test_torch_packed_wire.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.train import supervised as jax_sup
from ess_tpu.train import uda as jax_uda
from ess_tpu.train import streaming as jax_streaming
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data import loader
from ess_tpu_torch.data.pipeline import AugmentParams, to_soa
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.train import streaming as port_streaming
from ess_tpu_torch.train import supervised as sup
from ess_tpu_torch.train import uda
from ess_tpu_torch.train.builder import build_modules, init_state
from tests import test_torch_uda as tu
from tests.test_torch_eval_step import port_config
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread
from tests.test_torch_packed_wire import ingest
from tests.test_torch_streaming import (assert_states_close, build_both,
                                        capture_final_state)
from tests.test_torch_train_step import (B, CLASSES, H, T, W, jax_flips,
                                         jax_pipeline, slice_config)

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

WIRES = ("folded", "tile")


def packed_batch(wire, seed, *, b=B, t_dim=T, n=1500, h=H, w=W):
    """A collated packed batch (numpy, offsets renamed by ``to_soa``) and a
    label with ignored rows."""
    samples = [ingest(wire, seed + i, t_dim, n, h, w)[0] for i in range(b)]
    batch = to_soa(loader._collate(samples))
    label = np.random.default_rng(seed).integers(0, CLASSES, (b, h, w))
    label[:, :3] = 255
    batch["label"] = label
    return batch


def torch_batch(cols):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in cols.items()}


def jax_batch(cols):
    out = {k: jnp.asarray(v) for k, v in cols.items()}
    for k in ("label", "label_a", "label_b"):
        if k in out:
            out[k] = out[k].astype(jnp.int32)
    return out


def port_modules(cfg, state):
    mods = build_modules(port_config(cfg), device="cpu")
    sd_e, sd_h = params_from_jax(jax.device_get(state.e2vid_params),
                                 jax.device_get(state.back_params))
    mods.e2vid.load_state_dict(sd_e)
    mods.head.load_state_dict(sd_h)
    return mods


def port_pipeline(**kw):
    from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
    return EventPipeline(PipelineConfig(sensor_height=H, sensor_width=W,
                                        num_bins=5, trilinear=True,
                                        normalize=True, **kw))


@pytest.mark.parametrize("wire", WIRES)
def test_eval_step_packed_matches_jax(wire):
    cfg = slice_config(None)
    cols = packed_batch(wire, 0)
    assert "ev_xq" in cols and "ev_x" not in cols
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    want = jax.device_get(jax_sup.make_eval_step(mods, jax_pipeline(False))(
        state, jax_batch(cols)))
    pmods = port_modules(cfg, state)
    pipe = port_pipeline()
    batch = torch_batch(cols)
    got = sup.make_eval_step(pmods, pipe)(batch)

    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    for k in ("latent8", "img_fake"):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.moveaxis(want[k], -1, 1), atol=1e-4,
                                   err_msg=k)
    with torch.inference_mode():
        windows, _ = pipe.build_all(batch)
        logits = pmods.head(pmods.recon_val.rollout(windows)[2])[1]
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] >= 1e-4).numpy()
    np.testing.assert_array_equal(got["pred"].numpy()[clear],
                                  np.asarray(want["pred"])[clear])
    assert float(got["cm"].sum()) == float((cols["label"] != 255).sum())


def argmax_agreement(pred, pred_ref, logits_ref):
    """% of all pixels with the reference's argmax and % of those whose
    top-2 logit gap in the reference exceeds 0.1 (chip_smoke.py's
    SLICE_GAP)."""
    top2 = np.sort(logits_ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 0.1
    same = np.asarray(pred) == np.asarray(pred_ref)
    return 100.0 * same.mean(), 100.0 * same[clear].mean()


@pytest.mark.parametrize("wire", WIRES)
def test_packed_vs_f32_agreement_matches_jax(wire):
    """The packed wire's argmax against the f32 wire's, on the same events,
    is the same in both packages: quantization moves the JAX package's
    clear-gap pixels as it moves the port's (at this size JAX reads 99.85 %
    on the folded wire, 97.69 % on the tile wire). The clear-gap agreement
    is equal, the all-pixel one within 0.05 percentage points (near ties
    that settle apart between the packages)."""
    cfg = slice_config(None)
    samples = [ingest(wire, i, T, 1500, H, W) for i in range(B)]
    label = np.random.default_rng(0).integers(0, CLASSES, (B, H, W))
    cols = []
    for wire_samples in zip(*samples):
        c = to_soa(loader._collate(list(wire_samples)))
        c["label"] = label
        cols.append(c)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    jstep = jax_sup.make_eval_step(mods, jax_pipeline(False))
    pmods = port_modules(cfg, state)
    pipe = port_pipeline()
    pstep = sup.make_eval_step(pmods, pipe)
    want = [np.asarray(jax.device_get(jstep(state, jax_batch(c)))["pred"])
            for c in cols]
    got = [pstep(torch_batch(c))["pred"].numpy() for c in cols]
    with torch.inference_mode():
        windows, _ = pipe.build_all(torch_batch(cols[1]))
        logits = pmods.head(pmods.recon_val.rollout(windows)[2])[1].numpy()
    jax_all, jax_clear = argmax_agreement(want[0], want[1], logits)
    port_all, port_clear = argmax_agreement(got[0], got[1], logits)
    assert port_clear == jax_clear < 100.0
    assert abs(port_all - jax_all) <= 0.05


def test_train_step_packed_matches_jax():
    """Three steps on the packed folded wire, exact train cell, with the
    flips JAX draws."""
    cfg = slice_config(None)
    cols = packed_batch("folded", 10)
    jpipe = jax_pipeline(flip=True)
    flips = [jax_flips(cfg, jpipe, s) for s in range(3)]
    assert any(f.any() for f in flips)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_modules(cfg, state)
    jstep = jax_sup.make_train_step(mods, jpipe)
    want = []
    for _ in range(3):
        state, out = jstep(state, jax_batch(cols))
        want.append(float(out["loss"]))
    _, want_head = params_from_jax(jax.device_get(state.e2vid_params),
                                   jax.device_get(state.back_params))

    pstate = init_state(pmods)
    step = sup.make_train_step(pmods, port_pipeline(random_flip=True))
    batch = torch_batch(cols)
    got = [float(step(pstate, batch, AugmentParams(
        flip=torch.from_numpy(f.copy())))["loss"]) for f in flips]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for k, v in pmods.head.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_head[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def uda_cols(wire):
    cols = packed_batch(wire, 20, b=tu.B, t_dim=tu.T, n=tu.N, h=tu.H,
                        w=tu.W)
    rng = np.random.default_rng(21)
    labels = rng.integers(0, tu.CLASSES, (tu.B, tu.H, tu.W))
    labels[:, :3] = 255
    cols["label_b"] = cols.pop("label")
    cols["label_a"] = labels
    cols["image_a"] = rng.normal(size=(tu.B, tu.H, tu.W, 1)).astype(
        np.float32)
    return cols


def test_uda_train_step_packed_matches_jax():
    """The DSEC UDA step on the packed folded wire (the DSEC default)."""
    cfg = tu.uda_config("dsec")
    cols = uda_cols("folded")
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = tu.port_modules(cfg, state)
    new_state, want = jax.device_get(jax_uda.make_train_step(
        mods, tu.jax_pipeline())(state, jax_batch(cols)))
    want_front = front_from_jax(new_state.front_params,
                                new_state.front_batch_stats)
    _, want_head = params_from_jax(new_state.e2vid_params,
                                   new_state.back_params)

    front0 = {k: v.clone() for k, v in pmods.front_a.state_dict().items()}
    head0 = {k: v.clone() for k, v in pmods.head.state_dict().items()}
    got = uda.make_train_step(pmods, tu.port_pipeline())(
        init_state(pmods), tu.port_batch(cols))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    for module, before, after in ((pmods.front_a, front0, want_front),
                                  (pmods.head, head0, want_head)):
        for k, v in module.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), after[k].numpy(),
                                           atol=1e-5, rtol=0, err_msg=k)
            elif not k.endswith("num_batches_tracked"):
                tu.close_gradients(k, (before[k] - v) / tu.LR,
                                   (before[k] - after[k]) / tu.LR, atol=3e-5)


def test_uda_eval_step_b_packed_matches_jax():
    cfg = tu.uda_config("dsec")
    cols = uda_cols("folded")
    cols = {k: v for k, v in cols.items() if k.startswith("ev_")}
    cols["label"] = uda_cols("folded")["label_b"]
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    want = jax.device_get(jax_uda.make_eval_step_b(mods, tu.jax_pipeline())(
        state, jax_batch(cols)))
    got = uda.make_eval_step_b(tu.port_modules(cfg, state),
                               tu.port_pipeline())(torch_batch(cols))
    for k, v in want.items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                       err_msg=k)
    for k in ("latent8", "img_fake"):
        np.testing.assert_allclose(got[k].numpy(), np.moveaxis(want[k], -1, 1),
                                   atol=1e-4, err_msg=k)


def packed_stream(wire, h, w, n, n_windows=7, resets=(0, 4)):
    """Single-window packed samples as ``SequenceRecurrent`` yields them,
    a label every third window."""
    rng = np.random.default_rng(30)
    out = []
    for i in range(n_windows):
        pk, _ = ingest(wire, 40 + i, 1, n, h, w)
        out.append(dict(pk, is_first=np.bool_(i in resets),
                        has_label=np.bool_(i % 3 == 2),
                        label=rng.integers(0, CLASSES, (h, w)).astype(
                            np.int32)))
    return out


@pytest.mark.parametrize("wire", WIRES)
def test_run_streaming_eval_packed_matches_jax(wire, monkeypatch):
    (jmods, jstate, jpipe), (mods, pipe) = build_both(H, W, True)
    stream = packed_stream(wire, H, W, 900)
    seen_j = capture_final_state(monkeypatch, jax_streaming)
    want = jax_streaming.run_streaming_eval(jmods, jstate, iter(stream),
                                            jpipe)
    seen_p = capture_final_state(monkeypatch, port_streaming)
    got = port_streaming.run_streaming_eval(mods, iter(stream), pipe)
    assert_states_close(seen_p["state"], jax.device_get(seen_j["state"]))
    assert got.confusion.sum() == want.confusion.sum() == 2 * H * W
    moved = np.abs(got.confusion - want.confusion).sum() / 2
    assert moved <= 8, moved


@pytest.mark.parametrize("wire", WIRES)
def test_streaming_steps_take_either_wire(wire):
    """One pair of steps, built before any window is seen, takes packed and
    f32 windows alike: a packed window scores as its decoded columns do,
    bit for bit, and the f32 window of the same events scores too, its
    state within 15 % of the largest state value of the packed window's
    (the quantization of coordinates to 1/64 px moves the tiny model's
    state by 1.5 % on the folded wire, 9.3 % on the tile wire)."""
    _, (mods, pipe) = build_both(H, W, True)
    encode, score = port_streaming.make_streaming_steps(mods, pipe)
    pk, f32 = ingest(wire, 40, 1, 900, H, W)
    to_batch = lambda cols: {
        k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[None]))
        for k, v in to_soa(dict(cols, is_first=np.bool_(True),
                                label=np.zeros((H, W), np.int32))).items()}
    packed = to_batch(pk)
    state0 = encode(mods.recon_val.init_state(1, "cpu"), packed)
    got = [score(state0, b) for b in
           (packed, pipe.decode_packed(packed), to_batch(f32))]
    (packed_state, packed_cm), (dec_state, dec_cm), (f32_state, _) = got
    for level_p, level_d, level_f in zip(packed_state, dec_state, f32_state):
        for p, d, f in zip(level_p, level_d, level_f):
            assert torch.equal(p, d)
            assert (f - p).abs().max() <= 0.15 * p.abs().max()
    assert torch.equal(packed_cm, dec_cm)
