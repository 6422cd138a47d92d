"""The streaming-eval slice: the port against ``ess_tpu.train.streaming``.

``tiny_config`` (base 8, 6 classes) in f32, the same seeded weights carried
over by ``params_from_jax``, and the stream of tests/test_streaming.py (one
window per sample, a label every third window) with a second ``is_first``
reset mid stream, at a 16x16 and a 48x256 sensor, once per event wire:

- ``raw``: ``raw_events`` + ``valid``, no offsets (tile sort on the device);
- ``tile``: ``host_tile_bin`` events with ``tile_offsets``;
- ``band``: ``host_band_bin_folded`` records with ``band_offsets``.

The JAX side runs its Pallas voxelizers in interpret mode with f32 tent
planes (``use_pallas=True, pallas_interpret=True, voxel_oh_dtype=
'float32'``); the port runs its plain versions on CPU tensors. Coordinates
lie on a 1/64-pixel lattice (the resolution of the JAX package's packed
wire), so both formulations hold every tent position exactly and their
normalized grids share one zero pattern.

Both packages run the streaming steps in block space with the block convs
on the library conv; ``test_run_streaming_eval_block_conv_matches_jax``
holds, on the tile wire at 48x256, the JAX Pallas block conv in interpret
mode against the port's ``block_conv_impl='pallas'`` (plain version on CPU)
and the port's standard 5x5 layout against the JAX default.

Bounds: the final recurrent state within 1e-4 (same f32 math, other
summation orders), the confusion matrix identical. Also the B=2 step-level
case with one stream reset and one not, and the entry points' device rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.ops.voxel_pallas import host_band_bin_folded, host_tile_bin
from ess_tpu.train import metrics as jax_metrics
from ess_tpu.train import streaming as jax_streaming
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data.pipeline import (
    EventPipeline, PipelineConfig, to_soa)
from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.models.e2vid import zero_recurrent_state
from ess_tpu_torch.train import metrics
from ess_tpu_torch.train.builder import build_modules, with_block_conv_impl
from ess_tpu_torch.train import streaming as port_streaming
from ess_tpu_torch.train.streaming import make_streaming_steps
from tests.test_torch_eval_step import jax_with_block_conv, port_config
from tests.test_train_steps import tiny_config
from tests.test_torch_host_bin import use_private_jax_native


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


# the JAX side loads its own copy of the native library (test_torch_host_bin)
_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

CLASSES = 6
WIRES = ("raw", "tile", "band")
SENSORS = {"16x16": (16, 16, 128), "48x256": (48, 256, 900)}


def window(rng, i, h, w, n, trilinear):
    """One (N, 4) window of the stream: lattice coordinates (integers for
    the temporal-bilinear path), sorted times, random polarity."""
    if trilinear:
        x = rng.integers(0, (w - 1) * 64, n) / 64.0
        y = rng.integers(0, (h - 1) * 64, n) / 64.0
    else:
        x = rng.integers(0, w, n).astype(np.float64)
        y = rng.integers(0, h, n).astype(np.float64)
    t = np.sort(rng.uniform(i * 100, (i + 1) * 100, n))
    p = rng.integers(0, 2, n).astype(np.float64)
    return np.stack([x, y, t, p], 1).astype(np.float32)


def make_stream(seed, wire, h, w, n, trilinear, n_windows=7, label_every=3,
                resets=(0, 4)):
    """Samples as ``SequenceRecurrent`` yields them: (1, N, 4) raw events
    (a tenth of the capacity is padding), flags, a label."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_windows):
        raw = np.zeros((1, n + n // 10, 4), np.float32)
        raw[0, :n] = window(rng, i, h, w, n, trilinear)
        valid = np.zeros((1, n + n // 10), bool)
        valid[0, :n] = True
        sample = {"is_first": np.bool_(i in resets),
                  "has_label": np.bool_(i % label_every == label_every - 1),
                  "label": rng.integers(0, CLASSES, (h, w)).astype(np.int32)}
        if wire == "tile":
            raw, valid, offs = host_tile_bin(raw, valid, height=h, width=w)
            sample["tile_offsets"] = offs
        elif wire == "band":
            raw, valid, offs = host_band_bin_folded(
                raw, valid, height=h, width=w, trilinear=trilinear,
                x_slots=True)
            sample["band_offsets"] = offs
        sample["raw_events"], sample["valid"] = raw, valid
        out.append(sample)
    return out


def build_both(h, w, trilinear, form="block_xla"):
    cfg = tiny_config()
    cfg = cfg.replace(dataset=dataclasses.replace(
        cfg.dataset,
        sensor_a=dataclasses.replace(cfg.dataset.sensor_a, shape=(h, w)),
        sensor_b=dataclasses.replace(cfg.dataset.sensor_b, shape=(h, w),
                                     nr_events_data=1)))
    jmods = jax_build(cfg)
    if form == "pallas":
        jmods = jax_with_block_conv(jmods, "pallas_interpret")
    jstate = jax_init_state(jmods, jax.random.PRNGKey(0))
    geo = dict(sensor_height=h, sensor_width=w, num_bins=5, normalize=True,
               trilinear=trilinear)
    jpipe = JaxPipeline(JaxPipelineConfig(
        use_pallas=True, pallas_interpret=True, voxel_oh_dtype="float32",
        **geo))
    mods = build_modules(port_config(cfg), device="cpu")
    sd_e, sd_h = params_from_jax(jax.device_get(jstate.e2vid_params),
                                 jax.device_get(jstate.back_params))
    mods.e2vid.load_state_dict(sd_e)
    mods.head.load_state_dict(sd_h)
    if form == "pallas":
        mods = with_block_conv_impl(mods, "pallas")
    elif form == "standard_layout":
        mods = dataclasses.replace(mods, recon_val=dataclasses.replace(
            mods.recon_val, block_space=False))
    return (jmods, jstate, jpipe), (mods, EventPipeline(PipelineConfig(**geo)))


def capture_final_state(monkeypatch, module):
    """Record the recurrent state each streaming step returns."""
    seen = {}
    orig = module.make_streaming_steps

    def wrapped(*a, **k):
        enc, score = orig(*a, **k)

        def enc2(*args):
            seen["state"] = enc(*args)
            return seen["state"]

        def score2(*args):
            out = score(*args)
            seen["state"] = out[0]
            return out

        return enc2, score2

    monkeypatch.setattr(module, "make_streaming_steps", wrapped)
    return seen


def assert_states_close(got, want, atol=1e-4):
    assert len(got) == len(want) == 3
    for (h_p, c_p), (h_j, c_j) in zip(got, want):
        for p, j in ((h_p, h_j), (c_p, c_j)):
            np.testing.assert_allclose(
                p.numpy(), np.moveaxis(np.asarray(j), -1, 1), atol=atol,
                rtol=0)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("sensor", sorted(SENSORS))
def test_run_streaming_eval_matches_jax(sensor, wire, monkeypatch):
    h, w, n = SENSORS[sensor]
    # the folded wire is ported for trilinear streams; the small sensor runs
    # the temporal-bilinear path on the other two, as tests/test_streaming.py
    trilinear = wire == "band" or sensor == "48x256"
    (jmods, jstate, jpipe), (mods, pipe) = build_both(h, w, trilinear)
    stream = make_stream(1, wire, h, w, n, trilinear)
    assert sum(bool(s["has_label"]) for s in stream) == 2

    seen_j = capture_final_state(monkeypatch, jax_streaming)
    want = jax_streaming.run_streaming_eval(jmods, jstate, iter(stream),
                                            jpipe)
    seen_p = capture_final_state(monkeypatch, port_streaming)
    got = port_streaming.run_streaming_eval(mods, iter(stream), pipe)

    assert got.confusion.sum() == 2 * h * w
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert_states_close(seen_p["state"], jax.device_get(seen_j["state"]))
    s_p, s_j = got.summary(), want.summary()
    assert s_p["mean_iou"] == pytest.approx(s_j["mean_iou"])
    assert s_p["acc"] == pytest.approx(s_j["acc"])
    assert sorted(map(str, s_p)) == sorted(map(str, s_j))


@pytest.mark.parametrize("form", ["pallas", "standard_layout"])
def test_run_streaming_eval_block_conv_matches_jax(form, monkeypatch):
    h, w, n = SENSORS["48x256"]
    (jmods, jstate, jpipe), (mods, pipe) = build_both(h, w, True, form)
    assert mods.recon_val.block_space == (form == "pallas")
    stream = make_stream(5, "tile", h, w, n, True)

    seen_j = capture_final_state(monkeypatch, jax_streaming)
    want = jax_streaming.run_streaming_eval(jmods, jstate, iter(stream),
                                            jpipe)
    seen_p = capture_final_state(monkeypatch, port_streaming)
    got = port_streaming.run_streaming_eval(mods, iter(stream), pipe)

    assert got.confusion.sum() == 2 * h * w
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert_states_close(seen_p["state"], jax.device_get(seen_j["state"]))


def test_reconstructor_takes_space_to_depth_windows():
    """``step(events_s2d=True)`` takes the window already in 2x2 blocks and
    gives what the standard window gives; it needs a block-space rollout
    and the block geometry."""
    from ess_tpu_torch.ops.conv_s2d import space_to_depth

    h, w = 16, 32
    _, (mods, _) = build_both(h, w, False)
    recon = mods.recon_val
    x = torch.randn(2, 5, h, w, generator=torch.Generator().manual_seed(0))
    state = recon.init_state(2, "cpu")
    with torch.no_grad():
        img, st, lat = recon.step(x, state)
        img2, st2, lat2 = recon.step(space_to_depth(x), state,
                                     events_s2d=True)
        flat = dataclasses.replace(recon, block_space=False)
        img3, st3, _ = flat.step(x, state)
    assert torch.equal(img, img2) and sorted(lat) == sorted(lat2)
    torch.testing.assert_close(img3, img, atol=1e-5, rtol=0)
    for a, b, c in zip(st, st2, st3):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        torch.testing.assert_close(c[0], a[0], atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        recon.step(x, state, events_s2d=True)            # not in blocks
    with pytest.raises(ValueError):
        recon.step(space_to_depth(x), state)             # blocks, unflagged
    with pytest.raises(ValueError):
        flat.step(space_to_depth(x), state, events_s2d=True)


def test_wires_agree_with_each_other():
    """The three wires carry the same events: driven through the steps by
    hand, the port's confusion matrices are identical and its final states
    agree within 1e-4 across them (the folded wire pre-weights border events
    on the host in f64, and each voxelizer sums in its own order)."""
    h, w, n = SENSORS["48x256"]
    _, (mods, pipe) = build_both(h, w, True)
    enc, score = make_streaming_steps(mods, pipe)
    finals = []
    for wire in WIRES:
        state, cm = mods.recon_val.init_state(1, "cpu"), 0
        for sample in make_stream(2, wire, h, w, n, True):
            sample = to_soa(sample)
            batch = {k: torch.from_numpy(np.asarray(v)[None])
                     for k, v in sample.items()}
            if sample["has_label"]:
                state, cm_i = score(state, batch)
                cm = cm + cm_i
            else:
                state = enc(state, batch)
        finals.append((state, cm))
    for state, cm in finals[1:]:
        assert torch.equal(cm, finals[0][1])
        for hc, hc0 in zip(state, finals[0][0]):
            for t, t0 in zip(hc, hc0):
                torch.testing.assert_close(t, t0, atol=1e-4, rtol=0)


def soa_batch(rng, b, h, w, n, first, label):
    raw = np.stack([window(rng, 0, h, w, n, False) for _ in range(b)])
    out = {"ev_x": raw[..., 0], "ev_y": raw[..., 1], "ev_t": raw[..., 2],
           "ev_p": raw[..., 3], "ev_valid": np.ones((b, n), bool),
           "is_first": np.asarray(first)}
    if label:
        out["label"] = rng.integers(0, CLASSES, (b, h, w)).astype(np.int32)
    return out


def test_two_streams_one_reset():
    """B=2 at the step level: stream 0 restarts at window 2, stream 1 runs
    on. Both packages give the same state and confusion matrix, stream 0's
    state equals a fresh stream's, and the caller's state is left intact."""
    h, w, n = 16, 16, 128
    (jmods, jstate, jpipe), (mods, pipe) = build_both(h, w, False)
    rng = np.random.default_rng(3)
    batches = [soa_batch(rng, 2, h, w, n, [True, True], False),
               soa_batch(rng, 2, h, w, n, [False, False], False),
               soa_batch(rng, 2, h, w, n, [True, False], True)]

    jenc, jscore = jax_streaming.make_streaming_steps(jmods, jpipe)
    js = jmods.recon_val.init_state(2)
    for b in batches[:2]:
        js = jenc(jstate, js, {k: jnp.asarray(v) for k, v in b.items()})
    js, jcm = jscore(jstate, js,
                     {k: jnp.asarray(v) for k, v in batches[2].items()})

    enc, score = make_streaming_steps(mods, pipe)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    ps = mods.recon_val.init_state(2, "cpu")
    ps = enc(enc(ps, tb[0]), tb[1])
    before = [[t.clone() for t in hc] for hc in ps]
    ps2, cm = score(ps, tb[2])
    for hc, hc0 in zip(ps, before):
        for t, t0 in zip(hc, hc0):
            assert torch.equal(t, t0)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert_states_close(ps2, jax.device_get(js))

    # stream 0 alone, from zero state, on the last window only
    solo = {k: v[:1] for k, v in tb[2].items()}
    fresh, _ = score(mods.recon_val.init_state(1, "cpu"), solo)
    for (h2, c2), (h1, c1) in zip(ps2, fresh):
        torch.testing.assert_close(h2[:1], h1, atol=1e-6, rtol=0)
        torch.testing.assert_close(c2[:1], c1, atol=1e-6, rtol=0)
    assert all(t.is_contiguous(memory_format=torch.channels_last)
               for hc in ps2 for t in hc)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.integers(0, CLASSES, (2, 9, 11))
    label = rng.integers(0, CLASSES, (2, 9, 11))
    label[:, :2] = 255
    names = [f"c{i}" for i in range(CLASSES)]
    mp = metrics.MetricsSemseg(CLASSES, 255, names)
    mj = jax_metrics.MetricsSemseg(CLASSES, 255, names)
    assert mp.confusion.shape == (CLASSES, CLASSES) and not mp.confusion.any()
    for _ in range(2):
        mp.update_batch(pred, label)
        mj.update_batch(pred, label)
    np.testing.assert_array_equal(mp.confusion, mj.confusion)
    iou_p, miou_p = metrics.confusion_to_iou(mp.confusion)
    iou_j, miou_j = jax_metrics.confusion_to_iou(mj.confusion)
    np.testing.assert_array_equal(iou_p, iou_j)
    assert miou_p == miou_j
    assert (metrics.confusion_to_accuracy(mp.confusion)
            == jax_metrics.confusion_to_accuracy(mj.confusion))
    sp, sj = mp.summary(), mj.summary()
    assert set(sp) == set(sj) and sp["mean_iou"] == sj["mean_iou"]
    mp.reset()
    assert not mp.confusion.any()


def test_entry_points_need_a_cuda_device_by_default():
    """With no ``device`` the port builds on the first CUDA device and
    raises where there is none; ``device='cpu'`` is the explicit way onto
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    cfg = port_config(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_modules(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        zero_recurrent_state(1, 16, 16, base_channels=8)
    mods = build_modules(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        mods.recon_val.init_state(1)
    state = mods.recon_val.init_state(1, "cpu")
    assert all(t.device.type == "cpu" for hc in state for t in hc)
    assert next(mods.e2vid.parameters()).device.type == "cpu"
