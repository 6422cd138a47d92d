"""Data parallel: two gloo ranks of the port against the port on one device
and against the JAX package's steps on a 2-device CPU mesh.

One launch (``parallel.launch.spawn`` of ``tests/torch_dp_worker.py``'s
``run_specs``, two CPU ranks, a ``file://`` rendezvous) runs every spec of
this file through ``parallel.steps.run_steps``; the same
specs run in this process on one device. The inputs are built so that a
reduction over a rank's rows instead of the global batch fails a test:

- the supervised batch: a class present only in rank 1's rows (dice), rank
  0's rows mostly ignored and rank 1's fully labelled (the cross-entropy
  count), one sample whose events pile onto one pixel, so that its |x|
  dwarfs the others' in the int8 cells (``'pallas_int8_interpret'`` in both
  packages: the absmax), and the flip augmentation on (the draws);
- the UDA batch: the same labels, and images whose rank means lie far
  apart (the image front's batch norm);
- an eval batch of 2 rows, one a rank;
- the int8 size rule: cell and block conv shapes above ``INT8_MIN_ELEMENTS``
  globally and below it a rank.

Bounds: two ranks vs one device, losses rtol 1e-5, confusion matrices
equal, parameters and batch-norm statistics within 1e-5 of the tensor's
largest magnitude plus 1e-6 (the head's biases before an instance norm
have a zero gradient in exact math: their updates are rounding noise, up
to 1.4e-7 here); both ranks equal bit for bit. Against JAX's mesh, the bounds of
the one-device tests: supervised losses rtol 1e-4 and head parameters atol
1e-5 (``tests/test_torch_train_step.py``); UDA losses rtol 1e-4, BN
statistics atol 1e-5 and the implied gradients within 5 % of the largest
(``tests/test_torch_uda.py``), except the cycle prediction losses, rtol
5e-4: on this batch the port on one device and JAX on one device differ
by 1.7e-4 in the 1x one (the front's ReLU units within rounding of 0,
``tests/test_torch_uda.py``), and the two ranks match the port's one
device within 1e-5; eval losses rtol 1e-4, confusion matrices
within two counts of each pixel whose top-2 logit gap is below 1e-4. The
JAX steps run on the windows the port's pipeline built (a dense batch), as
the int8 step tests do: int8 rounding is discontinuous and the two
voxelizers differ by f32 noise.

``test_dp_checkpoint_resume`` is the counterpart of the JAX package's
``dryrun_multichip``: the UDA step on two ranks at 16x128, T=2, 256 events,
a checkpoint saved under data parallel (rank 0 writes), restored on both
ranks, and the continuation step equal to the live one bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.ops.voxel_pallas import host_band_bin_folded
from ess_tpu.parallel import make_mesh, replicate, shard_batch
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train import uda as jax_uda
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.ops import conv_lstm
from ess_tpu_torch.parallel import launch, steps
from ess_tpu_torch.train.supervised import draw_augment
from tests.test_torch_eval_step import port_config
from tests.test_torch_int8_rule import jax_runs_int8
from tests.test_train_steps import tiny_config
from tests.torch_dp_worker import run_specs

B, T, N, H, W, CLASSES = 4, 2, 600, 24, 128, 6
LR = 1e-2
STEPS = 2
REL = 1e-5      # two ranks vs one device
ATOL = 1e-6     # parameters whose gradient is rounding noise (docstring)

# (name, local NCHW shape, hidden or output channels, kind): above the size
# rule over the global batch of 2x the rows, below it a rank
ROUTES = [("ddd17_crop_b16_level0", (8, 64, 60, 108), 64, "cell"),
          ("dsec_b6_level2", (3, 256, 55, 80), 256, "cell"),
          ("dsec_b2_level2", (1, 256, 55, 80), 256, "cell"),
          ("dsec_b4_head_block", (2, 20, 220, 320), 128, "conv")]


def events(rng, b, n=N, h=H, w=W, pile=None):
    """Host-folded x-slot event columns of ``b`` samples; sample ``pile``
    has 15 % of its events on one pixel."""
    raw = np.zeros((b, T, n, 4), np.float32)
    raw[..., 0] = rng.uniform(0, w - 1, (b, T, n))
    raw[..., 1] = rng.uniform(0, h - 1, (b, T, n))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (b, T, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (b, T, n))
    if pile is not None:
        k = int(0.15 * n)
        raw[pile, :, :k, 0], raw[pile, :, :k, 1] = 40.0, 9.0
    valid = np.ones((b, T, n), bool)
    valid[..., n - n // 10:] = False
    rs, vs, os_ = zip(*(host_band_bin_folded(raw[i], valid[i], height=h,
                                             width=w, bins=5, x_slots=True)
                        for i in range(b)))
    rs, vs, os_ = np.stack(rs), np.stack(vs), np.stack(os_)
    return {"ev_x": rs[..., 0], "ev_y": rs[..., 1], "ev_t": rs[..., 2],
            "ev_p": rs[..., 3], "ev_valid": vs, "ev_band_offsets": os_}


def labels(rng, b, h=H, w=W):
    """Class 5 only in the second half of the rows; the first half mostly
    ignored, the second fully labelled."""
    lab = rng.integers(0, CLASSES - 1, (b, h, w)).astype(np.int64)
    lab[b // 2:, h // 3:, : w // 4] = CLASSES - 1
    lab[: b // 2, 4:] = 255
    return lab


def pipeline_config(flip: bool, h=H, w=W) -> PipelineConfig:
    return PipelineConfig(sensor_height=h, sensor_width=w, num_bins=5,
                          trilinear=True, normalize=True, random_flip=flip)


def configs(model_name="ess_supervised", h=H, w=W, lr=LR):
    """(JAX config, port config) of the slice, int8 train cell."""
    cfg = tiny_config(model_name=model_name)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr_front=lr,
                                                lr_back=lr))
    cfg = cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset,
            sensor_a=dataclasses.replace(cfg.dataset.sensor_a, shape=(h, w)),
            sensor_b=dataclasses.replace(cfg.dataset.sensor_b, shape=(h, w),
                                         nr_events_data=T)),
        model=dataclasses.replace(
            cfg.model, lstm_impl="pallas_interpret",
            lstm_impl_train="pallas_int8_interpret",
            train_on_event_labels=model_name == "ess"))
    return cfg, port_config(cfg)


def port_windows(pcfg, batch, aug=None):
    """The global batch's windows and labels as the port's one-device
    pipeline builds them (JAX's dense batch: (B, T, H, W, C))."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         batch.items() if k.startswith("ev_") or k == "label"}
    win, lab = EventPipeline(pcfg).build_all(t, **({} if aug is None
                                                    else {"aug": aug}))
    return (jnp.asarray(win.permute(1, 0, 3, 4, 2).numpy()),
            jnp.asarray(lab.numpy(), jnp.int32))


def supervised_case():
    cfg, pcfg = configs(lr=1e-3)
    rng = np.random.default_rng(0)
    train = [dict(events(rng, B, pile=3), label=labels(rng, B))
             for _ in range(STEPS)]
    evals = [dict(events(rng, B, pile=3), label=labels(rng, B)),
             dict(events(rng, 2), label=labels(rng, 2))]
    state = jax.device_get(jax_init_state(jax_build(cfg),
                                          jax.random.PRNGKey(0)))
    sd_e, sd_h = params_from_jax(jax.device_get(state.e2vid_params),
                                 jax.device_get(state.back_params))
    spec = {"cfg": pcfg, "state": {"e2vid": sd_e, "head": sd_h},
            "pipeline_train": pipeline_config(True),
            "pipeline_val": pipeline_config(False),
            "train": train, "eval": evals}
    return cfg, state, spec


def uda_case():
    cfg, pcfg = configs("ess")
    rng = np.random.default_rng(1)

    def images(b):
        img = rng.normal(size=(b, 1, H, W)).astype(np.float32)
        img[b // 2:] = img[b // 2:] * 3.0 + 4.0
        return img

    train = [dict(events(rng, B, pile=3), label_b=labels(rng, B),
                  image_a=images(B), label_a=labels(rng, B))]
    evals = [dict(events(rng, B), label=labels(rng, B))]
    evals_a = [{"image": images(B), "label": labels(rng, B)}]
    state = jax.device_get(jax_init_state(jax_build(cfg),
                                          jax.random.PRNGKey(2)))
    sd_e, sd_h = params_from_jax(jax.device_get(state.e2vid_params),
                                 jax.device_get(state.back_params))
    front = front_from_jax(jax.device_get(state.front_params),
                           jax.device_get(state.front_batch_stats))
    spec = {"cfg": pcfg, "state": {"e2vid": sd_e, "head": sd_h,
                                   "front": front},
            "pipeline_train": pipeline_config(True),
            "pipeline_val": pipeline_config(False),
            "train": train, "eval": evals, "eval_a": evals_a}
    return cfg, state, spec


def resume_case(tmp):
    _, pcfg = configs("ess", h=16, w=128)
    rng = np.random.default_rng(3)
    batch = dict(events(rng, 2, n=256, h=16, w=128),
                 label_b=labels(rng, 2, 16, 128),
                 image_a=rng.normal(size=(2, 1, 16, 128)).astype(np.float32),
                 label_a=labels(rng, 2, 16, 128))
    return {"cfg": pcfg, "pipeline_train": pipeline_config(True, 16, 128),
            "pipeline_val": pipeline_config(False, 16, 128),
            "train": [batch], "resume": tmp}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spec on two gloo ranks (one launch) and on one device, torch
    on one thread a process (tests/test_torch_loop.py::one_torch_thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    sup, uda = supervised_case(), uda_case()
    specs = [sup[2], uda[2],
             resume_case(str(tmp_path_factory.mktemp("dp_ckpt")))]
    routes = [(impl, shape) for _, shape, _, _ in ROUTES
              for impl in ("pallas_int8", "pallas_int8_interpret")]
    two, two_routes = zip(*launch.spawn(
        run_specs, 2, (specs, routes), device="cpu"))
    one = [steps.run_steps(dict(s, resume=None)) for s in specs]
    yield {"sup": sup, "uda": uda, "two": two, "one": one,
           "routes": two_routes, "route_cases": routes}
    torch.set_num_threads(threads)


def check_vs_one_device(two, one):
    first = two[0]
    for res in two:
        assert res["train"] == first["train"]
        for got, want in zip(res["train"], one["train"]):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=REL, err_msg=k)
        for name in ("eval", "eval_a"):
            for got, want in zip(res.get(name, []), one.get(name, [])):
                for k, v in want.items():
                    if k.startswith("cm"):
                        np.testing.assert_array_equal(got[k], v)
                    else:
                        np.testing.assert_allclose(got[k], v, rtol=REL,
                                                   err_msg=k)
        for name, sd in one["state"].items():
            for k, v in sd.items():
                got = res["state"][name][k]
                assert torch.equal(got, first["state"][name][k]), (name, k)
                if v.is_floating_point():
                    bound = REL * float(v.abs().max()) + ATOL
                    assert float((got - v).abs().max()) <= bound, (name, k)
                else:
                    assert torch.equal(got, v), (name, k)


@pytest.mark.parametrize("case", ["sup", "uda"])
def test_two_ranks_match_one_device(runs, case):
    i = ["sup", "uda"].index(case)
    two = [r[i] for r in runs["two"]]
    one = runs["one"][i]
    check_vs_one_device(two, one)
    assert [r["world"] for r in two] == [2, 2]
    # the rows of each rank: an eval batch of 2 splits 1 + 1
    if case == "sup":
        assert len(one["eval"]) == 2 and one["eval"][1]["cm"].sum() > 0


def mesh_step(step, state, batch, mesh):
    return jax.device_get(step(replicate(state, mesh),
                               shard_batch(batch, mesh)))


def test_supervised_two_ranks_match_jax_mesh(runs):
    cfg, state, spec = runs["sup"]
    state0 = state
    got = runs["two"][0][0]
    mods = jax_build(cfg)
    mesh = make_mesh(2)
    pcfg = spec["pipeline_train"]
    step = jax_sup.make_train_step(mods)
    want, flips = [], []
    for s, batch in enumerate(spec["train"]):
        aug = draw_augment(EventPipeline(pcfg), spec["cfg"].seed, s, B)
        flips.append(aug.flip)
        win, lab = port_windows(pcfg, batch, aug)
        state, out = mesh_step(step, state, {"events": win, "label": lab},
                               mesh)
        want.append(float(out["loss"]))
    flips = torch.cat(flips)
    assert flips.any() and not flips.all()
    np.testing.assert_allclose([g["loss"] for g in got["train"]], want,
                               rtol=1e-4)
    _, want_head = params_from_jax(state.e2vid_params, state.back_params)
    for k, v in got["state"]["head"].items():
        np.testing.assert_allclose(v.numpy(), want_head[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)

    ev = jax_sup.make_eval_step(mods)
    win, lab = port_windows(spec["pipeline_val"], spec["eval"][0])
    out = mesh_step(ev, state0, {"events": win, "label": lab}, mesh)
    np.testing.assert_allclose(got["eval"][0]["loss"], float(out["loss"]),
                               rtol=1e-4)
    assert (np.abs(got["eval"][0]["cm"] - np.asarray(out["cm"])).sum()
            <= 2 * 4)


def test_uda_two_ranks_match_jax_mesh(runs):
    cfg, state, spec = runs["uda"]
    got = runs["two"][0][1]
    mods = jax_build(cfg)
    mesh = make_mesh(2)
    batch = spec["train"][0]
    aug = draw_augment(EventPipeline(spec["pipeline_train"]),
                       spec["cfg"].seed + 1, 0, B)
    win, lab_b = port_windows(spec["pipeline_train"],
                              {**batch, "label": batch["label_b"]}, aug)
    jbatch = {"events_b": win, "label_b": lab_b,
              "image_a": jnp.asarray(np.moveaxis(batch["image_a"], 1, -1)),
              "label_a": jnp.asarray(batch["label_a"], jnp.int32)}
    new_state, want = mesh_step(jax_uda.make_train_step(mods), state,
                                jbatch, mesh)
    for k, v in want.items():
        np.testing.assert_allclose(got["train"][0][k], float(v),
                                   rtol=5e-4 if "cycle_pred" in k else 1e-4,
                                   err_msg=k)
    want_front = front_from_jax(new_state.front_params,
                                new_state.front_batch_stats)
    before = spec["state"]["front"]
    for k, v in got["state"]["front"].items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_front[k].numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
        elif v.is_floating_point():
            g, g_want = (before[k] - v) / LR, (before[k] - want_front[k]) / LR
            assert (float((g - g_want).abs().max())
                    <= 0.05 * float(g_want.abs().max()) + 3e-5), k

    win, lab = port_windows(spec["pipeline_val"], spec["eval"][0])
    out_b = mesh_step(jax_uda.make_eval_step_b(mods), state,
                      {"events": win, "label": lab}, mesh)
    ev_a = spec["eval_a"][0]
    out_a = mesh_step(jax_uda.make_eval_step_a(mods), state,
                      {"image": jnp.asarray(np.moveaxis(ev_a["image"], 1,
                                                        -1)),
                       "label": jnp.asarray(ev_a["label"], jnp.int32)},
                      mesh)
    for got_out, want_out in ((got["eval"][0], out_b),
                              (got["eval_a"][0], out_a)):
        for k, v in want_out.items():
            if k.endswith("_loss"):
                np.testing.assert_allclose(got_out[k], float(v), rtol=1e-4,
                                           err_msg=k)
            elif k.startswith("cm"):
                assert np.abs(got_out[k] - np.asarray(v)).sum() <= 8, k


def test_dp_checkpoint_resume(runs):
    two = [r[2] for r in runs["two"]]
    for res in two:
        r = res["resume"]
        assert r["live"] == r["resumed"]
        for name, sd in r["live_state"].items():
            for k, v in sd.items():
                assert torch.equal(v, r["resumed_state"][name][k]), (name, k)
    assert two[0]["resume"]["live"] == two[1]["resume"]["live"]
    check_vs_one_device(two, runs["one"][2])


def test_int8_size_rule_reads_the_global_shape(runs):
    """Each rank routes its local shape as JAX's dispatch routes the global
    one, where the rule on the local shape alone would route otherwise."""
    for name, shape, ch, kind in ROUTES:
        glob = (2 * shape[0],) + shape[1:]
        nhwc = (glob[0], glob[2], glob[3], glob[1])
        for impl in ("pallas_int8", "pallas_int8_interpret"):
            i = runs["route_cases"].index((impl, shape))
            want = jax_runs_int8(kind, nhwc, ch, impl)
            for routes in runs["routes"]:
                assert (routes[i] == "pallas_int8") == want, (name, impl)
    local = [conv_lstm.int8_size_rule(s) for _, s, _, _ in ROUTES]
    glob = [conv_lstm.int8_size_rule((2 * s[0],) + s[1:])
            for _, s, _, _ in ROUTES]
    assert local == [False, False, False, False]
    assert glob == [True, True, False, True]
