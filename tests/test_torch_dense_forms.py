"""The dense form: prebuilt (B, T, H, W, C) grids through the port, against
the JAX package.

- ``voxelize_windows`` against JAX's (``tests/test_batch_voxel.py``'s
  dense wrapper; on the CPU JAX takes its XLA scatter, which truncates
  where the kernels floor, so coordinates stay in the frame): integer
  coordinates (temporal bilinear, with and without ``separate_pol``),
  float coordinates on the 1/64 lattice (trilinear), and a rectify map
  whose image lies inside the frame; normalized and not. Bounds: those of
  ``tests/test_torch_voxel_tiled.py`` (``assert_close``).
- ``EventPipeline.__call__`` against JAX's, without augmentation and with
  JAX's draws carried across (crop and flip), on a DDD17-like geometry
  (bottom crop, resize, bottom-anchored crop, flip) and a DSEC-like one
  (bottom crop, flip): the same bounds on the grids, labels equal.
- The steps on ``tests/test_train_steps.py``'s dense batches (16x16, B=2,
  T=2, 5 channels): the supervised eval step (loss rtol 1e-4, ``latent8``
  and ``img_fake`` atol 1e-4, the argmax equal where the top-2 logit gap
  is at least 1e-4), the supervised train step on the exact cell and, at
  the int8 train-step test's 48x256 windows (built by the port's
  pipeline), on the int8 cell (one step: loss rtol 1e-4, head parameters
  atol 1e-5), the UDA
  train step with ``"events_b"`` and UDA eval step B (every loss rtol
  1e-4, the implied gradients within 5 % of the largest plus 3e-5,
  batch-norm statistics atol 1e-5; ``latent8`` and ``img_fake`` atol
  1e-4), as ``tests/test_torch_train_step.py`` and
  ``tests/test_torch_uda.py`` hold the same steps. A dense batch on
  another device than the model raises.
- The Trainer on an in-memory loader of dense grids against JAX's Trainer
  (``tests/test_torch_loop.py``'s comparison at 32x32: per-step losses,
  validation, head parameters), and ``_merge_uda``'s renaming.
- Data parallel: two gloo ranks against one device on a dense batch
  (``tests/test_torch_parallel.py``'s runner): losses rtol 1e-5, the
  updated head atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data.loader import BatchLoader as JaxBatchLoader
from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.ops.batch_voxel import voxelize_windows as jax_windows
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train import uda as jax_uda
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state
from ess_tpu.train.loop import Trainer as JaxTrainer

from ess_tpu_torch.data.loader import BatchLoader
from ess_tpu_torch.data.synthetic import SyntheticEvents
from ess_tpu_torch.data.pipeline import (AugmentParams, EventPipeline,
                                         PipelineConfig)
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.ops.batch_voxel import voxelize_windows
from ess_tpu_torch.parallel import launch, steps
from ess_tpu_torch.train import loop
from ess_tpu_torch.train import supervised as sup
from ess_tpu_torch.train import uda
from ess_tpu_torch.train.builder import build_modules, init_state
from tests import test_torch_uda as tu
from tests.test_torch_eval_step import folded_batch, port_config
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import (
    PARITY_SIZE, check_pair, one_torch_thread, sized_config)
from tests.test_torch_train_step import H, W, slice_config
from tests.test_train_steps import synthetic_batch, tiny_config, uda_batch
from tests.test_torch_voxel_tiled import assert_close
from tests.torch_dp_worker import run_specs

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

# the JAX side loads its own copy of the native library (test_torch_host_bin)
_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

CLASSES = 6


def raw_windows(rng, b, t_dim, n, h, w, *, lattice: bool):
    """(B, T, N, 4) events in the frame (integers, or the 1/64 lattice),
    window-relative sorted times, the last tenth invalid."""
    ev = np.zeros((b, t_dim, n, 4), np.float32)
    if lattice:
        ev[..., 0] = rng.integers(0, (w - 1) * 64, (b, t_dim, n)) / 64.0
        ev[..., 1] = rng.integers(0, (h - 1) * 64, (b, t_dim, n)) / 64.0
    else:
        ev[..., 0] = rng.integers(0, w, (b, t_dim, n))
        ev[..., 1] = rng.integers(0, h, (b, t_dim, n))
    ev[..., 2] = np.sort(rng.uniform(0, 1e4, (b, t_dim, n)), axis=-1)
    ev[..., 3] = rng.integers(0, 2, (b, t_dim, n))
    valid = np.ones((b, t_dim, n), bool)
    valid[..., n - n // 10:] = False
    return ev, valid


def inside_map(rng, h, w):
    """A rectify map on the 1/64 lattice whose image lies inside the frame
    (JAX's scatter and the kernels then agree)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    m = np.stack([xx, yy], -1) + rng.integers(-32, 33, (h, w, 2)) / 64.0
    m[..., 0] = np.clip(m[..., 0], 0, w - 1)
    m[..., 1] = np.clip(m[..., 1], 0, h - 1)
    return m.astype(np.float32)


WINDOW_CASES = {
    "integer": dict(lattice=False),
    "integer_separate_pol": dict(lattice=False, separate_pol=True),
    "trilinear": dict(lattice=True, trilinear=True),
    "rectified": dict(lattice=False, rectify=True),
}


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_voxelize_windows_matches_jax(case, normalize):
    c = dict(WINDOW_CASES[case])
    h, w = 24, 40
    rng = np.random.default_rng(0)
    ev, valid = raw_windows(rng, 2, 3, 600, h, w, lattice=c.pop("lattice"))
    m = inside_map(rng, h, w) if c.pop("rectify", False) else None
    kw = dict(num_bins=5, height=h, width=w, normalize=normalize, **c)
    want = np.asarray(jax_windows(
        jnp.asarray(ev), jnp.asarray(valid),
        rectify_map=None if m is None else jnp.asarray(m), **kw))
    got = voxelize_windows(torch.from_numpy(ev), torch.from_numpy(valid),
                           rectify_map=None if m is None
                           else torch.from_numpy(m), **kw)
    assert got.shape == want.shape == (2, 3, h, w, want.shape[-1])
    assert_close(got.numpy(), want, normalize)
    # a channel-last view of channel-first windows
    assert got.permute(0, 1, 4, 2, 3).stride(-1) == 1


PIPE_CASES = {
    "ddd17_like": dict(sensor_height=26, sensor_width=34, crop_bottom=6,
                       resize_to=(20, 36), random_crop=(12, 20),
                       crop_anchor="bottom", random_flip=True),
    "dsec_like": dict(sensor_height=24, sensor_width=40, crop_bottom=4,
                      random_flip=True, trilinear=True),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_pipeline_call_matches_jax(case, train):
    geo = dict(num_bins=5, normalize=True, **PIPE_CASES[case])
    rng = np.random.default_rng(1)
    b, t_dim = 4, 3
    ev, valid = raw_windows(rng, b, t_dim, 500, geo["sensor_height"],
                            geo["sensor_width"],
                            lattice=geo.get("trilinear", False))
    jpipe = JaxPipeline(JaxPipelineConfig(**geo))
    pipe = EventPipeline(PipelineConfig(**geo))
    label = rng.integers(0, CLASSES, (b,) + pipe.cfg.pre_aug_size)
    batch = {"raw_events": ev, "valid": valid, "label": label,
             "sample_id": np.arange(b)}
    key = jax.random.PRNGKey(3)           # mixed flips
    want = jax.device_get(jpipe({k: jnp.asarray(v) for k, v in batch.items()},
                                key, train=train))
    draws = jpipe.sample_augment(key, b, train=train)
    aug = AugmentParams(*(None if a is None else torch.from_numpy(
        np.asarray(a).copy()) for a in (draws.flip, draws.crop_y,
                                        draws.crop_x)))
    if train:
        assert aug.flip.any() and not aug.flip.all()
    got = pipe({k: torch.from_numpy(v) for k, v in batch.items()}, aug=aug)
    assert sorted(got) == sorted(want) == ["events", "label", "sample_id"]
    assert got["events"].shape == want["events"].shape == (
        (b, t_dim) + pipe.cfg.output_size(train) + (5,))
    assert_close(got["events"].numpy(), np.asarray(want["events"]), True)
    np.testing.assert_array_equal(got["label"].numpy(), want["label"])
    np.testing.assert_array_equal(got["sample_id"].numpy(), np.arange(b))
    # the generator form draws for itself, and no draws without training
    drawn = pipe({k: torch.from_numpy(v) for k, v in batch.items()},
                 torch.Generator().manual_seed(0), train=train)
    assert drawn["events"].shape == got["events"].shape
    if not train:
        torch.testing.assert_close(drawn["events"], got["events"], rtol=0,
                                   atol=0)


def dense_config(model_name="ess_supervised", lstm_impl_train=None, **kw):
    cfg = tiny_config(model_name=model_name, **kw)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, lstm_impl="pallas_interpret",
        lstm_impl_train=lstm_impl_train))


def port_mods(cfg, state):
    mods = build_modules(port_config(cfg), device="cpu")
    sd_e, sd_h = params_from_jax(jax.device_get(state.e2vid_params),
                                 jax.device_get(state.back_params))
    mods.e2vid.load_state_dict(sd_e)
    mods.head.load_state_dict(sd_h)
    if mods.front_a is not None:
        mods.front_a.load_state_dict(front_from_jax(
            jax.device_get(state.front_params),
            jax.device_get(state.front_batch_stats)))
    return mods


def torch_dense(batch):
    out = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}
    for k in ("label", "label_a", "label_b"):
        if k in out:
            out[k] = out[k].long()
    if "image_a" in out:
        out["image_a"] = out["image_a"].permute(0, 3, 1, 2)
    return out


def test_dense_eval_step_matches_jax():
    cfg = dense_config()
    batch = synthetic_batch(np.random.default_rng(2))
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    want = jax.device_get(jax_sup.make_eval_step(mods)(state, batch))
    pmods = port_mods(cfg, state)
    tb = torch_dense(batch)
    got = sup.make_eval_step(pmods)(tb)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    for k in ("latent8", "img_fake"):
        np.testing.assert_allclose(got[k].numpy(), np.moveaxis(want[k], -1, 1),
                                   atol=1e-4, rtol=0, err_msg=k)
    with torch.inference_mode():
        windows = tb["events"].permute(1, 0, 4, 2, 3)
        logits = pmods.head(pmods.recon_val.rollout(windows)[2])[1]
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] >= 1e-4).numpy()
    np.testing.assert_array_equal(got["pred"].numpy()[clear],
                                  np.asarray(want["pred"])[clear])
    assert float(got["cm"].sum()) == 2 * 16 * 16
    with pytest.raises(ValueError, match="dense events on meta"):
        sup.make_eval_step(pmods)({**tb, "events": tb["events"].to("meta")})


def pipeline_windows(seed: int) -> dict:
    """``tests/test_torch_train_step.py``'s 48x256 batch as dense windows
    built by the port's pipeline (B=2, T=3), and its label."""
    cols = folded_batch(np.random.default_rng(seed))
    pipe = EventPipeline(PipelineConfig(sensor_height=H, sensor_width=W,
                                        num_bins=5, trilinear=True,
                                        normalize=True))
    windows, label = pipe.build_all({k: torch.from_numpy(v)
                                     for k, v in cols.items()})
    return {"events": windows.permute(1, 0, 3, 4, 2).numpy(),
            "label": label.numpy().astype(np.int32)}


@pytest.mark.parametrize("lstm_impl_train", [None, "pallas_int8_interpret"],
                         ids=["exact", "int8"])
def test_dense_train_step_matches_jax(lstm_impl_train):
    """The exact cell on the 16x16 dense batch; the int8 cell, whose
    rounding is discontinuous, at the int8 train-step test's 48x256
    windows, where its bounds hold (tests/test_torch_train_step.py)."""
    if lstm_impl_train is None:
        cfg = dense_config()
        batch = synthetic_batch(np.random.default_rng(3))
    else:
        cfg = slice_config(lstm_impl_train)
        batch = pipeline_windows(3)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_mods(cfg, state)
    new_state, want = jax_sup.make_train_step(mods)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    _, want_head = params_from_jax(jax.device_get(new_state.e2vid_params),
                                   jax.device_get(new_state.back_params))
    pstate = init_state(pmods)
    # no pipeline: a dense batch needs none, and takes no draws
    got = sup.make_train_step(pmods)(pstate, torch_dense(batch))
    assert pstate.step == 1
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    for k, v in pmods.head.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_head[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_dense_uda_steps_match_jax():
    cfg = dense_config(model_name="ess", event_name="DSEC_events",
                       weight_cycle_emb_loss=0.5, weight_cycle_task_loss=0.3,
                       weight_cycle_pred_loss=0.7)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr_front=tu.LR,
                                                lr_back=tu.LR))
    rng = np.random.default_rng(4)
    batch = uda_batch(rng)
    batch["label_b"] = rng.integers(0, CLASSES, (2, 16, 16)).astype(np.int32)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(1))
    pmods = port_mods(cfg, state)
    # eval step B on the dense form first (the train step donates state)
    eval_b = {"events": batch["events_b"], "label": batch["label_b"]}
    want_b = jax.device_get(jax_uda.make_eval_step_b(mods)(state, eval_b))
    got_b = uda.make_eval_step_b(pmods)(torch_dense(eval_b))
    assert sorted(got_b) == sorted(want_b)
    for k, v in want_b.items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(float(got_b[k]), float(v), rtol=1e-4,
                                       err_msg=k)
    for k in ("latent8", "img_fake"):
        np.testing.assert_allclose(got_b[k].numpy(),
                                   np.moveaxis(want_b[k], -1, 1), atol=1e-4,
                                   rtol=0, err_msg=k)

    new_state, want = jax.device_get(jax_uda.make_train_step(mods)(
        state, batch))
    want_front = front_from_jax(new_state.front_params,
                                new_state.front_batch_stats)
    _, want_head = params_from_jax(new_state.e2vid_params,
                                   new_state.back_params)
    head0 = {k: v.clone() for k, v in pmods.head.state_dict().items()}
    front0 = {k: v.clone() for k, v in pmods.front_a.state_dict().items()}
    got = uda.make_train_step(pmods)(init_state(pmods), torch_dense(batch))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
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


class DenseGrids:
    """An in-memory dataset of prebuilt grids: ``SyntheticEvents``' samples
    (the loop tests' data) voxelized once by the port's pipeline, (T, H, W,
    C) f32 windows and an (H, W) label a sample."""

    def __init__(self, n: int, size: int):
        ds = SyntheticEvents(length=n, height=size, width=size,
                             nr_events_data=2, nr_events_window=128)
        samples = [ds[i] for i in range(n)]
        stack = lambda k: torch.from_numpy(np.stack([s[k] for s in samples]))
        pipe = EventPipeline(PipelineConfig(sensor_height=size,
                                            sensor_width=size, num_bins=5,
                                            normalize=True))
        out = pipe({"raw_events": stack("raw_events"),
                    "valid": stack("valid"), "label": stack("label")})
        self.events = out["events"].contiguous().numpy()
        self.labels = out["label"].numpy()

    def __len__(self):
        return len(self.events)

    def __getitem__(self, i):
        return {"events": self.events[i], "label": self.labels[i]}


def dense_loaders(cls):
    ds = DenseGrids(6, PARITY_SIZE)
    return dict(train_b=cls(ds, 2, shuffle=False, num_workers=2),
                val_b=cls(ds, 2, shuffle=False, drop_last=False,
                          num_workers=2))


def test_trainer_on_dense_grids_matches_jax(tmp_path):
    jcfg = sized_config("ess_supervised", tmp_path, PARITY_SIZE)
    jtr = JaxTrainer(jcfg, log_dir=str(tmp_path / "jax"),
                     **dense_loaders(JaxBatchLoader))
    st = jax.device_get(jtr.state)
    e2vid_sd, head_sd = params_from_jax(st.e2vid_params, st.back_params)
    tr = loop.Trainer(port_config(jcfg), log_dir=str(tmp_path / "port"),
                      e2vid_state=e2vid_sd, device="cpu",
                      **dense_loaders(BatchLoader))
    tr.state.head.load_state_dict(head_sd)
    jtr.writer.flush_every = tr.writer.flush_every = 1
    check_pair(jtr, jtr.run(), tr, tr.run())


def test_merge_uda_renames_dense_events():
    a = {"image": np.zeros((2, 1, 4, 4)), "label": np.ones((2, 4, 4))}
    b = {"events": np.zeros((2, 3, 4, 4, 5)), "label": np.full((2, 4, 4), 2)}
    out = loop._merge_uda(a, b)
    assert sorted(out) == ["events_b", "image_a", "label_a", "label_b"]
    assert out["events_b"] is b["events"] and out["label_b"] is b["label"]
    host = loop._host_batch(b)
    assert host["events"] is b["events"]


def test_data_parallel_dense_batch_matches_one_device():
    """Two gloo ranks, each on its rows of a dense global batch, against
    one device on the whole batch: eval and train steps."""
    cfg = port_config(dense_config())
    rng = np.random.default_rng(6)
    glob = {"events": rng.normal(size=(4, 2, 16, 16, 5)).astype(np.float32),
            "label": rng.integers(0, CLASSES, (4, 16, 16))}
    spec = {"cfg": cfg, "train": [glob, glob], "eval": [glob]}
    one = steps.run_steps(spec)
    ranks = launch.spawn(run_specs, 2, ([spec],), device="cpu")
    for (got,), _ in ranks:
        assert got["world"] == 2
        for a, b in zip(got["train"], one["train"]):
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(got["eval"][0]["cm"],
                                      one["eval"][0]["cm"])
        np.testing.assert_allclose(got["eval"][0]["loss"],
                                   one["eval"][0]["loss"], rtol=1e-5)
        for k, v in one["state"]["head"].items():
            np.testing.assert_allclose(got["state"]["head"][k].numpy(),
                                       v.numpy(), atol=1e-6, rtol=0,
                                       err_msg=k)
