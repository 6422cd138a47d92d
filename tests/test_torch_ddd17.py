"""DDD17 on the port: the resize, the integer-coordinate band wire, the
pipeline at DDD17's geometry and the DDD17 steps, against the JAX package.

- ``resize_bilinear`` (NCHW) against JAX's (NHWC) in both modes, shrinking
  and growing: atol 1e-5 (the sampling positions are computed in f32 by
  both, in other orders).
- ``host_band_bin_folded(trilinear=False)``, the native binning and its
  plain version, equal to JAX's (integer records, no ghosts), with and
  without ``separate_pol``'s 10 bins.
- ``make_pipeline(cfg)`` + ``build_all`` at the real 260x346 geometry
  (B=1, T=2, integer events) against JAX's ``make_pipeline`` + ``build_all``
  (``use_pallas=True, pallas_interpret=True``, f32 tent planes): the
  supervised train pipeline (flip) and eval, and the UDA train pipeline
  (bottom-anchored 120x216 crop at y = 80, a random x, flip) with JAX's
  draws; windows atol 2e-3 / rtol 1e-4 (the f32 voxelizer bound of
  tests/test_torch_voxel.py), labels equal.
- Queue C: the per-sample crop draws from the post-resize size and crops
  labels stored at it.
- The steps on a reduced geometry that keeps every DDD17 feature (integer
  coordinates, a bottom crop, a non-integer width resize 70 -> 72, a
  bottom-anchored crop with a random x, a flip): the supervised train and
  eval steps and the UDA train step, exact cells, against JAX
  ``make_train_step`` / ``make_eval_step`` / ``uda.make_train_step`` with
  the JAX weights, under the bounds of the DSEC step tests
  (tests/test_torch_train_step.py, tests/test_torch_eval_step.py,
  tests/test_torch_uda.py); the UDA step's gradients at four batch seeds,
  both packages' against the port's in f64 with each ReLU within f32
  rounding of 0 allowed either side, to 0.1 %.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.ops.resize import resize_bilinear as jax_resize
from ess_tpu.ops.voxel_pallas import host_band_bin_folded as jax_band_bin
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train import uda as jax_uda
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state
from ess_tpu.train.builder import make_pipeline as jax_make_pipeline

from ess_tpu_torch import bench
from ess_tpu_torch.data.pipeline import (AugmentParams, EventPipeline,
                                         PipelineConfig)
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.ops import voxel_folded as vf
from ess_tpu_torch.ops.resize import resize_bilinear
from ess_tpu_torch.train import supervised, uda
from ess_tpu_torch.train.builder import (build_modules, init_state,
                                         make_pipeline)
from tests.test_torch_eval_step import port_config
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_train_steps import tiny_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

WIN_TOL = dict(atol=2e-3, rtol=1e-4)


def nhwc(a):
    return np.moveaxis(np.asarray(a), 1, -1)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw", [(13, 22), (20, 30), (7, 9), (26, 11)])
def test_resize_bilinear_matches_jax(hw, align_corners):
    x = np.random.default_rng(0).normal(size=(2, 3, 13, 17)).astype(
        np.float32)
    want = np.asarray(jax_resize(jnp.asarray(nhwc(x)), *hw,
                                 align_corners=align_corners))
    got = resize_bilinear(torch.from_numpy(x), *hw,
                          align_corners=align_corners)
    assert got.shape == (2, 3) + hw
    np.testing.assert_allclose(nhwc(got.numpy()), want, atol=1e-5, rtol=0)


def int_events(rng, b, t, n, h, w):
    """Integer-coordinate raw windows (b, t, n, 4), a tenth invalid, and a
    few events outside the sensor."""
    raw = np.zeros((b, t, n, 4), np.float32)
    raw[..., 0] = rng.integers(-2, w + 2, (b, t, n))
    raw[..., 1] = rng.integers(0, h, (b, t, n))
    raw[..., 2] = np.sort(rng.uniform(0, 5e4, (b, t, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (b, t, n))
    valid = np.ones((b, t, n), bool)
    valid[..., n - n // 10:] = False
    return raw, valid


@pytest.mark.parametrize("x_slots", [True, False])
@pytest.mark.parametrize("bins", [5, 10])
def test_integer_band_binning_matches_jax(bins, x_slots):
    raw, valid = int_events(np.random.default_rng(1), 1, 3, 3000, 260, 346)
    kw = dict(height=260, width=346, bins=bins, x_slots=x_slots)
    want = jax_band_bin(raw[0], valid[0], trilinear=False, **kw)
    for fn in (vf.host_band_bin_folded, vf.host_band_bin_folded_ref):
        got = fn(raw[0], valid[0], trilinear=False, **kw)
        for a, b_, name in zip(got, want, ("records", "valid", "offsets")):
            assert a.shape == b_.shape and a.dtype == b_.dtype, name
            np.testing.assert_array_equal(a, b_, err_msg=name)
    # no ghosts: capacity N, and every kept record is an input event
    assert got[0].shape[1] == raw.shape[2]
    assert got[1].sum() == (valid[0] & (raw[0, ..., 0] >= 0)
                            & (raw[0, ..., 0] < 346)).sum()


def ddd17_cfg(model_name: str, **model_kw):
    """JAX's DDD17 config (tiny model) for ``model_name``, with
    augmentation on."""
    cfg = tiny_config(model_name=model_name, event_name="DDD17_events")
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset, sensor_b=dataclasses.replace(
                cfg.dataset.sensor_b, shape=(200, 346), nr_events_data=2)),
        model=dataclasses.replace(cfg.model, data_augmentation_train=True,
                                  **model_kw))


def binned_batch(rng, b, t, n, h, w, label_hw, bins=5, classes=6):
    raw, valid = int_events(rng, b, t, n, h, w)
    rs, vs, os_ = zip(*(vf.host_band_bin_folded(
        raw[i], valid[i], height=h, width=w, bins=bins, trilinear=False)
        for i in range(b)))
    rs, vs, os_ = np.stack(rs), np.stack(vs), np.stack(os_)
    label = rng.integers(0, classes, (b,) + label_hw).astype(np.int64)
    label[:, :3] = 255
    return {"ev_x": rs[..., 0], "ev_y": rs[..., 1], "ev_t": rs[..., 2],
            "ev_p": rs[..., 3], "ev_valid": vs, "ev_band_offsets": os_,
            "label": label}


def jax_interpret(pipe: JaxPipeline) -> JaxPipeline:
    return JaxPipeline(dataclasses.replace(
        pipe.cfg, use_pallas=True, pallas_interpret=True,
        voxel_oh_dtype="float32"))


def jax_aug_with_flip(jpipe, b):
    """A key whose draws flip every sample, and the draws."""
    for k in range(64):
        rng = jax.random.PRNGKey(k)
        aug = jpipe.sample_augment(rng, b, train=True)
        if bool(np.asarray(aug.flip).all()):
            return rng, aug
    raise AssertionError("no key flips")


@pytest.mark.parametrize("model_name,train", [
    ("ess_supervised", True), ("ess_supervised", False), ("ess", True)])
def test_build_all_at_ddd17_geometry_matches_jax(model_name, train):
    """B=1, T=2 windows of 3000 integer events at 260x346 through both
    packages' ``make_pipeline``: normalize at sensor resolution, crop 60
    rows, resize to 200x352, then for UDA training the 120x216 crop."""
    cfg = ddd17_cfg(model_name)
    jpipe = jax_interpret(jax_make_pipeline(cfg, train=train))
    pipe = make_pipeline(port_config(cfg), train=train)
    assert pipe.cfg.pre_aug_size == (200, 352)
    assert pipe.cfg.output_size(train) == (
        (120, 216) if model_name == "ess" and train else (200, 352))
    cols = binned_batch(np.random.default_rng(2), 1, 2, 3000, 260, 346,
                        (200, 352))
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()}
    rng, aug = None, AugmentParams()
    if train:
        rng, jaug = jax_aug_with_flip(jpipe, 1)
        aug = AugmentParams(*(None if a is None else
                              torch.from_numpy(np.asarray(a).copy())
                              for a in (jaug.flip, jaug.crop_y, jaug.crop_x)))
        if model_name == "ess":
            assert int(aug.crop_y[0]) == 80
    grids_j, label_j = jpipe.build_all(jbatch, rng, train=train)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    windows, label = pipe.build_all(batch, aug=aug)
    assert windows.shape[3:] == pipe.cfg.output_size(train)
    np.testing.assert_allclose(
        windows.permute(1, 0, 3, 4, 2).numpy(), np.asarray(grids_j),
        **WIN_TOL)
    np.testing.assert_array_equal(label.numpy(), np.asarray(label_j))


def test_crop_draws_from_the_resized_size():
    """The per-sample crop of DDD17 UDA training draws x from the 352-wide
    resized grid (0 .. 136), y at the bottom (80), and crops labels stored
    at 200x352 (the pre-augmentation size) to 120x216."""
    pipe = make_pipeline(port_config(ddd17_cfg("ess")), train=True)
    aug = pipe.sample_augment(torch.Generator().manual_seed(0), 2000,
                              train=True)
    assert aug.crop_y.eq(80).all()
    assert int(aug.crop_x.max()) == 136 and int(aug.crop_x.min()) == 0
    label = torch.arange(2 * 200 * 352).view(2, 200, 352) % 7
    few = AugmentParams(flip=aug.flip[:2], crop_y=aug.crop_y[:2],
                        crop_x=torch.tensor([136, 3]))
    out = pipe.apply_label_transform(label, few)
    assert out.shape == (2, 120, 216)
    want = label[0, 80:, 136:]
    assert torch.equal(out[0], want.flip(-1) if few.flip[0] else want)


def test_make_pipeline_branches():
    """The DSEC, DDD17 and other branches of JAX ``make_pipeline`` (their
    geometry and augmentation, and the three representations), the DSEC
    branch with a rectify map (rectification on the device: the map kept on
    the named device, on the first CUDA device by default); an unknown
    representation raises."""
    for name, model_name, train in (
            ("DSEC_events", "ess_supervised", True),
            ("DDD17_events", "ess", True), ("DDD17_events", "ess", False),
            ("DDD17_events", "ess_supervised", True),
            ("synthetic_events", "ess", True)):
        cfg = tiny_config(model_name=model_name, event_name=name)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, data_augmentation_train=True))
        want = jax_make_pipeline(cfg, train=train).cfg
        got = make_pipeline(port_config(cfg), train=train).cfg
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (
                name, model_name, train, f.name)
    dsec = tiny_config(event_name="DSEC_events")
    rmap = np.zeros((480, 640, 2), np.float32)
    want = jax_make_pipeline(dsec, rectify_map=rmap)
    got = make_pipeline(port_config(dsec), rectify_map=rmap, device="cpu")
    assert got.cfg.rectify and want.cfg.rectify
    for f in dataclasses.fields(got.cfg):
        assert getattr(got.cfg, f.name) == getattr(want.cfg, f.name), f.name
    assert got.rectify_map.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_pipeline(port_config(dsec), rectify_map=rmap)
    # the bench's DSEC pipeline is bench.py's hand-built one
    assert bench.make_pipeline().cfg == PipelineConfig(
        sensor_height=480, sensor_width=640, num_bins=5, crop_bottom=40,
        trilinear=True, normalize=True)
    # the histogram and EV-SegNet representations build as JAX's (their
    # windows: tests/test_torch_representations.py); an unknown one raises
    for rep in ("histogram", "ev_segnet"):
        cfg = ddd17_cfg("ess")
        cfg = cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, sensor_b=dataclasses.replace(
                cfg.dataset.sensor_b, event_representation=rep)))
        want = jax_make_pipeline(cfg, train=True).cfg
        got = make_pipeline(port_config(cfg), train=True).cfg
        assert got.representation == rep
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (rep,
                                                                   f.name)
    with pytest.raises(ValueError):
        PipelineConfig(sensor_height=8, sensor_width=8,
                       representation="voxel")


# --- the steps on a reduced DDD17 geometry ---------------------------------
# sensor 52x70, 12 bottom rows cropped, width resized 70 -> 72 (the rollout
# is 40x72), the UDA crop 24x40 at the bottom with a random x, flips on
SH, SW, CROP, RESIZED, UDA_CROP = 52, 70, 12, (40, 72), (24, 40)
B, T, N = 2, 2, 900


def reduced_pipelines(model_name: str, train: bool):
    geo = dict(sensor_height=SH, sensor_width=SW, num_bins=5, normalize=True,
               crop_bottom=CROP, resize_to=RESIZED, crop_anchor="bottom",
               random_flip=train,
               random_crop=UDA_CROP if model_name == "ess" and train
               else None)
    from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
    return (JaxPipeline(JaxPipelineConfig(
        use_pallas=True, pallas_interpret=True, voxel_oh_dtype="float32",
        **geo)), EventPipeline(PipelineConfig(**geo)))


def reduced_cfg(model_name: str):
    shape = UDA_CROP if model_name == "ess" else (SH - CROP, SW)
    cfg = tiny_config(model_name=model_name, event_name="reduced_ddd17")
    if model_name == "ess":
        cfg = cfg.replace(optim=dataclasses.replace(
            cfg.optim, lr_front=1e-2, lr_back=1e-2,
            weight_cycle_emb_loss=0.5, weight_cycle_task_loss=0.3,
            weight_cycle_pred_loss=0.7))
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset,
            sensor_a=dataclasses.replace(cfg.dataset.sensor_a, shape=shape),
            sensor_b=dataclasses.replace(cfg.dataset.sensor_b, shape=shape,
                                         nr_events_data=T)),
        model=dataclasses.replace(cfg.model, lstm_impl="pallas_interpret",
                                  data_augmentation_train=True))


def to_port_aug(jaug):
    return AugmentParams(*(None if a is None else
                           torch.from_numpy(np.asarray(a).copy())
                           for a in (jaug.flip, jaug.crop_y, jaug.crop_x)))


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


def test_supervised_steps_at_reduced_ddd17_geometry():
    """Two train steps (JAX's flip draws) and one eval step: losses rtol
    1e-4, head parameters atol 1e-5, E2VID untouched; eval latent8 and
    img_fake atol 1e-4, the confusion matrix within the pixels whose top-2
    logit gap is below 1e-4."""
    cfg = reduced_cfg("ess_supervised")
    cols = binned_batch(np.random.default_rng(4), B, T, N, SH, SW, RESIZED)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()}
    jbatch["label"] = jbatch["label"].astype(jnp.int32)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_mods(cfg, state)
    assert (pmods.recon_train.height, pmods.recon_train.width) == RESIZED

    jpipe, pipe = reduced_pipelines("ess_supervised", train=False)
    want = jax.device_get(jax_sup.make_eval_step(mods, jpipe)(state, jbatch))
    got = supervised.make_eval_step(pmods, pipe)(batch)
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
        logits = pmods.head(pmods.recon_val.rollout(windows)[2])[1]
    top2 = logits.topk(2, dim=1).values
    close = (top2[:, 0] - top2[:, 1] < 1e-4).numpy()
    pred_p, pred_j = got["pred"].numpy(), np.asarray(want["pred"])
    assert np.all((pred_p == pred_j) | close)
    label = cols["label"]
    assert float(got["cm"].sum()) == float((label != 255).sum())
    moved = np.abs(np.asarray(want["cm"]) - got["cm"].numpy()).sum()
    assert moved <= 2 * int((close & (pred_p != pred_j)).sum())

    jpipe, pipe = reduced_pipelines("ess_supervised", train=True)
    jstep = jax_sup.make_train_step(mods, jpipe)
    step = supervised.make_train_step(pmods, pipe)
    pstate = init_state(pmods)
    for s in range(2):
        jaug = jpipe.sample_augment(
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), s), B,
            train=True)
        state, out = jstep(state, jbatch)
        got = step(pstate, batch, to_port_aug(jaug))
        np.testing.assert_allclose(float(got["loss"]), float(out["loss"]),
                                   rtol=1e-4)
    _, want_head = params_from_jax(jax.device_get(state.e2vid_params),
                                   jax.device_get(state.back_params))
    for k, v in pmods.head.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_head[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


# A ReLU input within this share of its tensor's largest lies within f32
# rounding of 0 (the ones seen to take the other side sit at 1e-7 to 1e-5).
ROUNDING = 1e-5
GRAD_REL_F64 = 1e-3


class ReluDecisions(TorchFunctionMode):
    """The port's forward with each ReLU written as its input times its
    decision (input > 0, detached), the units ``flips`` (call, flat index)
    taking the other side; every ReLU's input is kept. f64 tensors stay
    f64 through ``.float()``, so the losses run in f64 too."""
    RELUS = (torch.relu, F.relu, torch.Tensor.relu)

    def __init__(self, flips=()):
        super().__init__()
        self.flips, self.inputs = list(flips), []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float and args[0].dtype == torch.float64:
            return args[0]
        if func not in self.RELUS:
            return func(*args, **(kwargs or {}))
        z, call = args[0], len(self.inputs)
        self.inputs.append(z.detach().reshape(-1))
        on = (z > 0).to(z.dtype).reshape(-1)
        for c, j in self.flips:
            if c == call:
                on[j] = 1 - on[j]
        return z * on.reshape(z.shape)


def f64_gradients(pmods, modules, inputs, flips=()):
    """The port's UDA gradients in f64, as its train step routes them (the
    front loss to the front, the head loss to the head), of ``uda_losses``
    on f64 copies of ``modules`` (the front and the head), with the ReLU
    ``flips``; and every ReLU's input."""
    front, head = (copy.deepcopy(m).double() for m in modules)
    for m in (*front.modules(), *head.modules()):
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    img_a, labels_a, img_fake, latent_real = inputs
    with ReluDecisions(flips) as mode:
        _, front_loss, head_loss = uda.uda_losses(
            pmods, front, head, img_a=img_a.double(), labels_a=labels_a,
            img_fake=img_fake.double(),
            latent_real={k: v.double() for k, v in latent_real.items()})
    grads = {}
    for prefix, module, loss in (("front", front, front_loss),
                                 ("head", head, head_loss)):
        named = [(k, p) for k, p in module.named_parameters()
                 if p.requires_grad]
        gs = torch.autograd.grad(loss, [p for _, p in named],
                                 retain_graph=True)
        grads.update({f"{prefix}.{k}": g for (k, _), g in zip(named, gs)})
    return grads, mode.inputs


def near_zero_units(inputs):
    """(call, flat index) of every nonzero ReLU input within
    :data:`ROUNDING` of its tensor's largest, the nearest to 0 (relative
    to its tensor's largest) first."""
    units = []
    for c, z in enumerate(inputs):
        m = float(z.abs().max())
        near = torch.nonzero((z != 0) & (z.abs() <= ROUNDING * m)).reshape(-1)
        units += [(float(z[j].abs()) / m, c, int(j)) for j in near]
    return [(c, j) for _, c, j in sorted(units)]


def excess(got, g64, deltas, chosen):
    """The worst tensor's ``(max|got - g| - 3e-5) / max|g|``, g the f64
    gradient with the flips ``chosen`` (their deltas added)."""
    worst = -1.0
    for k, g in g64.items():
        g = g + sum((deltas[i][k] for i in chosen), torch.zeros_like(g))
        err = float((got[k].double() - g).abs().max())
        worst = max(worst, (err - 3e-5) / max(float(g.abs().max()), 1e-30))
    return worst


def explain(got, g64, deltas):
    """A set of flips under which ``got`` is within :data:`GRAD_REL_F64` of
    the f64 gradient, found greedily, and the excess it leaves."""
    chosen, best = [], excess(got, g64, deltas, [])
    while best > GRAD_REL_F64:
        cands = [(excess(got, g64, deltas, chosen + [i]), i)
                 for i in range(len(deltas)) if i not in chosen]
        if not cands or min(cands)[0] >= best:
            break
        best, i = min(cands)
        chosen.append(i)
    return chosen, best


@pytest.fixture(scope="module")
def uda_setup():
    """The reduced UDA config, the JAX modules and jitted step (compiled
    once for every seed), the port's pipeline, and JAX's draws of the
    bottom-anchored crop and the flip."""
    cfg = reduced_cfg("ess")
    jpipe, pipe = reduced_pipelines("ess", train=True)
    jaug = jpipe.sample_augment(
        jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), 0), B,
        train=True)
    mods = jax_build(cfg)
    return cfg, mods, jax_uda.make_train_step(mods, jpipe), pipe, \
        to_port_aug(jaug)


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_uda_train_step_at_reduced_ddd17_geometry(uda_setup, seed):
    """One UDA train step (non-DSEC routing, event labels off) on JAX's
    draws of the bottom-anchored crop and the flip, at four batch seeds:
    every loss rtol 1e-4, BN running statistics atol 1e-5, and the implied
    gradients of the front and the head.

    At this tiny geometry a ReLU input can lie within f32 rounding of 0
    (1e-7 to 1e-5 of its tensor's largest); one package's f32 forward then
    puts it on the other side of 0 from the other's, and that one unit
    moves a tensor's gradient by up to 8 % of its largest (seed 5: the
    port's f32 step; seeds 1 and 2: JAX's). So both packages' f32
    gradients are held against the port's f64 gradient on the port's
    rollout outputs, with each ReLU input within :data:`ROUNDING` of 0
    allowed either side (a flip's delta is an f64 run with that one unit
    flipped; each seed here needs at most one): within 0.1 % of each
    tensor's largest plus 3e-5 (the head's biases before an instance norm
    have a zero gradient in exact math and ~1e-5 of rounding), fifty times
    tighter than the 5 % of the direct f32 comparison in
    tests/test_torch_uda.py. A routing fault, such as ``t_ev``'s target
    left attached, leaves JAX's gradient far outside it whatever units
    are flipped."""
    cfg, mods, jstep, pipe, aug = uda_setup
    rng = np.random.default_rng(seed)
    cols = binned_batch(rng, B, T, N, SH, SW, RESIZED)
    del cols["label"]
    ha, wa = UDA_CROP
    label_a = rng.integers(0, 6, (B, ha, wa)).astype(np.int64)
    image_a = rng.normal(size=(B, ha, wa, 1)).astype(np.float32)
    assert aug.crop_y.eq(RESIZED[0] - ha).all() and aug.flip.any()

    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_mods(cfg, state)
    jbatch = {k: jnp.asarray(v) for k, v in cols.items()}
    jbatch.update(image_a=jnp.asarray(image_a),
                  label_a=jnp.asarray(label_a, jnp.int32))
    new_state, want = jax.device_get(jstep(state, jbatch))
    want_front = front_from_jax(new_state.front_params,
                                new_state.front_batch_stats)
    _, want_head = params_from_jax(new_state.e2vid_params,
                                   new_state.back_params)

    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    recon = pmods.recon_train
    with torch.no_grad():
        windows, _ = pipe.build_all(batch, aug=aug,
                                    out_dtype=recon.model.dtype)
        img_fake, _, latent_real = recon.rollout(windows)
    batch["image_a"] = torch.from_numpy(image_a).permute(0, 3, 1, 2)
    batch["label_a"] = torch.from_numpy(label_a)
    inputs = (batch["image_a"], batch["label_a"], img_fake, latent_real)
    modules = [copy.deepcopy(m) for m in (pmods.front_a, pmods.head)]
    g64, relu_inputs = f64_gradients(pmods, modules, inputs)

    front0 = {k: v.clone() for k, v in pmods.front_a.state_dict().items()}
    head0 = {k: v.clone() for k, v in pmods.head.state_dict().items()}
    got = uda.make_train_step(pmods, pipe)(init_state(pmods), batch, aug)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    lr = 1e-2
    g_port, g_jax = {}, {}
    for prefix, module, before, after in (
            ("front", pmods.front_a, front0, want_front),
            ("head", pmods.head, head0, want_head)):
        for k, v in module.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), after[k].numpy(),
                                           atol=1e-5, rtol=0, err_msg=k)
                continue
            g_port[f"{prefix}.{k}"] = (before[k] - v) / lr
            g_jax[f"{prefix}.{k}"] = (before[k] - after[k]) / lr
    assert sorted(g_port) == sorted(g64)

    # each flip's delta is one f64 run: they are computed in the units'
    # order, only until the greedy search explains both gradients (a
    # routing fault computes them all and is still far outside the bound)
    units, deltas = near_zero_units(relu_inputs), []
    for name, g in (("port", g_port), ("jax", g_jax)):
        chosen, worst = explain(g, g64, deltas)
        while worst > GRAD_REL_F64 and len(deltas) < len(units):
            g_flip, _ = f64_gradients(pmods, modules, inputs,
                                      [units[len(deltas)]])
            deltas.append({k: g_flip[k] - g64[k] for k in g64})
            chosen, worst = explain(g, g64, deltas)
        assert worst <= GRAD_REL_F64, (name, worst,
                                       [units[i] for i in chosen])
