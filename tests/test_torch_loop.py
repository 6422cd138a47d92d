"""The port's trainer (``ess_tpu_torch.train.loop.Trainer``) against
the JAX ``Trainer`` on the CPU, and the JAX loop tests ported (the UDA
comparison runs in ``tests/test_torch_loop_uda.py``, on these helpers).

Both trainers run ``tests/test_loop.py``'s configs (synthetic events,
E2VID base 8, f32, no augmentation, two epochs of three steps) on the same
``SyntheticEvents`` / ``SyntheticImages`` loaders without shuffling, the
port's parameters carried over from the JAX trainer's initial ones
(``params_from_jax``, ``front_from_jax``). Each writer logs every train
loss (``flush_every`` 1), so ``metrics.jsonl`` holds both runs step by
step.

The JAX comparisons run at 32x32 instead of the loop tests' 16x16. At
16x16 the head's first stage works on a 2x2 latent, whose instance norms
leave the loss's gradient discontinuous at the parameters the JAX run
reaches after one step: moving the head by f32 rounding moves some
gradient entries by a large part of their size, so two f32
implementations part at the second update. At 32x32 (a 4x4 latent) the
runs hold the bounds below.

Bounds (the train-step tests' bounds: the same f32 math in other
summation orders): per-step losses rtol 1e-4; head and front parameters
and the front's batch-norm statistics atol 1e-5 after the run; the
validation confusion matrices equal, so the mIoU and accuracy summaries
are too. The biases of the head's convs that an instance norm follows are
left out of the parameter bound: the norm subtracts them again, so their
gradient is 0 but for f32 rounding noise, which RAdam's rectified steps
(from step 5) scale to about ``lr * r`` with the noise's sign; they change
no output of the head. A resumed run is bit-identical to an uninterrupted
one.
"""

import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from ess_tpu.data.loader import BatchLoader as JaxBatchLoader
from ess_tpu.data.synthetic import SyntheticEvents as JaxSyntheticEvents
from ess_tpu.data.synthetic import SyntheticImages as JaxSyntheticImages
from ess_tpu.train.loop import Trainer as JaxTrainer
from ess_tpu.utils.viz import count_params as jax_count_params

from ess_tpu_torch.core.config import CheckpointConfig
from ess_tpu_torch.data.loader import BatchLoader
from ess_tpu_torch.data.synthetic import SyntheticEvents, SyntheticImages
from ess_tpu_torch.io.checkpoint import AUTOSAVE_BASE, CheckpointManager
from ess_tpu_torch.io.convert import front_from_jax, params_from_jax
from ess_tpu_torch.models.layers import INSResBlock, ReLUINSConv2d
from ess_tpu_torch.train.loop import Trainer
from ess_tpu_torch.utils.viz import count_params
from tests.test_loop import loop_config
from tests.test_torch_eval_step import port_config

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
PARITY_SIZE = 32   # the JAX comparisons' sensor (module docstring)


def one_torch_thread():
    """A generator for a module-scoped autouse fixture: torch runs its ops
    on one thread for the module's tests and gets its thread count back
    afterwards. At these sizes more threads only spin: beside the other
    test workers on the same cores they slowed these tests tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


def event_loaders(pkg=None, n=6, shuffle=True, size=16):
    events, loader = ((JaxSyntheticEvents, JaxBatchLoader) if pkg == "jax"
                      else (SyntheticEvents, BatchLoader))
    ds = events(length=n, height=size, width=size, nr_events_data=2,
                nr_events_window=128)
    return (loader(ds, 2, shuffle=shuffle, num_workers=2),
            loader(ds, 2, shuffle=False, drop_last=False, num_workers=2))


def image_loaders(pkg=None, shuffle=True, size=16):
    images, loader = ((JaxSyntheticImages, JaxBatchLoader) if pkg == "jax"
                      else (SyntheticImages, BatchLoader))
    imgs = images(length=4, height=size, width=size)
    return (loader(imgs, 2, shuffle=shuffle, num_workers=2),
            loader(imgs, 2, shuffle=False, drop_last=False, num_workers=2))


def loaders(pkg, uda, shuffle=True, size=16):
    train_b, val_b = event_loaders(pkg, shuffle=shuffle, size=size)
    kw = dict(train_b=train_b, val_b=val_b)
    if uda:
        kw["train_a"], kw["val_a"] = image_loaders(pkg, shuffle=shuffle,
                                                   size=size)
    return kw


def sized_config(model_name, tmp, size):
    """``tests/test_loop.py``'s config with a ``size`` x ``size`` sensor
    and images."""
    cfg = loop_config(model_name, tmp)
    ds = cfg.dataset
    return cfg.replace(dataset=dataclasses.replace(
        ds, sensor_a=dataclasses.replace(ds.sensor_a, shape=(size, size)),
        sensor_b=dataclasses.replace(ds.sensor_b, shape=(size, size))))


def norm_cancelled(head) -> set:
    """Names of the head's conv biases that an instance norm follows."""
    out = set()
    for name, mod in head.named_modules():
        if isinstance(mod, (INSResBlock, ReLUINSConv2d)):
            for cname, conv in mod.named_modules():
                if isinstance(conv, torch.nn.Conv2d) and conv.bias is not None:
                    out.add(f"{name}.{cname}.bias")
    return out


def records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def scalars(log_dir, prefix):
    """{tag: [values in order]} of the scalar records under ``prefix``."""
    out = {}
    for r in records(log_dir):
        for k, v in r.items():
            if k.startswith(prefix):
                out.setdefault(k, []).append(v)
    return out


def run_pair(tmp_path, model_name):
    """Both trainers over the same data from the same weights; returns
    (JAX trainer, its summary, port trainer, its summary)."""
    uda = model_name == "ess"
    jcfg = sized_config(model_name, tmp_path, PARITY_SIZE)
    jtr = JaxTrainer(jcfg, log_dir=str(tmp_path / "jax"),
                     **loaders("jax", uda, False, PARITY_SIZE))
    st = jax.device_get(jtr.state)
    e2vid_sd, head_sd = params_from_jax(st.e2vid_params, st.back_params)
    front_sd = (front_from_jax(st.front_params, st.front_batch_stats)
                if uda else None)
    tr = Trainer(port_config(jcfg), log_dir=str(tmp_path / "port"),
                 e2vid_state=e2vid_sd, front_state=front_sd, device="cpu",
                 **loaders(None, uda, False, PARITY_SIZE))
    tr.state.head.load_state_dict(head_sd)
    jtr.writer.flush_every = tr.writer.flush_every = 1
    return jtr, jtr.run(), tr, tr.run()


def check_pair(jtr, want, tr, got):
    assert tr.step_count == jtr.step_count == 2 * 3
    assert tr.state.step == int(np.asarray(jtr.state.step)) == 6
    losses = scalars(tr.log_dir, "train/")
    want_losses = scalars(jtr.log_dir, "train/")
    assert sorted(losses) == sorted(want_losses) and "train/loss" in losses
    for k, v in want_losses.items():
        assert len(losses[k]) == len(v) == 6, k
        np.testing.assert_allclose(losses[k], v, rtol=LOSS_RTOL, err_msg=k)
    val = scalars(tr.log_dir, "val/")
    want_val = scalars(jtr.log_dir, "val/")
    assert sorted(val) == sorted(want_val)
    for k, v in want_val.items():
        np.testing.assert_allclose(val[k], v, rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_array_equal(got["cm_b"], want["cm_b"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)

    st = jax.device_get(jtr.state)
    _, want_head = params_from_jax(st.e2vid_params, st.back_params)
    head = tr.state.head.state_dict()
    cancelled = norm_cancelled(tr.state.head)
    assert len(cancelled) == 16 and cancelled < set(want_head)
    for k, v in want_head.items():
        if k in cancelled:
            continue
        np.testing.assert_allclose(head[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, err_msg=k)
    if st.front_params is not None:
        want_front = front_from_jax(st.front_params, st.front_batch_stats)
        front = tr.state.front.state_dict()
        for k, v in want_front.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(front[k].numpy(), v.numpy(),
                                           atol=PARAM_ATOL, err_msg=k)


def test_supervised_run_matches_jax(tmp_path):
    jtr, want, tr, got = run_pair(tmp_path, "ess_supervised")
    check_pair(jtr, want, tr, got)
    assert 0 <= got["semseg_sensor_b_mean_iou"] <= 100
    assert tr.ckpt.latest_epoch() == 1
    assert os.path.exists(os.path.join(tr.log_dir, "metrics.jsonl"))


def test_count_params_matches_jax(tmp_path):
    from ess_tpu.train.builder import build_modules as jax_build
    from ess_tpu.train.builder import init_state as jax_init_state
    from ess_tpu_torch.train.builder import build_modules

    cfg = loop_config("ess", tmp_path)
    st = jax_init_state(jax_build(cfg), jax.random.PRNGKey(0))
    mods = build_modules(port_config(cfg), device="cpu")
    assert count_params(mods.head) == jax_count_params(st.back_params)
    assert count_params(mods.e2vid) == jax_count_params(st.e2vid_params)
    assert count_params(mods.front_a) == jax_count_params(st.front_params)
    assert count_params(mods.head.state_dict()) == count_params(mods.head)


def port_trainer(tmp_path, model_name="ess_supervised", run="run",
                 shuffle=True, **kw):
    cfg = kw.pop("cfg", None) or port_config(loop_config(model_name,
                                                         tmp_path))
    return Trainer(cfg, log_dir=str(tmp_path / run), device="cpu",
                   **{**loaders(None, model_name == "ess", shuffle), **kw})


def resuming(cfg):
    return cfg.replace(checkpoint=CheckpointConfig(save_checkpoint=True,
                                                   resume_training=True))


def test_supervised_loop_resume(tmp_path):
    tr = port_trainer(tmp_path, val_b=None)
    tr.run()
    assert tr.state.step == 6

    tr2 = port_trainer(tmp_path, cfg=resuming(tr.cfg), val_b=None)
    assert tr2.epoch == 2  # resumes past both epochs
    assert tr2.state.step == 6
    assert tr2.step_count == 6


def test_resume_from_mid_epoch_autosave(tmp_path):
    """A save between epochs resumes from the step autosave: step_count
    continues, the interrupted epoch runs again."""
    tr = port_trainer(tmp_path, val_b=None, save_every_steps=2)
    tr.train_epoch()  # 3 steps: one autosave at step 2, no epoch save yet
    tr.ckpt.wait()
    assert tr.ckpt.latest_epoch() is None
    assert tr.ckpt.latest() == AUTOSAVE_BASE + 2
    assert tr.ckpt.restore_metadata(AUTOSAVE_BASE + 2) == {
        "epoch": 0, "step_count": 2}

    tr2 = port_trainer(tmp_path, cfg=resuming(tr.cfg), val_b=None)
    assert tr2.step_count == 2
    assert tr2.state.step == 2
    assert tr2.state.opt_back.step_count == 2
    assert tr2.epoch == 0


def state_tensors(tr):
    """Every tensor of the train state: the head, the front and their
    RAdam moments, and the optimizer steps."""
    out = {"step": torch.tensor(tr.state.step)}
    for name in ("head", "front", "e2vid", "opt_back", "opt_front"):
        part = getattr(tr.state, name)
        if part is None:
            continue
        sd = part.state_dict()
        if name.startswith("opt"):
            out[f"{name}.step_count"] = torch.tensor(sd["step_count"])
            for i, st in sd["state"].items():
                for k, v in st.items():
                    out[f"{name}.{i}.{k}"] = v
        else:
            out.update({f"{name}.{k}": v for k, v in sd.items()})
    return out


@pytest.mark.parametrize("model_name", ["ess_supervised", "ess"])
def test_resume_is_bit_identical(tmp_path, model_name):
    """Two epochs in a row against one epoch, a resume and one more epoch:
    the same head, front, RAdam moments and steps, bit for bit."""
    cfg = port_config(loop_config(model_name, tmp_path))
    one = dataclasses.replace(cfg.optim, num_epochs=1)
    whole = port_trainer(tmp_path, model_name, "whole", shuffle=False,
                         cfg=cfg)
    whole.run()
    half = port_trainer(tmp_path, model_name, "half", shuffle=False,
                        cfg=cfg.replace(optim=one))
    half.run()
    resumed = port_trainer(tmp_path, model_name, "resumed", shuffle=False,
                           cfg=resuming(cfg).replace(
                               checkpoint=CheckpointConfig(
                                   save_checkpoint=True,
                                   resume_training=True,
                                   resume_file=half.log_dir)))
    assert (resumed.epoch, resumed.step_count) == (1, 3)
    summary = resumed.run()
    assert resumed.step_count == whole.step_count == 6
    got, want = state_tensors(resumed), state_tensors(whole)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert np.isfinite(summary["semseg_sensor_b_mean_iou"])


def test_restore_pretrained_skips_frozen(tmp_path):
    """restore_pretrained loads the trainable nets, the front's batch-norm
    buffers included, but keeps the template's frozen E2VID, optimizers
    and step; ``skip_frozen=False`` takes the E2VID too; ``restore`` takes
    everything."""
    cfg = port_config(loop_config("ess", tmp_path))
    trained = port_trainer(tmp_path, "ess", "a", cfg=cfg)
    trained.train_epoch()
    with torch.no_grad():
        for p in trained.state.e2vid.parameters():
            p.add_(1.0)   # a backbone that differs from the template's
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(0, trained.state, wait=True)
    saved = {k: v.clone() for k, v in state_tensors(trained).items()}

    template = port_trainer(tmp_path, "ess", "b", cfg=cfg)
    before = {k: v.clone() for k, v in state_tensors(template).items()}
    ckpt.restore_pretrained(template.state)
    got = state_tensors(template)
    for k in got:
        src = saved if k.startswith(("head.", "front.")) else before
        assert torch.equal(got[k], src[k]), k
    assert int(template.state.front.bn1.num_batches_tracked) == 6
    assert template.state.step == 0

    ckpt.restore_pretrained(template.state, skip_frozen=False)
    got = state_tensors(template)
    for k in got:
        assert torch.equal(got[k], (before if k.startswith("opt") or
                                    k == "step" else saved)[k]), k
    ckpt.restore(template.state)
    got = state_tensors(template)
    for k in got:
        assert torch.equal(got[k], saved[k]), k
    ckpt.close()


def test_checkpoints_are_written_whole(tmp_path, monkeypatch):
    """A save that fails leaves no checkpoint under its key and no
    temporary directory; only the newest ``max_to_keep`` saves stay."""
    tr = port_trainer(tmp_path)
    ckpt = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for key in (0, 1, 2):
        ckpt.save(key, tr.state, metadata={"epoch": key})
    assert ckpt.all_keys() == [1, 2] and ckpt.latest() == 2

    def broken(obj, path):
        with open(path, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError):
        ckpt.save(3, tr.state)
    assert sorted(os.listdir(ckpt.directory)) == ["1", "2"]
    assert ckpt.restore_metadata(2) == {"epoch": 2}
    assert ckpt.restore_metadata(1) == {"epoch": 1}


def test_trainer_raises_without_a_gpu(tmp_path):
    """The Trainer builds on the first CUDA device unless asked for
    another; with none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_config(loop_config("ess_supervised", tmp_path))
    train_b, _ = event_loaders()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, train_b=train_b, log_dir=str(tmp_path / "x"))


def test_observability_wiring(tmp_path):
    """Validation writes the latent-PCA grids, the sensor-A image grid and
    the embedding TSV dump, and the train-set statistics pass runs."""
    cfg = port_config(loop_config("ess", tmp_path))
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, do_val_training_epoch=True))
    tr = port_trainer(tmp_path, "ess", "obs", cfg=cfg,
                      profile_steps=(1, 2))
    tr.validate()
    stats = tr.train_stats_epoch()
    assert "train_stats_sensor_a_mean_iou" in stats
    assert "train_stats_sensor_b_mean_iou" in stats

    dumps = glob.glob(os.path.join(tr.log_dir, "embeddings", "*.tsv"))
    assert dumps, "no embedding dump written"
    rows = np.loadtxt(dumps[0], delimiter="\t")
    assert rows.shape == (6, 64)  # the whole val_b set, latent8 pooled

    tr.train_epoch()  # profiles step 2
    trace = os.path.join(tr.log_dir, "profile", "trace.json")
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    tr.writer.flush()
    logged = {r.get("image") for r in records(tr.log_dir)}
    assert "val_events/pca_latent_space" in logged
    assert "val_img/pca_latent_space" in logged
    assert "val_img/sensor_a" in logged
    assert "val/sensor_b" in logged
