"""The YAML's model and event options through the port's train CLI on the
CPU, against the JAX package.

``tests/test_cli.py``'s DDD17 YAML (``ess_supervised``, base 8, f32, B=2,
T=2 windows of 512 events, 200x346 -> 200x352, one epoch) on a
``make_ddd17_dir`` tree, with one key changed: ``event_representation``
``'histogram'`` or ``'ev_segnet'`` (the loaders then send tile-sorted raw
events), ``e2vid_recurrent_block: 'convgru'``, ``e2vid_norm: 'IN'`` or
``skip_connect_task: False``. ``ess_tpu_torch.cli.train.main`` trains from
the JAX package's initial weights for the same YAML and prints the JAX
CLI's summary keys with finite values; its first train step's loss is
within 1e-4 (relative) of JAX ``make_train_step``'s from the same weights
on the windows the port's pipeline built from that step's batch (the
windows themselves are held against JAX's by
``tests/test_torch_representations.py`` and the DDD17 tests).

A resume of a ConvGRU, instance-norm, plain-head or histogram run is bit
for bit the uninterrupted run (``tests/test_torch_loop.py``'s check of the
default model: two epochs against one, a resume and one more).
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.core.config import load_config as jax_load_config
from ess_tpu.train import supervised as jax_sup
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.cli import train
from ess_tpu_torch.core.config import CheckpointConfig, load_config
from ess_tpu_torch.io.convert import params_from_jax
from ess_tpu_torch.train import loop
from ess_tpu_torch.train.builder import make_pipeline
from tests.test_loop import loop_config
from tests.test_torch_cli import summary_lines, tree, yaml_for  # noqa: F401
from tests.test_torch_eval_step import port_config
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import (one_torch_thread, port_trainer,
                                   resuming, state_tensors)

pytest.importorskip("cv2")

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

MODEL = "e2vid_base_channels: 8"
EDITS = {
    "histogram": {"event_representation: 'voxel_grid'":
                  "event_representation: 'histogram'"},
    "ev_segnet": {"event_representation: 'voxel_grid'":
                  "event_representation: 'ev_segnet'"},
    "convgru": {MODEL: MODEL + "\n  e2vid_recurrent_block: 'convgru'"},
    "IN": {MODEL: MODEL + "\n  e2vid_norm: 'IN'"},
    "plain_head": {"skip_connect_task: True": "skip_connect_task: False"},
}


@pytest.mark.parametrize("option", list(EDITS))
def test_train_cli_runs_the_option_as_jax(monkeypatch, tmp_path, tree,
                                          option):
    path = yaml_for(tmp_path, tree, edits=EDITS[option])
    mods = jax_build(jax_load_config(path))
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    e2vid_sd, head_sd = params_from_jax(jax.device_get(state.e2vid_params),
                                        jax.device_get(state.back_params))
    first = {}

    class Trainer(loop.Trainer):
        def __init__(self, cfg, **kw):
            kw.update(e2vid_state=e2vid_sd)
            super().__init__(cfg, **kw)
            self.state.head.load_state_dict(head_sd)
            step = self.train_step

            def tapped(state, batch, *args):
                if not first:
                    first["batch"] = {k: v.clone() for k, v in batch.items()}
                out = step(state, batch, *args)
                first.setdefault("loss", float(out["loss"]))
                return out

            self.train_step = tapped

    monkeypatch.setattr(loop, "Trainer", Trainer)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--settings_file", path], device="cpu")
    summary = summary_lines(out.getvalue())
    assert "semseg_sensor_b_mean_iou" in summary
    assert all(np.isfinite(float(v)) for v in summary.values())

    cfg = load_config(path)
    offsets = ("ev_tile_offsets" if option in ("histogram", "ev_segnet")
               else "ev_band_offsets")
    assert offsets in first["batch"]
    with torch.no_grad():
        windows, label = make_pipeline(cfg, train=True).build_all(
            first["batch"])
    assert windows.shape[2] == cfg.dataset.sensor_b.input_channels
    _, want = jax_sup.make_train_step(mods)(state, {
        "events": jnp.asarray(windows.permute(1, 0, 3, 4, 2).numpy()),
        "label": jnp.asarray(label.numpy().astype(np.int32))})
    np.testing.assert_allclose(first["loss"], float(want["loss"]),
                               rtol=1e-4)


RESUMED = {"convgru": dict(e2vid_recurrent_block="convgru"),
           "IN": dict(e2vid_norm="IN"),
           "plain_head": dict(skip_connect_task=False)}


@pytest.mark.parametrize("option", list(RESUMED) + ["histogram"])
def test_resume_is_bit_identical(tmp_path, option):
    cfg = port_config(loop_config("ess_supervised", tmp_path))
    if option == "histogram":
        cfg = cfg.replace(dataset=dataclasses.replace(
            cfg.dataset, sensor_b=dataclasses.replace(
                cfg.dataset.sensor_b, event_representation="histogram")))
    else:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    **RESUMED[option]))
    one = dataclasses.replace(cfg.optim, num_epochs=1)
    whole = port_trainer(tmp_path, run="whole", shuffle=False, cfg=cfg)
    whole.run()
    half = port_trainer(tmp_path, run="half", shuffle=False,
                        cfg=cfg.replace(optim=one))
    half.run()
    resumed = port_trainer(tmp_path, run="resumed", shuffle=False,
                           cfg=resuming(cfg).replace(
                               checkpoint=CheckpointConfig(
                                   save_checkpoint=True,
                                   resume_training=True,
                                   resume_file=half.log_dir)))
    assert (resumed.epoch, resumed.step_count) == (1, 3)
    resumed.run()
    got, want = state_tensors(resumed), state_tensors(whole)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
