"""Train and eval steps on this rank's rows of global batches.

:func:`run_steps` runs one spec: the steps of ``cfg`` (supervised or UDA)
on each global batch of the spec, this rank taking its rows. On one device
(no active group) it runs the whole batches, so the same spec through
``launch.spawn`` on N ranks and in-process gives the data-parallel and the
one-device results of one computation, which the tests (and, on the card,
``chip_smoke.py``) hold against each other.

A spec is a dict:

- ``cfg``: the Config; ``device``: where the modules live (default: the
  group's device, else the CPU);
- ``state``: state dicts of ``e2vid``, ``head`` and (UDA) ``front``, CPU
  tensors (default: ``init_params`` seeded with ``cfg.seed``);
- ``pipeline_train`` / ``pipeline_val``: PipelineConfigs (default
  ``make_pipeline``'s);
- ``train``: global batches, one train step each (dicts of numpy arrays as
  the step takes them, images NCHW, or ``.npz`` paths of such dicts),
  each with the step's own augmentation draws;
- ``eval``: global batches of the supervised eval step or of UDA's event
  eval step; ``eval_a``: global image batches of UDA's image eval step;
  they run first, on the initial state;
- ``resume``: a directory: after the train steps, save a checkpoint there,
  run one more step on the last batch, restore the checkpoint and run that
  step again; both steps' losses and parameters are returned;
- ``timed``: that many more train steps on the first batch, timed.

The result: ``train`` (each step's losses), ``eval`` / ``eval_a`` (each
batch's losses and confusion matrices summed over the ranks), ``state``
(the state dicts after the train steps; ``state0`` the trainable ones
before them), ``launches_train`` /
``launches_eval`` (this rank's kernel launches in them), ``resume``,
``ms_per_step``, ``peak_bytes`` (the device's peak allocation), ``rank``
and ``world``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ess_tpu_torch.data.pipeline import EventPipeline
from ess_tpu_torch.io.checkpoint import CheckpointManager
from ess_tpu_torch.ops import conv3x3, conv_lstm, voxel_folded, voxel_tiled
from ess_tpu_torch.parallel import dp
from ess_tpu_torch.train import supervised as sup
from ess_tpu_torch.train import uda as uda_mod
from ess_tpu_torch.train.builder import (
    build_modules, init_params, init_state, make_pipeline)


def launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters on the train and eval paths."""
    return {"voxel_folded": voxel_folded.launches,
            "voxel_tiled": voxel_tiled.launches,
            "conv_lstm": conv_lstm.launches,
            "conv_lstm_int8": conv_lstm.launches_int8,
            "conv_lstm_int8_prep": conv_lstm.launches_int8_prep,
            "conv3x3": conv3x3.launches,
            "conv3x3_int8": conv3x3.launches_int8,
            "conv3x3_int8_prep": conv3x3.launches_int8_prep}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on(batch, device: torch.device) -> dict:
    """This rank's rows of a global host batch (a dict, or the path of an
    ``.npz`` file of one), as tensors on ``device``."""
    if isinstance(batch, str):
        with np.load(batch) as f:
            batch = dict(f)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v
            for k, v in dp.shard_batch(batch).items()}


def _host(out: dict) -> dict:
    """An eval step's losses as floats and its confusion matrices summed
    over the ranks."""
    res = {}
    for k, v in out.items():
        if k.endswith("_loss") or k == "loss":
            res[k] = float(v)
        elif k.startswith("cm"):
            res[k] = dp.host_sum(v.double().cpu().numpy())
    return res


def _state_dicts(state) -> dict:
    return {name: {k: v.detach().cpu().clone()
                   for k, v in getattr(state, name).state_dict().items()}
            for name in ("e2vid", "head", "front")
            if getattr(state, name) is not None}


def run_steps(spec: dict) -> dict:
    cfg = spec["cfg"]
    group = dp.active()
    device = torch.device(spec.get("device")
                          or (group.device if group else "cpu"))
    uda = cfg.model.model_name == "ess"
    mods = build_modules(cfg, device=device)
    init_params(mods, torch.Generator().manual_seed(cfg.seed))
    for name, sd in (spec.get("state") or {}).items():
        getattr(mods, "front_a" if name == "front" else name).load_state_dict(
            sd)
    state = init_state(mods)
    pipes = [EventPipeline(spec[k]) if spec.get(k) else
             make_pipeline(cfg, train=k == "pipeline_train")
             for k in ("pipeline_train", "pipeline_val")]
    if uda:
        train_step = uda_mod.make_train_step(mods, pipes[0])
        eval_step = uda_mod.make_eval_step_b(mods, pipes[1])
        eval_a = uda_mod.make_eval_step_a(mods)
    else:
        train_step = sup.make_train_step(mods, pipes[0])
        eval_step = sup.make_eval_step(mods, pipes[1])
    batches = [_on(b, device) for b in spec.get("train", [])]
    out: dict = {"rank": dp.rank(), "world": dp.world()}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def losses(got) -> dict:
        return {k: float(v) for k, v in got.items()}

    n0 = launch_counts()
    out["eval"] = [_host(eval_step(_on(b, device)))
                   for b in spec.get("eval", [])]
    if uda:
        out["eval_a"] = [_host(eval_a(_on(b, device)))
                         for b in spec.get("eval_a", [])]
    _sync(device)
    out["launches_eval"] = _since(n0)
    out["state0"] = {k: v for k, v in _state_dicts(state).items()
                     if k != "e2vid"}
    n0 = launch_counts()
    out["train"] = [losses(train_step(state, b)) for b in batches]
    _sync(device)
    out["launches_train"] = _since(n0)
    out["state"] = _state_dicts(state)
    if spec.get("resume"):
        ckpt = CheckpointManager(spec["resume"])
        ckpt.save(state.step, state)
        live = losses(train_step(state, batches[-1]))
        live_state = _state_dicts(state)
        ckpt.restore(state)
        again = losses(train_step(state, batches[-1]))
        out["resume"] = {"live": live, "resumed": again,
                         "live_state": live_state,
                         "resumed_state": _state_dicts(state)}
    if spec.get("timed"):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(spec["timed"]):
            got = train_step(state, batches[0])
        float(got["loss"])
        _sync(device)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / spec["timed"]
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out
