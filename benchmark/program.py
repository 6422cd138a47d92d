"""The system under test: the port ``ess_tpu_torch``, built from a
configuration file, loaded with the benchmark's weights and fed the
benchmark's events on its own host wires.

This is the only module of the benchmark, with the drivers, that imports
the program; the reference imports nothing of it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ess_tpu_torch.core.config import (
    Config, DatasetConfig, EventDatasetConfig, ImageDatasetConfig,
    ModelConfig, OptimConfig, TaskConfig)
from ess_tpu_torch.ops import voxel_folded, voxel_tiled
from ess_tpu_torch.train import builder, streaming, supervised, uda


def config(conf: dict, model_name: str) -> Config:
    """The program's Config of a benchmark configuration: the YAML's
    sizes, losses and learning rates, augmentation off, the train rollout
    on the int8 cell where the configuration says so."""
    size_a = tuple(conf["resize_to"] or conf["shape_b"])
    return Config(
        dataset=DatasetConfig(
            sensor_a=ImageDatasetConfig(shape=size_a, random_crop=False),
            sensor_b=EventDatasetConfig(
                name=conf["dataset_b"], shape=tuple(conf["shape_b"]),
                nr_events_data=conf["windows"],
                nr_temporal_bins=conf["bins"],
                nr_events_window=conf["events_per_window"])),
        model=ModelConfig(
            model_name=model_name, compute_dtype=conf["compute_dtype"],
            data_augmentation_train=False,
            e2vid_base_channels=conf["e2vid_base_channels"],
            e2vid_num_encoders=conf["e2vid_num_encoders"],
            e2vid_num_residual_blocks=conf["e2vid_num_residual_blocks"],
            lstm_impl_train=("pallas_int8" if conf["train_cells"] == "int8"
                             else None)),
        task=TaskConfig(semseg_num_classes=conf["classes"]),
        optim=OptimConfig(
            batch_size_a=conf["batch"], batch_size_b=conf["batch"],
            lr_front=conf["lr_front"], lr_back=conf["lr_back"],
            weight_task_loss=conf["weight_task_loss"],
            weight_cycle_pred_loss=conf["weight_cycle_pred_loss"],
            weight_cycle_emb_loss=conf["weight_cycle_emb_loss"],
            weight_cycle_task_loss=conf["weight_cycle_task_loss"]))


def build(conf: dict, model_name: str, device) -> builder.ESSModules:
    return builder.build_modules(config(conf, model_name), device=device)


def pipeline(mods: builder.ESSModules, train: bool):
    return builder.make_pipeline(mods.cfg, train=train)


@torch.no_grad()
def load(mods: builder.ESSModules, params: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the modules, every name
    required."""
    parts = {"e2vid": mods.e2vid, "head": mods.head}
    if mods.front_a is not None:
        parts["front"] = mods.front_a
    for prefix, mod in parts.items():
        sub = {k[len(prefix) + 1:]: v for k, v in params.items()
               if k.startswith(prefix + ".")}
        mod.load_state_dict(sub, strict=True)


def wire(conf: dict, raw: np.ndarray, kind: str) -> Dict[str, np.ndarray]:
    """(B, T, N, 4) events -> the program's host wire: ``'band'``
    ghost-folded x-slot band records (integer band records on an
    integer-coordinate sensor), ``'tile'`` tile-sorted events; the event
    columns ``ev_*`` and the offsets, (B, T, ...)."""
    h, w, bins = conf["sensor_height"], conf["sensor_width"], conf["bins"]
    valid = np.ones(raw.shape[:3], bool)
    if kind == "band":
        fn = lambda r, v: voxel_folded.host_band_bin_folded(  # noqa: E731
            r, v, height=h, width=w, bins=bins,
            trilinear=not conf["integer_coordinates"])
    elif kind == "tile":
        fn = lambda r, v: voxel_tiled.host_tile_bin(  # noqa: E731
            r, v, height=h, width=w, bins=bins)
    else:
        raise ValueError(f"unknown wire {kind!r}")
    recs, vals, offs = zip(*(fn(raw[i], valid[i])
                             for i in range(raw.shape[0])))
    cap = max(r.shape[1] for r in recs)
    pad = lambda a: np.stack([np.pad(  # noqa: E731
        x, [(0, 0), (0, cap - x.shape[1])] + [(0, 0)] * (x.ndim - 2))
        for x in a])
    recs, vals = pad(recs), pad(vals)
    return {"ev_x": recs[..., 0], "ev_y": recs[..., 1], "ev_t": recs[..., 2],
            "ev_p": recs[..., 3], "ev_valid": vals,
            f"ev_{kind}_offsets": np.stack(offs)}


def to_device(host: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def supervised_train_step(mods: builder.ESSModules):
    return supervised.make_train_step(mods, pipeline(mods, True))


def uda_train_step(mods: builder.ESSModules):
    return uda.make_train_step(mods, pipeline(mods, True))


def streaming_steps(mods: builder.ESSModules):
    return streaming.make_streaming_steps(mods, pipeline(mods, False))


def fresh_state(mods: builder.ESSModules):
    """A train state at step 0 over the modules, the optimizers emptied."""
    for opt in (mods.opt_back, mods.opt_front):
        if opt is not None:
            opt.state.clear()
            opt.step_count = 0
    return builder.init_state(mods)


def first_moments(state, params: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """Norm by leaf of the gradient the optimizers took at their first
    step, worked out from their state: g = m / (1 - b1)."""
    out = {}
    for opt in (state.opt_back, state.opt_front):
        if opt is None:
            continue
        b1 = opt.param_groups[0]["b1"]
        for name, p in params.items():
            st = opt.state.get(p)
            if st:
                out[name] = float((st["mu"] / (1 - b1)).double().norm())
    return out
