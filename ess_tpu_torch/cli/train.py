"""Training CLI.

Counterpart of ``ess_tpu/cli/train.py``:
``python -m ess_tpu_torch.cli.train --settings_file configs/...yaml``
takes the same YAML as the JAX CLI, seeds from ``cfg.seed``, dispatches
``'ess'`` to UDA and ``'ess_supervised'`` to supervised training, and writes
logs and checkpoints under a timestamped log directory with the YAML
copied in. It trains on the first CUDA device.

Not ported yet: ``--num_devices`` other than 0 (data parallel over several
GPUs) raises, and so does ``model_name: 'ess'`` where it would read the
Cityscapes or DDD17 grayscale image sets from disk.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np


def build_loaders(cfg):
    """The loaders of the config's datasets: (train_a, train_b, val_a,
    val_b), the image loaders None for supervised ESS. The event sets are
    built as the JAX CLI builds them: ``'folded'`` binning for the voxel
    grid (else ``'tile'``) at the voxelizer's channel count."""
    from ess_tpu_torch.data.loader import BatchLoader
    from ess_tpu_torch.ops.batch_voxel import effective_bins

    ds_b = cfg.dataset.sensor_b
    # ghost-folded band binning pre-weights polarities with the voxel tent
    # factors: only the voxel_grid representation can consume it
    binning = "folded" if ds_b.event_representation == "voxel_grid" else "tile"
    common = dict(nr_events_data=ds_b.nr_events_data,
                  nr_events_window=ds_b.nr_events_window,
                  fixed_duration=ds_b.fixed_duration,
                  delta_t_per_data=ds_b.delta_t_per_data, binning=binning)
    if ds_b.name.startswith("DSEC"):
        from ess_tpu_torch.data.dsec import DSECEvents
        kw = dict(common, semseg_num_classes=cfg.task.semseg_num_classes,
                  tile_bins=effective_bins(ds_b.nr_temporal_bins,
                                           ds_b.separate_pol, True),
                  wire_format=ds_b.wire_format)
        train_set = DSECEvents(ds_b.dataset_path, mode="train", **kw)
        val_set = DSECEvents(ds_b.dataset_path, mode="val", **kw)
    elif ds_b.name.startswith("DDD17"):
        from ess_tpu_torch.data.ddd17 import DDD17Events
        kw = dict(common, tile_bins=effective_bins(ds_b.nr_temporal_bins,
                                                   ds_b.separate_pol, False))
        train_set = DDD17Events(ds_b.dataset_path, split=ds_b.split_train,
                                **kw)
        val_set = DDD17Events(ds_b.dataset_path, split="valid",
                              require_paired_data=ds_b.require_paired_data_val,
                              **kw)
    else:
        raise ValueError(f"unknown sensor-B dataset: {ds_b.name}")

    workers = cfg.hardware.num_cpu_workers
    if workers < 0:
        workers = os.cpu_count() or 4
    train_b = BatchLoader(train_set, cfg.optim.batch_size_b, shuffle=True,
                          num_workers=workers, seed=cfg.seed)
    val_b = BatchLoader(val_set, cfg.optim.batch_size_b, shuffle=False,
                        drop_last=False, num_workers=workers)

    train_a = val_a = None
    if cfg.model.model_name == "ess":
        ds_a = cfg.dataset.sensor_a
        set_a, set_a_val = _image_datasets(cfg, ds_a)
        train_a = BatchLoader(set_a, cfg.optim.batch_size_a, shuffle=True,
                              num_workers=workers, seed=cfg.seed)
        val_a = BatchLoader(set_a_val, cfg.optim.batch_size_a, shuffle=False,
                            drop_last=False, num_workers=workers)
    return train_a, train_b, val_a, val_b


def _image_datasets(cfg, ds_a):
    """Sensor-A datasets (Cityscapes_gray, DDD17_gray or their mix): not
    ported yet."""
    raise NotImplementedError(
        f"model_name 'ess' reads the sensor-A image set {ds_a.name!r} from "
        f"disk, and the port has no image datasets yet (Cityscapes and DDD17 "
        f"grayscale); train 'ess_supervised', or build a Trainer with "
        f"in-memory image loaders")


def load_pretrained_backbone(cfg):
    """The E2VID state dict of ``cfg.model.e2vid_checkpoint`` (an upstream
    ``.pth.tar``) when it is set and exists, else None."""
    path = cfg.model.e2vid_checkpoint
    if path and os.path.isfile(path):
        from ess_tpu_torch.io.convert import load_e2vid_checkpoint
        state, _ = load_e2vid_checkpoint(path)
        return state
    return None


def parse_args(argv, description: str, **extra):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--settings_file", required=True,
                        help="YAML config (reference schema supported)")
    for flag, kw in extra.items():
        parser.add_argument(flag, **kw)
    return parser.parse_args(argv)


def print_summary(summary: dict) -> None:
    for k, v in summary.items():
        if np.ndim(v) == 0:
            print(f"{k}: {v}")


def main(argv=None, *, device=None) -> None:
    """Train as the YAML says; ``device`` (not a command-line flag) builds
    on another device than the first CUDA one, e.g. ``"cpu"``."""
    args = parse_args(argv, "ess-tpu training (PyTorch)", **{
        "--num_devices": dict(type=int, default=0,
                              help="data-parallel devices (only 0, one "
                                   "device, is ported)")})
    if args.num_devices != 0:
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: multi-GPU data parallel "
            f"training is not ported yet; use 0 (one device)")

    from ess_tpu_torch.core.config import load_config
    from ess_tpu_torch.train.loop import Trainer

    cfg = load_config(args.settings_file)
    np.random.seed(cfg.seed)

    log_dir = os.path.join(cfg.log_dir, time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(log_dir, exist_ok=True)
    shutil.copyfile(args.settings_file,
                    os.path.join(log_dir, os.path.basename(args.settings_file)))

    train_a, train_b, val_a, val_b = build_loaders(cfg)
    trainer = Trainer(
        cfg, train_b=train_b, val_b=val_b, train_a=train_a, val_a=val_a,
        log_dir=log_dir, e2vid_state=load_pretrained_backbone(cfg),
        device=device)
    print_summary(trainer.run())


if __name__ == "__main__":
    main()
