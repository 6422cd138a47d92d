"""Training CLI.

Counterpart of ``ess_tpu/cli/train.py``:
``python -m ess_tpu_torch.cli.train --settings_file configs/...yaml``
takes the same YAML as the JAX CLI, seeds from ``cfg.seed``, dispatches
``'ess'`` to UDA and ``'ess_supervised'`` to supervised training, and writes
logs and checkpoints under a timestamped log directory with the YAML
copied in. It trains on the first CUDA device.

``model_name: 'ess'`` reads its sensor-A image set from disk:
``Cityscapes_gray``, ``DDD17_gray`` or their mix ``DDD17_Cityscapes_gray``.

``--num_devices N`` trains data parallel (``ess_tpu_torch/parallel``) on N
ranks, one process and one CUDA device each, and computes what
``--num_devices 0`` computes on the same global batches: 0 is one device
and no process group, -1 every visible CUDA device, and N more than exist
raises, as does a batch size that does not divide over N. The command
starts the ranks itself (spawn); under ``torchrun --nproc_per_node N`` each
process joins the group ``torchrun`` describes instead. Rank 0 prints the
summary and writes the logs and checkpoints. The YAML's
``hardware.num_devices`` is read and unused, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np


def build_loaders(cfg):
    """The loaders of the config's datasets and the rectify map: (train_a,
    train_b, val_a, val_b, rectify_map), the image loaders None for
    supervised ESS. The event sets are built as the JAX CLI builds them:
    ``'folded'`` binning for the voxel grid (else ``'tile'``) at the
    voxelizer's channel count. ``rectify_map`` is the one the Trainer
    applies on the device: None, as in JAX, since the DSEC loaders
    rectify on the host and DDD17 needs none."""
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
        h, w = ds_a.shape
        set_a, set_a_val = _image_datasets(cfg, ds_a, h, w)
        train_a = BatchLoader(set_a, cfg.optim.batch_size_a, shuffle=True,
                              num_workers=workers, seed=cfg.seed)
        val_a = BatchLoader(set_a_val, cfg.optim.batch_size_a, shuffle=False,
                            drop_last=False, num_workers=workers)
    return train_a, train_b, val_a, val_b, None


def _image_datasets(cfg, ds_a, h, w):
    """Sensor-A (train, validation) datasets: Cityscapes_gray, DDD17_gray,
    or the DDD17_Cityscapes_gray mix (DDD17 frames added to the Cityscapes
    training set, validation on Cityscapes)."""
    from ess_tpu_torch.data.cityscapes import CityscapesGray
    from ess_tpu_torch.data.ddd17_gray import ConcatImages, DDD17Gray

    def cityscapes(split, aug):
        return CityscapesGray(ds_a.dataset_path, height=h, width=w,
                              split=split,
                              semseg_num_classes=cfg.task.semseg_num_classes,
                              augmentation=aug, random_crop=ds_a.random_crop,
                              seed=cfg.seed)

    aug = cfg.model.data_augmentation_train
    if ds_a.name == "DDD17_gray":
        return (DDD17Gray(ds_a.dataset_path, split="train", height=h, width=w),
                DDD17Gray(ds_a.dataset_path, split="valid", height=h, width=w))
    if ds_a.name == "DDD17_Cityscapes_gray":
        ddd17_root = (getattr(ds_a, "extra_dataset_path", "")
                      or ds_a.dataset_path)
        train = ConcatImages(
            cityscapes("train", aug),
            DDD17Gray(ddd17_root, split="train", height=h, width=w))
        return train, cityscapes("val", False)
    return cityscapes("train", aug), cityscapes("val", False)


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


def make_log_dir(cfg, settings_file: str) -> str:
    """A timestamped directory under ``cfg.log_dir`` with the YAML copied
    in."""
    log_dir = os.path.join(cfg.log_dir, time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(log_dir, exist_ok=True)
    shutil.copyfile(settings_file,
                    os.path.join(log_dir, os.path.basename(settings_file)))
    return log_dir


def train(settings_file: str, log_dir: str, device=None) -> dict:
    """Build the loaders and the Trainer of the YAML and run it; returns
    the last validation summary. Under an active data-parallel group this
    is one rank's share, on the group's device."""
    from ess_tpu_torch.core.config import load_config
    from ess_tpu_torch.io import timers
    from ess_tpu_torch.parallel import dp
    from ess_tpu_torch.train.loop import Trainer

    cfg = load_config(settings_file)
    np.random.seed(cfg.seed)
    train_a, train_b, val_a, val_b, rectify_map = build_loaders(cfg)
    trainer = Trainer(
        cfg, train_b=train_b, val_b=val_b, train_a=train_a, val_a=val_a,
        rectify_map=rectify_map, log_dir=log_dir,
        e2vid_state=load_pretrained_backbone(cfg),
        group=dp.active(), device=None if dp.active() else device)
    summary = trainer.run()
    if dp.rank():
        timers.reset_timers()   # one timing report, rank 0's
    return summary


def check_batches(cfg, world: int) -> None:
    """Raise unless the config's global batches divide over ``world``
    ranks."""
    from ess_tpu_torch.parallel import dp

    dp.check_divides(cfg.optim.batch_size_b, world, "batch_size_b")
    if cfg.model.model_name == "ess":
        dp.check_divides(cfg.optim.batch_size_a, world, "batch_size_a")


def main(argv=None, *, device=None) -> None:
    """Train as the YAML says; ``device`` (not a command-line flag) builds
    on another device than the first CUDA one, e.g. ``"cpu"``, where
    ``--num_devices N`` runs N gloo ranks on the CPU."""
    args = parse_args(argv, "ess-tpu training (PyTorch)", **{
        "--num_devices": dict(type=int, default=0,
                              help="data-parallel devices (0 = single, "
                                   "-1 = all)")})
    from ess_tpu_torch.core.config import load_config
    from ess_tpu_torch.parallel import dp, launch, multihost

    cfg = load_config(args.settings_file)
    if args.num_devices == 0:
        print_summary(train(args.settings_file,
                            make_log_dir(cfg, args.settings_file), device))
        return
    if multihost.from_torchrun():
        multihost.initialize(backend=dp.default_backend(device or "cuda"))
        try:
            group = dp.make_group(args.num_devices, device=device)
            check_batches(cfg, group.world)
            log_dir = dp.broadcast_object(
                make_log_dir(cfg, args.settings_file) if group.rank == 0
                else None)
            summary = train(args.settings_file, log_dir)
            if group.rank == 0:
                print_summary(summary)
        finally:
            dp.release()
        return
    world = dp.world_size(args.num_devices, device)
    check_batches(cfg, world)
    results = launch.spawn(
        train, world, (args.settings_file,
                       make_log_dir(cfg, args.settings_file)),
        device=device)
    print_summary(results[0])


if __name__ == "__main__":
    main()
