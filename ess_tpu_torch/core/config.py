"""Typed configuration: frozen dataclasses loaded from the reference YAML schema.

Counterpart of ``ess_tpu/core/config.py``. The fields and the YAML parsing are
the same, so one ``configs/*.yaml`` file yields equal fields through both
packages (tests/test_torch_config.py). Pure Python: no framework import.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

from ess_tpu_torch.core import labels as labels_mod


def _event_channels(representation: str, nr_temporal_bins: int, separate_pol: bool) -> int:
    if representation == "voxel_grid":
        return nr_temporal_bins * 2 if separate_pol else nr_temporal_bins
    if representation == "ev_segnet":
        return 6
    return 2  # histogram


@dataclass(frozen=True)
class ImageDatasetConfig:
    """Sensor-A (labeled still images) dataset spec."""

    name: str = "Cityscapes_gray"
    dataset_path: str = ""
    shape: tuple[int, int] = (200, 352)  # (H, W) network input size
    random_crop: bool = True
    read_two_imgs: bool = False
    require_paired_data_train: bool = False
    require_paired_data_val: bool = False

    @property
    def input_channels(self) -> int:
        return 1  # grayscale front-end


@dataclass(frozen=True)
class EventDatasetConfig:
    """Sensor-B (event camera) dataset spec."""

    name: str = "DDD17_events"
    dataset_path: str = ""
    shape: tuple[int, int] = (200, 346)  # (H, W) sensor/label resolution
    split_train: str = "train"
    nr_events_data: int = 20          # recurrent windows per sample
    nr_events_window: int = 32000     # events per window (fixed-count mode)
    fixed_duration: bool = False
    delta_t_per_data: int = 50        # ms per window (fixed-duration mode)
    event_representation: str = "voxel_grid"
    nr_temporal_bins: int = 5
    separate_pol: bool = False
    normalize_event: bool = False
    require_paired_data_train: bool = False
    require_paired_data_val: bool = True
    semseg_label_train: bool = True
    semseg_label_val: bool = True
    # host->device wire format: 'f32' raw SoA windows or 'packed' (quantized)
    wire_format: str = "f32"

    @property
    def input_channels(self) -> int:
        return _event_channels(self.event_representation, self.nr_temporal_bins, self.separate_pol)

    @property
    def total_channels(self) -> int:
        """Channels of a full stacked sample: windows x per-window channels."""
        return self.nr_events_data * self.input_channels


@dataclass(frozen=True)
class ModelConfig:
    model_name: str = "ess"  # 'ess' (UDA) | 'ess_supervised'
    skip_connect_encoder: bool = True
    skip_connect_task: bool = True
    skip_connect_task_type: str = "concat"  # 'sum' | 'concat'
    data_augmentation_train: bool = True
    train_on_event_labels: bool = False
    # E2VID backbone geometry; E2VID-lightweight is 3 encoders / base 32 /
    # sum skips / no norm.
    e2vid_num_encoders: int = 3
    e2vid_base_channels: int = 32
    e2vid_num_residual_blocks: int = 2
    e2vid_skip_type: str = "sum"
    e2vid_recurrent_block: str = "convlstm"  # 'convlstm' | 'convgru'
    e2vid_norm: Optional[str] = None
    e2vid_checkpoint: str = ""
    # Implementation selectors. lstm_impl / lstm_impl_train pick the
    # ConvLSTM cell of the eval and train rollouts in both packages
    # ('auto', 'xla', 'pallas', 'pallas_int8'; the port's
    # ops/conv_lstm.py::resolve_lstm_impl); head_conv_impl picks the E2VID
    # head conv's evaluation in a standard-layout rollout, as in JAX
    # ('auto', 'xla', 's2d', 'xla_im2col'; models/layers.py::ConvLayer,
    # through train/builder.py). The block-space rollout ignores it.
    head_conv_impl: str = "auto"
    lstm_impl: str = "auto"
    lstm_impl_train: Optional[str] = None
    do_val_training_epoch: bool = False
    compute_dtype: str = "bfloat16"  # params stay float32


@dataclass(frozen=True)
class TaskConfig:
    semseg_num_classes: int = 6
    semseg_ignore_label: int = labels_mod.IGNORE_LABEL

    @property
    def class_names(self) -> list[str]:
        return labels_mod.class_names(self.semseg_num_classes)

    @property
    def color_map(self):
        return labels_mod.color_map(self.semseg_num_classes)


@dataclass(frozen=True)
class OptimConfig:
    batch_size_a: int = 16
    batch_size_b: int = 16
    lr_front: float = 1e-5
    lr_back: float = 1e-4
    lr_decay: float = 1.0  # per-epoch exponential decay factor
    num_epochs: int = 20
    val_epoch_step: int = 1
    weight_task_loss: float = 1.0
    weight_cycle_pred_loss: float = 1.0
    weight_cycle_emb_loss: float = 0.01
    weight_cycle_task_loss: float = 0.01
    task_loss: tuple[str, ...] = ("dice", "cross_entropy")


@dataclass(frozen=True)
class CheckpointConfig:
    save_checkpoint: bool = True
    resume_training: bool = False
    load_pretrained_weights: bool = False
    resume_file: str = ""
    pretrained_file: str = ""


@dataclass(frozen=True)
class HardwareConfig:
    num_cpu_workers: int = 8
    num_devices: int = -1  # -1 = all visible devices
    mesh_axis: str = "data"


@dataclass(frozen=True)
class DatasetConfig:
    sensor_a: ImageDatasetConfig = field(default_factory=ImageDatasetConfig)
    sensor_b: EventDatasetConfig = field(default_factory=EventDatasetConfig)


@dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    task: TaskConfig = field(default_factory=TaskConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)
    log_dir: str = "runs"
    tracker: str = "none"
    seed: int = 6

    # DDD17 trains on a random 120x216 crop and validates at 200x352; DSEC
    # trains and validates at the dataset shape.
    @property
    def train_input_size_b(self) -> tuple[int, int]:
        if self.dataset.sensor_b.name.startswith("DDD17") and self.model.data_augmentation_train:
            return (120, 216)
        return tuple(self.dataset.sensor_b.shape)

    @property
    def val_input_size_b(self) -> tuple[int, int]:
        if self.dataset.sensor_b.name.startswith("DDD17"):
            return (200, 352)
        return tuple(self.dataset.sensor_b.shape)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _get(d: dict, key: str, default: Any) -> Any:
    v = d.get(key, default)
    return default if v in (None, "None") else v


def _parse_event_dataset(name: str, spec: dict) -> EventDatasetConfig:
    return EventDatasetConfig(
        name=name,
        dataset_path=str(_get(spec, "dataset_path", "")),
        shape=tuple(_get(spec, "shape", (200, 346))),
        split_train=_get(spec, "split_train", "train"),
        nr_events_data=int(_get(spec, "nr_events_data", 20)),
        nr_events_window=int(_get(spec, "nr_events_window", 32000)),
        fixed_duration=bool(_get(spec, "fixed_duration", False)),
        delta_t_per_data=int(_get(spec, "delta_t_per_data", 50)),
        event_representation=_get(spec, "event_representation", "voxel_grid"),
        nr_temporal_bins=int(_get(spec, "nr_temporal_bins", 5)),
        separate_pol=bool(_get(spec, "separate_pol", False)),
        normalize_event=bool(_get(spec, "normalize_event", False)),
        require_paired_data_train=bool(_get(spec, "require_paired_data_train", False)),
        require_paired_data_val=bool(_get(spec, "require_paired_data_val", True)),
        semseg_label_train=not name.startswith("DSEC"),  # DSEC: no train labels
        semseg_label_val=True,
        wire_format=str(_get(spec, "wire_format", "f32")),
    )


def _parse_image_dataset(name: str, spec: dict) -> ImageDatasetConfig:
    return ImageDatasetConfig(
        name=name,
        dataset_path=str(_get(spec, "dataset_path", "")),
        shape=tuple(_get(spec, "shape", (200, 352))),
        random_crop=bool(_get(spec, "random_crop", True)),
        read_two_imgs=bool(_get(spec, "read_two_imgs", False)),
        require_paired_data_train=bool(_get(spec, "require_paired_data_train", False)),
        require_paired_data_val=bool(_get(spec, "require_paired_data_val", False)),
    )


_EVENT_SPEC_KEYS = {
    "DDD17_events": "DDD17_events",
    "DSEC_events": "DSEC_events",
    "E2VIDDriving_events": "E2VIDDriving_events",
}
_IMAGE_SPEC_KEYS = {
    "Cityscapes_gray": "cityscapes_img",
    "DDD17_Cityscapes_gray": "cityscapes_img",
    "DDD17_gray": "DDD17_img",
}


def load_config(path_or_dict: str | dict) -> Config:
    """Build a :class:`Config` from a reference-schema YAML file or dict."""
    if isinstance(path_or_dict, str):
        if not os.path.isfile(path_or_dict):
            raise FileNotFoundError(path_or_dict)
        with open(path_or_dict) as f:
            raw = yaml.safe_load(f)
    else:
        raw = dict(path_or_dict)

    ds = raw.get("dataset", {})
    name_a = ds.get("name_a", "Cityscapes_gray")
    name_b = ds.get("name_b", "DDD17_events")
    spec_a = ds.get(_IMAGE_SPEC_KEYS.get(name_a, name_a), {})
    spec_b = ds.get(_EVENT_SPEC_KEYS.get(name_b, name_b), {})

    model_raw = raw.get("model", {})
    model = ModelConfig(
        model_name=_get(model_raw, "model_name", "ess"),
        skip_connect_encoder=bool(_get(model_raw, "skip_connect_encoder", True)),
        skip_connect_task=bool(_get(model_raw, "skip_connect_task", True)),
        skip_connect_task_type=_get(model_raw, "skip_connect_task_type", "concat"),
        data_augmentation_train=bool(_get(model_raw, "data_augmentation_train", True)),
        train_on_event_labels=bool(_get(model_raw, "train_on_event_labels", False)),
        e2vid_num_encoders=int(_get(model_raw, "e2vid_num_encoders", 3)),
        e2vid_base_channels=int(_get(model_raw, "e2vid_base_channels", 32)),
        e2vid_num_residual_blocks=int(
            _get(model_raw, "e2vid_num_residual_blocks", 2)),
        e2vid_skip_type=_get(model_raw, "e2vid_skip_type", "sum"),
        e2vid_recurrent_block=_get(model_raw, "e2vid_recurrent_block",
                                   "convlstm"),
        e2vid_norm=_get(model_raw, "e2vid_norm", None) or None,
        e2vid_checkpoint=_get(model_raw, "e2vid_checkpoint", ""),
        head_conv_impl=_get(model_raw, "head_conv_impl", "auto"),
        lstm_impl=_get(model_raw, "lstm_impl", "auto"),
        lstm_impl_train=_get(model_raw, "lstm_impl_train", None) or None,
        do_val_training_epoch=bool(
            _get(model_raw, "do_val_training_epoch", False)),
        compute_dtype=_get(model_raw, "compute_dtype", "bfloat16"),
    )

    optim_raw = raw.get("optim", {})
    optim = OptimConfig(
        batch_size_a=int(_get(optim_raw, "batch_size_a", 16)),
        batch_size_b=int(_get(optim_raw, "batch_size_b", 16)),
        lr_front=float(_get(optim_raw, "lr_front", 1e-5)),
        lr_back=float(_get(optim_raw, "lr_back", 1e-4)),
        lr_decay=float(_get(optim_raw, "lr_decay", 1.0)),
        num_epochs=int(_get(optim_raw, "num_epochs", 20)),
        val_epoch_step=int(_get(optim_raw, "val_epoch_step", 1)),
        weight_task_loss=float(_get(optim_raw, "weight_task_loss", 1.0)),
        weight_cycle_pred_loss=float(_get(optim_raw, "weight_cycle_pred_loss", 1.0)),
        weight_cycle_emb_loss=float(_get(optim_raw, "weight_cycle_emb_loss", 0.01)),
        weight_cycle_task_loss=float(_get(optim_raw, "weight_cycle_task_loss", 0.01)),
        task_loss=tuple(_get(optim_raw, "task_loss", ["dice", "cross_entropy"])),
    )

    ckpt_raw = raw.get("checkpoint", {})
    ckpt = CheckpointConfig(
        save_checkpoint=bool(_get(ckpt_raw, "save_checkpoint", True)),
        resume_training=bool(_get(ckpt_raw, "resume_training", False)),
        load_pretrained_weights=bool(_get(ckpt_raw, "load_pretrained_weights", False)),
        resume_file=str(_get(ckpt_raw, "resume_file", "")),
        pretrained_file=str(_get(ckpt_raw, "pretrained_file", "")),
    )

    hw_raw = raw.get("hardware", {})
    hw = HardwareConfig(
        num_cpu_workers=int(_get(hw_raw, "num_cpu_workers", 8)),
        num_devices=int(_get(hw_raw, "num_devices", -1)),
    )

    return Config(
        dataset=DatasetConfig(
            sensor_a=_parse_image_dataset(name_a, spec_a),
            sensor_b=_parse_event_dataset(name_b, spec_b),
        ),
        model=model,
        task=TaskConfig(semseg_num_classes=int(_get(raw.get("task", {}), "semseg_num_classes", 6))),
        optim=optim,
        checkpoint=ckpt,
        hardware=hw,
        log_dir=str(_get(raw.get("dir", {}), "log", "runs")),
        tracker=str(_get(raw, "tracker", "none")),
        seed=int(_get(raw, "seed", 6)),
    )
