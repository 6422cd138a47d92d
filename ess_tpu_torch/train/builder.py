"""Model construction for the supervised and UDA steps from a Config.

Counterpart of ``ess_tpu/train/builder.py`` (``build_modules``,
``init_state``, ``make_pipeline``): the frozen E2VID backbone, the segmentation head, the
train and validation rollouts (each with its ConvLSTM cell,
``model.lstm_impl`` / ``model.lstm_impl_train``, over one parameter set)
and the head's RAdam; for ESS UDA (``model_name='ess'``) also the ResNet18
image front and its RAdam. Both rollouts run in block space with the block
convs on the library conv (``'xla'``), the choice of JAX ``build_modules``;
:func:`with_block_conv_impl` puts them on the fused conv kernel.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ess_tpu_torch import resolve_device
from ess_tpu_torch.core.config import Config
from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
from ess_tpu_torch.models.e2vid import RecurrentUNet
from ess_tpu_torch.models.layers import (
    BLOCK_CONV_IMPLS, BatchNorm2d, INSResBlock, ReLUINSConv2d)
from ess_tpu_torch.models.resnet import ResNet18Encoder
from ess_tpu_torch.models.seghead import SegmentationHead
from ess_tpu_torch.ops.conv_lstm import resolve_lstm_impl
from ess_tpu_torch.recon.reconstructor import Reconstructor
from ess_tpu_torch.train.state import RAdam, TrainState, make_radam


def compute_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
            else torch.float32)


@dataclass(frozen=True)
class ESSModules:
    """Modules, rollouts and optimizers of one config; ``front_a`` and
    ``opt_front`` are None for supervised ESS."""

    cfg: Config
    e2vid: RecurrentUNet
    head: SegmentationHead
    recon_train: Reconstructor
    recon_val: Reconstructor
    opt_back: RAdam
    front_a: Optional[ResNet18Encoder] = None
    opt_front: Optional[RAdam] = None


def build_modules(cfg: Config, *, device=None,
                  steps_per_epoch: int = 1) -> ESSModules:
    """ESS modules (``model_name`` 'ess_supervised' or 'ess', UDA) on
    ``device`` (None: the first CUDA device; raises where there is none),
    parameters uninitialized beyond torch's defaults: call
    :func:`init_params` or load weights. The E2VID parameters are frozen
    (``requires_grad=False``); ``opt_back`` updates the head's and, for
    UDA, ``opt_front`` the image front's."""
    device = resolve_device(device)
    m = cfg.model
    if m.model_name not in ("ess_supervised", "ess"):
        raise ValueError(f"the port builds 'ess_supervised' and 'ess', got "
                         f"{m.model_name!r}")
    is_uda = m.model_name == "ess"
    if m.e2vid_num_encoders != 3 or m.e2vid_recurrent_block != "convlstm" \
            or m.e2vid_norm is not None or not m.skip_connect_task:
        raise ValueError("the port builds the E2VID-lightweight backbone "
                         "(3 ConvLSTM encoders, no norm) and the skip-connect "
                         "segmentation head")
    dtype = compute_dtype(cfg)
    e2vid = RecurrentUNet(
        in_channels=cfg.dataset.sensor_b.input_channels,
        base_channels=m.e2vid_base_channels,
        num_encoders=m.e2vid_num_encoders,
        num_residual_blocks=m.e2vid_num_residual_blocks,
        skip_type=m.e2vid_skip_type, lstm_impl=resolve_lstm_impl(m.lstm_impl),
        dtype=dtype, device=device)
    e2vid.requires_grad_(False)
    head = SegmentationHead(
        cfg.task.semseg_num_classes,
        input_features=m.e2vid_base_channels * 2 ** m.e2vid_num_encoders,
        skip_type=m.skip_connect_task_type, dtype=dtype, device=device)
    # UDA trains at the (possibly cropped) train size and validates at the
    # val size; supervised ESS trains and validates at ceil(shape / 8) * 8.
    # The train rollout may run another ConvLSTM cell (the int8 one) over
    # the same parameters.
    if is_uda:
        (th, tw), (vh, vw) = cfg.train_input_size_b, cfg.val_input_size_b
    else:
        h, w = cfg.dataset.sensor_b.shape
        th = vh = math.ceil(h / 8) * 8
        tw = vw = math.ceil(w / 8) * 8
    train_impl = (e2vid.lstm_impl if m.lstm_impl_train is None
                  else resolve_lstm_impl(m.lstm_impl_train))
    recon_train = Reconstructor(model=e2vid, height=th, width=tw,
                                lstm_impl=train_impl)
    recon_val = Reconstructor(model=e2vid, height=vh, width=vw)
    opt_back = make_radam(head.parameters(), cfg.optim.lr_back,
                          lr_decay=cfg.optim.lr_decay,
                          steps_per_epoch=steps_per_epoch)
    front_a = opt_front = None
    if is_uda:
        # layer widths 2b, 4b, 8b match the E2VID latent at scales 2, 4, 8
        front_a = ResNet18Encoder(base_width=2 * m.e2vid_base_channels,
                                  skip_connect=m.skip_connect_encoder,
                                  dtype=dtype, device=device)
        opt_front = make_radam(front_a.parameters(), cfg.optim.lr_front,
                               lr_decay=cfg.optim.lr_decay,
                               steps_per_epoch=steps_per_epoch)
    return ESSModules(cfg=cfg, e2vid=e2vid, head=head,
                      recon_train=recon_train, recon_val=recon_val,
                      opt_back=opt_back, front_a=front_a,
                      opt_front=opt_front)


def with_block_conv_impl(mods: ESSModules, impl: str,
                         impl_train: Optional[str] = None) -> ESSModules:
    """The same modules with the rollouts' block convs (head and first
    encoder) on ``impl`` for eval and streaming and on ``impl_train`` (None:
    ``impl``) for the train rollout: ``'xla'``, ``'pallas'`` or
    ``'pallas_int8'``. The counterpart of JAX's
    ``e2vid.clone(block_conv_impl=...)``: one parameter set, so the train
    rollout can run the int8 convs beside the int8 ConvLSTM cell while eval
    stays exact."""
    impl_train = impl if impl_train is None else impl_train
    for name in (impl, impl_train):
        if name not in BLOCK_CONV_IMPLS:
            raise ValueError(f"unknown block_conv_impl {name!r}; expected "
                             f"one of {BLOCK_CONV_IMPLS}")
    return dataclasses.replace(
        mods,
        recon_train=dataclasses.replace(mods.recon_train, block_space=True,
                                        block_conv_impl=impl_train),
        recon_val=dataclasses.replace(mods.recon_val, block_space=True,
                                      block_conv_impl=impl))


def make_pipeline(cfg: Config, *, train: bool = True,
                  rectify_map=None) -> EventPipeline:
    """The dataset's event pipeline, as the JAX ``make_pipeline``:

    - DSEC: host-rectified float coordinates, the trilinear voxelizer at
      480x640, the 40 bottom rows cropped, a flip when training with
      augmentation; a ``rectify_map`` (rectification on the device) is not
      ported and raises;
    - DDD17: integer coordinates, the temporal-bilinear voxelizer at
      260x346, the 60 bottom rows cropped, the width resized to 200x352,
      and when training with augmentation a flip and, for ESS UDA, the
      bottom-anchored 120x216 crop;
    - any other dataset: the plain voxelizer at its shape.

    Every branch normalizes each window."""
    ds = cfg.dataset.sensor_b
    aug = train and cfg.model.data_augmentation_train
    common = dict(num_bins=ds.nr_temporal_bins,
                  representation=ds.event_representation,
                  separate_pol=ds.separate_pol, normalize=True,
                  random_flip=aug)
    if ds.name.startswith("DSEC"):
        if rectify_map is not None:
            raise ValueError("rectification on the device is not ported: "
                             "rectify on the host (data.dsec)")
        pc = PipelineConfig(sensor_height=480, sensor_width=640,
                            crop_bottom=40, trilinear=True, **common)
    elif ds.name.startswith("DDD17"):
        pc = PipelineConfig(
            sensor_height=260, sensor_width=346, crop_bottom=60,
            resize_to=(200, 352),
            random_crop=((120, 216) if aug and cfg.model.model_name == "ess"
                         else None),
            crop_anchor="bottom", **common)
    else:
        h, w = ds.shape
        pc = PipelineConfig(sensor_height=h, sensor_width=w, **common)
    return EventPipeline(pc)


def init_state(mods: ESSModules) -> TrainState:
    """The train state at step 0 over the modules' trainable parts (head,
    and for UDA the image front), their optimizers and the frozen E2VID."""
    return TrainState(step=0, head=mods.head, opt_back=mods.opt_back,
                      front=mods.front_a, opt_front=mods.opt_front,
                      e2vid=mods.e2vid)


@torch.no_grad()
def init_params(mods: ESSModules, generator: torch.Generator) -> None:
    """Seeded initialization at the JAX package's scales: normal conv kernels
    with variance 1/fan_in and zero biases, N(0, 0.02) kernels in the head's
    instance-norm blocks; the image front's batch norms at scale 1, bias 0,
    running mean 0 and running variance 1."""
    gaussian = set()
    for mod in mods.head.modules():
        if isinstance(mod, (INSResBlock, ReLUINSConv2d)):
            gaussian.update(id(c) for c in mod.model
                            if isinstance(c, nn.Conv2d))
    roots = [mods.e2vid, mods.head]
    if mods.front_a is not None:
        roots.append(mods.front_a)
        for mod in mods.front_a.modules():
            if isinstance(mod, BatchNorm2d):
                mod.reset_parameters()
    for root in roots:
        for mod in root.modules():
            if not isinstance(mod, nn.Conv2d):
                continue
            w = mod.weight
            std = (0.02 if id(mod) in gaussian
                   else 1.0 / math.sqrt(w[0].numel()))
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            if mod.bias is not None:
                mod.bias.zero_()
