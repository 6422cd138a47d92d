"""JAX parameter pytrees -> the port's state dicts.

The JAX package keeps flax pytrees (``e2vid_params`` of ``RecurrentUNet``,
``back_params`` of ``SegmentationHead``, ``front_params`` and
``front_batch_stats`` of ``ResNet18Encoder``) with HWIO conv kernels; the
port's modules carry upstream ESS/E2VID and torchvision names with OIHW
weights. The ConvLSTM gate
columns keep their (i, f, o, g) order over ``concat([x, h])`` inputs, so
the mapping is a rename plus a transpose. Inputs are numpy arrays (or
anything ``np.asarray`` takes); no JAX import is needed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _conv(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
    out = {f"{prefix}.weight": torch.tensor(kernel).contiguous()}
    if "bias" in p:
        out[f"{prefix}.bias"] = torch.tensor(np.asarray(p["bias"], np.float32))
    return out


def conv_state(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """One JAX conv's parameters (HWIO ``kernel``, optional ``bias``) as the
    port's ``{prefix}.weight`` (OIHW) and ``{prefix}.bias``."""
    return _conv(p, prefix)


def params_from_jax(e2vid_params: Mapping[str, Any],
                    back_params: Mapping[str, Any]
                    ) -> tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(JAX RecurrentUNet params, JAX skip-connect SegmentationHead params)
    -> (``RecurrentUNet`` state dict, ``SegmentationHead`` state dict)."""
    e2vid: Dict[str, torch.Tensor] = {}
    e2vid.update(_conv(e2vid_params["head"]["Conv_0"], "head.conv2d"))
    i = 0
    while f"encoder_{i}" in e2vid_params:
        enc = e2vid_params[f"encoder_{i}"]
        e2vid.update(_conv(enc["conv"]["Conv_0"], f"encoders.{i}.conv.conv2d"))
        e2vid.update(_conv(enc["rnn"]["gates"],
                           f"encoders.{i}.recurrent_block.Gates"))
        e2vid.update(_conv(e2vid_params[f"decoder_{i}"]["Conv_0"],
                           f"decoders.{i}.conv2d"))
        i += 1
    i = 0
    while f"resblock_{i}" in e2vid_params:
        rb = e2vid_params[f"resblock_{i}"]
        e2vid.update(_conv(rb["Conv_0"], f"resblocks.{i}.conv1"))
        e2vid.update(_conv(rb["Conv_1"], f"resblocks.{i}.conv2"))
        i += 1
    e2vid.update(_conv(e2vid_params["pred"]["Conv_0"], "pred.conv2d"))

    head: Dict[str, torch.Tensor] = {}
    for i in range(5):
        res = back_params[f"res_{i}"]
        head.update(_conv(res["Conv_0"], f"decoder_scale_1.{i}.model.0"))
        head.update(_conv(res["Conv_1"], f"decoder_scale_1.{i}.model.3"))
    for name, prefix in (("reduce", "decoder_scale_1.5"),
                         ("s2_a", "decoder_scale_2.0"),
                         ("s2_b", "decoder_scale_2.1"),
                         ("s3_a", "decoder_scale_3.0"),
                         ("s3_b", "decoder_scale_3.1"),
                         ("s4", "decoder_scale_4.0")):
        head.update(_conv(back_params[name]["Conv_0"], f"{prefix}.model.0"))
    head.update(_conv(back_params["logits"], "decoder_scale_5.0"))
    return e2vid, head


def front_from_jax(front_params: Mapping[str, Any],
                   front_batch_stats: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """(JAX ``ResNet18Encoder`` params, its batch stats) -> the port's
    ``ResNet18Encoder`` state dict: ``stem_conv`` / ``stem_bn`` ->
    ``conv1`` / ``bn1``, ``layerN_i`` -> ``layerN.i``, ``proj_conv`` /
    ``proj_bn`` -> ``downsample.0`` / ``.1``; batch-norm ``scale``,
    ``bias``, ``mean``, ``var`` -> ``weight``, ``bias``, ``running_mean``,
    ``running_var`` (``num_batches_tracked`` 0)."""
    out: Dict[str, torch.Tensor] = {}

    def bn(p, stats, prefix):
        for src, dst, tree in (("scale", "weight", p), ("bias", "bias", p),
                               ("mean", "running_mean", stats),
                               ("var", "running_var", stats)):
            out[f"{prefix}.{dst}"] = torch.tensor(
                np.asarray(tree[src], np.float32))
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    out.update(_conv(front_params["stem_conv"], "conv1"))
    bn(front_params["stem_bn"], front_batch_stats["stem_bn"], "bn1")
    for name, p in front_params.items():
        if not name.startswith("layer"):
            continue
        prefix = name.replace("_", ".")
        stats = front_batch_stats[name]
        for conv, norm, dst in (("conv1", "bn1", ("conv1", "bn1")),
                                ("conv2", "bn2", ("conv2", "bn2")),
                                ("proj_conv", "proj_bn",
                                 ("downsample.0", "downsample.1"))):
            if conv in p:
                out.update(_conv(p[conv], f"{prefix}.{dst[0]}"))
                bn(p[norm], stats[norm], f"{prefix}.{dst[1]}")
    return out
