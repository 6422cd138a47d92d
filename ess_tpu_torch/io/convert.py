"""JAX parameter pytrees and reference-format torch files -> the port's
state dicts.

The JAX package keeps flax pytrees (``e2vid_params`` of ``RecurrentUNet``
and the params of ``UNet``, ``UNetDecoder`` and ``UNetTaskDecoder``,
``back_params`` of ``SegmentationHead``, ``front_params`` and
``front_batch_stats`` of ``ResNet18Encoder``) with HWIO conv kernels; the
port's modules carry upstream ESS/E2VID and torchvision names with OIHW
weights. The ConvLSTM gate
columns keep their (i, f, o, g) order over ``concat([x, h])`` inputs, so
the mapping is a rename plus a transpose. A transposed-conv decoder's
flax kernel (kh, kw, in, out) becomes the torch (in, out, kh, kw) weight
unflipped: ``layers.py::TransposedConvLayer`` flips it where it evaluates
it. Inputs are numpy arrays (or
anything ``np.asarray`` takes); no JAX import is needed.

The reference-format loaders (counterparts of the JAX package's
``load_e2vid_checkpoint``, ``load_resnet18_torch``,
``load_style_encoder_torch`` and ``load_semseg_head_torch``) read upstream
torch checkpoints or state dicts. The port keeps upstream names, so they
strip a ``DataParallel`` ``module.`` prefix, map the few names that differ
and load with every key accounted for: a missing or an unexpected key
raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


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


def _decoder(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """A JAX decoder: an upsample conv (``Conv_0``) -> ``{prefix}.conv2d``,
    a transposed conv (``ConvTranspose_0``, HWIO) ->
    ``{prefix}.transposed_conv2d`` (in, out, kh, kw)."""
    if "Conv_0" in p:
        return _conv(p["Conv_0"], f"{prefix}.conv2d")
    t = p["ConvTranspose_0"]
    kernel = np.asarray(t["kernel"], np.float32).transpose(2, 3, 0, 1)
    out = {f"{prefix}.transposed_conv2d.weight":
           torch.tensor(kernel).contiguous()}
    if "bias" in t:
        out[f"{prefix}.transposed_conv2d.bias"] = torch.tensor(
            np.asarray(t["bias"], np.float32))
    return out


def _trunk(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The residual blocks and decoders of a JAX E2VID net."""
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"resblock_{i}" in params:
        rb = params[f"resblock_{i}"]
        out.update(_conv(rb["Conv_0"], f"resblocks.{i}.conv1"))
        out.update(_conv(rb["Conv_1"], f"resblocks.{i}.conv2"))
        i += 1
    i = 0
    while f"decoder_{i}" in params:
        out.update(_decoder(params[f"decoder_{i}"], f"decoders.{i}"))
        i += 1
    return out


def unet_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UNet`` params -> the port's ``UNet`` state dict."""
    out = _conv(params["head"]["Conv_0"], "head.conv2d")
    i = 0
    while f"encoder_{i}" in params:
        out.update(_conv(params[f"encoder_{i}"]["Conv_0"],
                         f"encoders.{i}.conv2d"))
        i += 1
    out.update(_trunk(params))
    out.update(_conv(params["pred"]["Conv_0"], "pred.conv2d"))
    return out


def unet_decoder_from_jax(params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``UNetDecoder`` params -> the port's ``UNetDecoder`` state
    dict."""
    out = _trunk(params)
    out.update(_conv(params["pred"]["Conv_0"], "pred.conv2d"))
    return out


def unet_task_decoder_from_jax(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """JAX ``UNetTaskDecoder`` params -> the port's ``UNetTaskDecoder``
    state dict."""
    out = _trunk(params)
    out.update(_conv(params["pred_hidden"]["Conv_0"], "pred_hidden.conv2d"))
    out.update(_conv(params["pred"]["Conv_0"], "pred.conv2d"))
    return out


_GRU_GATES = ("reset_gate", "update_gate", "out_gate")


def params_from_jax(e2vid_params: Mapping[str, Any],
                    back_params: Mapping[str, Any]
                    ) -> tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(JAX RecurrentUNet params, JAX SegmentationHead params) ->
    (``RecurrentUNet`` state dict, ``SegmentationHead`` state dict), for
    ConvLSTM (``rnn.gates``) or ConvGRU (``rnn.{reset,update,out}_gate``)
    encoders, upsample-conv or transposed-conv decoders, a prediction of
    any activation (it has no parameters) and the skip-connect or the
    plain head."""
    e2vid: Dict[str, torch.Tensor] = {}
    e2vid.update(_conv(e2vid_params["head"]["Conv_0"], "head.conv2d"))
    i = 0
    while f"encoder_{i}" in e2vid_params:
        enc = e2vid_params[f"encoder_{i}"]
        cell = f"encoders.{i}.recurrent_block"
        e2vid.update(_conv(enc["conv"]["Conv_0"], f"encoders.{i}.conv.conv2d"))
        if "gates" in enc["rnn"]:
            e2vid.update(_conv(enc["rnn"]["gates"], f"{cell}.Gates"))
        else:
            for gate in _GRU_GATES:
                e2vid.update(_conv(enc["rnn"][gate], f"{cell}.{gate}"))
        i += 1
    e2vid.update(_trunk(e2vid_params))
    e2vid.update(_conv(e2vid_params["pred"]["Conv_0"], "pred.conv2d"))
    return e2vid, seghead_from_jax(back_params)


def seghead_from_jax(back_params: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """JAX ``SegmentationHead`` params (skip-connect or plain, with or
    without ``input_index_map``) -> the port's ``SegmentationHead`` state
    dict."""
    head: Dict[str, torch.Tensor] = {}
    skip = "reduce" in back_params
    for i in range(5 if skip else 3):
        res = back_params[f"res_{i}"]
        head.update(_conv(res["Conv_0"], f"decoder_scale_1.{i}.model.0"))
        head.update(_conv(res["Conv_1"], f"decoder_scale_1.{i}.model.3"))
    # the plain head's scales hold their upsample at .0, their conv at .1
    convs = ((("reduce", "decoder_scale_1.5"), ("s2_a", "decoder_scale_2.0"),
              ("s2_b", "decoder_scale_2.1"), ("s3_a", "decoder_scale_3.0"),
              ("s3_b", "decoder_scale_3.1"), ("s4", "decoder_scale_4.0"))
             if skip else
             (("s2", "decoder_scale_2.1"), ("s3", "decoder_scale_3.1"),
              ("s4", "decoder_scale_4.1")))
    for name, prefix in convs:
        head.update(_conv(back_params[name]["Conv_0"], f"{prefix}.model.0"))
    head.update(_conv(back_params["logits"], "decoder_scale_5.0"))
    return head


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


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop a leading ``module.`` from ``DataParallel``-saved keys."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _read(source) -> Dict[str, Any]:
    """A state dict from a path, an ``nn.Module`` or a mapping."""
    if isinstance(source, str):
        source = torch.load(source, map_location="cpu", weights_only=False)
    if hasattr(source, "state_dict"):
        source = source.state_dict()
    return strip_module_prefix(dict(source))


def _check_keys(module: nn.Module, sd: Mapping[str, Any],
                keep: Iterable[str] = ()) -> None:
    """Every key of ``module``'s state dict but those in ``keep`` must be
    in ``sd`` with its shape, and ``sd`` must hold no other key."""
    want = {k: v for k, v in module.state_dict().items() if k not in keep}
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"state dict does not match {type(module).__name__}:"
                       f" missing {missing}, unexpected {extra}")
    for k, v in want.items():
        if tuple(v.shape) != tuple(np.shape(sd[k])):
            raise ValueError(f"{k}: shape {tuple(np.shape(sd[k]))}, want "
                             f"{tuple(v.shape)}")


def _load_exact(module: nn.Module, sd: Mapping[str, Any],
                keep: Iterable[str] = ()) -> None:
    """Load ``sd`` into ``module`` after :func:`_check_keys`; the keys in
    ``keep`` stay as they are."""
    _check_keys(module, sd, keep)
    module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                           strict=False)


def load_e2vid_checkpoint(source, model: Optional[nn.Module] = None
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """An upstream E2VID ``.pth.tar`` (a path, or the dict it holds) ->
    (``RecurrentUNet`` state dict, the file's arch config). Keys are
    ``[module.]unetrecurrent.<name>`` with the port's names. The state
    dict is checked against the ``RecurrentUNet`` of the file's geometry
    (bins and base width from the head conv, ``num_encoders``,
    ``num_residual_blocks`` and ``skip_type`` from its config) and, when
    ``model`` is given, loaded into it."""
    from ess_tpu_torch.models.e2vid import RecurrentUNet

    raw = (torch.load(source, map_location="cpu", weights_only=False)
           if isinstance(source, str) else source)
    config = dict(raw.get("model", {}))
    prefix = "unetrecurrent."
    sd = {k[len(prefix):] if k.startswith(prefix) else k: v
          for k, v in strip_module_prefix(raw["state_dict"]).items()}
    head_w = sd.get("head.conv2d.weight")
    if head_w is None:
        raise KeyError("not an E2VID checkpoint: no "
                       "unetrecurrent.head.conv2d.weight")
    geometry = RecurrentUNet(
        in_channels=head_w.shape[1], base_channels=head_w.shape[0],
        num_encoders=int(config.get("num_encoders", 3)),
        num_residual_blocks=int(config.get("num_residual_blocks", 2)),
        skip_type=config.get("skip_type", "sum"), device="meta")
    _check_keys(geometry, sd)
    sd = {k: torch.as_tensor(v).float() for k, v in sd.items()}
    if model is not None:
        _load_exact(model, sd)
    return sd, config


# torchvision resnet18 parts the grayscale front does not have
_RESNET_UNUSED = ("layer4.", "fc.")


def load_resnet18_torch(source, front: nn.Module, *,
                        adapt_stem: bool = False) -> None:
    """Load a torchvision resnet18 state dict (a path, a module or a
    mapping) into the port's ``ResNet18Encoder`` ``front``: ``bn1`` and
    ``layer1``-``layer3`` (``layer4`` and ``fc`` are not part of the
    front). The 1-channel stem conv stays as it is (the reference trains it
    from scratch); ``adapt_stem=True`` loads the pretrained RGB stem
    averaged over its input channels instead."""
    sd = {k: v for k, v in _read(source).items()
          if not k.startswith(_RESNET_UNUSED)}
    stem = sd.pop("conv1.weight", None)
    keep = ("conv1.weight",)
    if adapt_stem:
        if stem is None:
            raise KeyError("adapt_stem: the state dict has no conv1.weight")
        sd["conv1.weight"] = torch.as_tensor(stem).float().mean(
            dim=1, keepdim=True)
        keep = ()
    _load_exact(front, sd, keep)


_STYLE_RENAMES = (
    ("encoder_scale_1.0.", "conv1."),
    ("encoder_scale_1.1.", "bn1."),
    ("encoder_scale_1.3.", "layer1."),
    ("encoder_scale_2.", "layer2."),
    ("encoder_scale_3.", "layer3."),
)


def load_style_encoder_torch(source, front: nn.Module) -> None:
    """Load an upstream ``StyleEncoderE2VID`` state dict into ``front``:
    ``encoder_scale_1`` = [stem conv, bn1, relu, layer1],
    ``encoder_scale_2`` / ``_3`` = layer2 / layer3. Its stem conv is
    already 1-channel and loads as it is."""
    remap: Dict[str, Any] = {}
    for key, value in _read(source).items():
        for old, new in _STYLE_RENAMES:
            if key.startswith(old):
                remap[new + key[len(old):]] = value
                break
        else:
            raise KeyError(f"unexpected key {key!r} in a StyleEncoderE2VID "
                           "state dict")
    load_resnet18_torch(remap, front, adapt_stem=True)


def load_semseg_head_torch(source, head: nn.Module, *,
                           skip_connect: bool = True) -> None:
    """Load an upstream ``SemSegE2VID`` state dict, of the skip-connect or
    (``skip_connect=False``) the plain head, into the port's
    ``SegmentationHead`` of the same kind (the same module names; instance
    norms and upsamples carry no parameters)."""
    if skip_connect != head.skip_connect:
        raise ValueError(f"a skip_connect={skip_connect} state dict for a "
                         f"skip_connect={head.skip_connect} head")
    _load_exact(head, _read(source))
