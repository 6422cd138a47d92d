"""Seeded weights of a configuration, made on the device in one call.

The parameter set is written here from the configuration's sizes, under the
names the ESS networks use (``e2vid.*``, ``head.*``, ``front.*``): the
benchmark loads it into the program's modules by name, strictly, and hands
the same tensors to the plain reference. Scales: normal conv kernels of
variance 1 / fan_in, zero biases, N(0, 0.02) kernels in the head's
instance-norm convs, and batch norms at scale 1, shift 0, running mean 0 and
variance 1 (as E2VID-style seeded initializations do). ``e2vid_checkpoint``
is empty in both YAMLs, so the frozen backbone is seeded too.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _conv(out: Spec, name: str, cout: int, cin: int, k: int, *,
          bias: bool = True, init: str = "fan_in") -> None:
    out.append((name + ".weight", (cout, cin, k, k), init))
    if bias:
        out.append((name + ".bias", (cout,), "zero"))


def e2vid_spec(conf: dict) -> Spec:
    base, n = conf["e2vid_base_channels"], conf["e2vid_num_encoders"]
    out: Spec = []
    _conv(out, "e2vid.head.conv2d", base, conf["bins"], 5)
    for i in range(n):
        cin, cout = base * 2 ** i, base * 2 ** (i + 1)
        _conv(out, f"e2vid.encoders.{i}.conv.conv2d", cout, cin, 5)
        _conv(out, f"e2vid.encoders.{i}.recurrent_block.Gates", 4 * cout,
              2 * cout, 3)
    top = base * 2 ** n
    for r in range(conf["e2vid_num_residual_blocks"]):
        for c in ("conv1", "conv2"):
            _conv(out, f"e2vid.resblocks.{r}.{c}", top, top, 3)
    for i in range(n):
        feats = base * 2 ** (n - i)
        _conv(out, f"e2vid.decoders.{i}.conv2d", feats // 2, feats, 5)
    _conv(out, "e2vid.pred.conv2d", 1, base, 1)
    return out


def head_spec(conf: dict) -> Spec:
    tch = conf["e2vid_base_channels"] * 2 ** conf["e2vid_num_encoders"]
    out: Spec = []
    ins = dict(init="normal_0.02")
    for k in range(5):
        for j in (0, 3):
            _conv(out, f"head.decoder_scale_1.{k}.model.{j}", tch, tch, 3,
                  **ins)
    _conv(out, "head.decoder_scale_1.5.model.0", tch // 2, tch, 3, **ins)
    _conv(out, "head.decoder_scale_2.0.model.0", tch // 2, tch, 3, **ins)
    _conv(out, "head.decoder_scale_2.1.model.0", tch // 4, tch // 2, 3, **ins)
    _conv(out, "head.decoder_scale_3.0.model.0", tch // 4, tch // 2, 3, **ins)
    _conv(out, "head.decoder_scale_3.1.model.0", tch // 4, tch // 4, 3, **ins)
    _conv(out, "head.decoder_scale_4.0.model.0", tch // 8, tch // 4, 3, **ins)
    _conv(out, "head.decoder_scale_5.0", conf["classes"], tch // 8, 1)
    return out


def _bn(out: Spec, name: str, c: int) -> None:
    out += [(name + ".weight", (c,), "one"), (name + ".bias", (c,), "zero"),
            (name + ".running_mean", (c,), "zero"),
            (name + ".running_var", (c,), "one"),
            (name + ".num_batches_tracked", (), "count")]


def front_spec(conf: dict) -> Spec:
    w = conf["front_base_width"]
    out: Spec = []
    _conv(out, "front.conv1", w, 1, 7, bias=False)
    _bn(out, "front.bn1", w)
    cin = w
    for layer, c in ((1, w), (2, 2 * w), (3, 4 * w)):
        for blk in range(2):
            name = f"front.layer{layer}.{blk}"
            first_in = cin if blk == 0 else c
            _conv(out, name + ".conv1", c, first_in, 3, bias=False)
            _bn(out, name + ".bn1", c)
            _conv(out, name + ".conv2", c, c, 3, bias=False)
            _bn(out, name + ".bn2", c)
            if blk == 0 and first_in != c:
                _conv(out, name + ".downsample.0", c, first_in, 1, bias=False)
                _bn(out, name + ".downsample.1", c)
        cin = c
    return out


def spec(conf: dict, front: bool) -> Spec:
    return e2vid_spec(conf) + head_spec(conf) + (front_spec(conf) if front
                                                 else [])


def make(conf: dict, front: bool, seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """The parameters of ``spec(conf, front)`` from ``seed``: one normal
    draw on ``device`` (a generator there) split into the kernels."""
    sp = spec(conf, front)
    gen = torch.Generator(device=device)
    sub_seed = np.random.SeedSequence([seed, 1]).generate_state(1)[0]
    gen.manual_seed(int(sub_seed))
    drawn = [(n, s, i) for n, s, i in sp if i.startswith(("fan_in", "normal"))]
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for name, shape, init in sp:
        if init == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif init == "one":
            out[name] = torch.ones(shape, device=device)
        elif init == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            n = int(np.prod(shape))
            std = (float(init.split("_")[1]) if init.startswith("normal")
                   else 1.0 / np.sqrt(np.prod(shape[1:])))
            out[name] = flat[pos:pos + n].view(shape) * std
            pos += n
    return out
