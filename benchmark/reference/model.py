"""The ESS networks in plain PyTorch, as functions of a parameter dict.

Written from the published architectures (E2VID, Rebecq et al. 2019; ESS,
Sun et al. 2022; ResNet18, He et al. 2016) in NCHW float32 and their
standard layout: no space-to-depth blocks, no fused kernels. Parameters
are looked up by name (``e2vid.*``, ``head.*``, ``front.*``, the names of
:mod:`benchmark.weights`).

- E2VID recurrent UNet: a 5x5 head conv, three stride-2 5x5 encoder convs
  each feeding a ConvLSTM cell (3x3 gate conv over [x, h], gates i, f, o,
  g), two residual blocks, three bilinear-upsample 5x5 decoder convs with
  summed skips, a 1x1 prediction and a sigmoid; ReLU after every conv but
  the prediction.
- ESS segmentation head: five instance-norm residual blocks at 1/8, then
  nearest 2x upsamplings concatenated with the latent at 1/4 and 1/2,
  instance-norm 3x3 convs, a last upsampling to full size and a 1x1
  classifier.
- ResNet18 image encoder: a 7x7 stride-2 stem and layers 1-3 of basic
  blocks with batch norm in train mode (batch statistics), giving the
  latents at 1/2, 1/4 and 1/8.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import F32, Precision

Params = Dict[str, torch.Tensor]
Latent = Dict[int, torch.Tensor]
State = List[Tuple[torch.Tensor, torch.Tensor]]


def conv(p: Params, name: str, x: torch.Tensor, *, stride: int = 1,
         prec: Precision = F32, int8_layer: bool = False) -> torch.Tensor:
    w = p[name + ".weight"]
    x, w = prec.operands(x, w, int8_layer=int8_layer)
    return F.conv2d(x, w, p.get(name + ".bias"), stride=stride,
                    padding=w.shape[-1] // 2)


def zero_state(batch: int, height: int, width: int, base: int,
               levels: int, device) -> State:
    out = []
    for i in range(levels):
        shape = (batch, base * 2 ** (i + 1), height >> (i + 1),
                 width >> (i + 1))
        out.append((torch.zeros(shape, device=device),
                    torch.zeros(shape, device=device)))
    return out


def e2vid_window(p: Params, x: torch.Tensor, state: State, *, levels: int,
                 residual_blocks: int, decode: bool,
                 prec: Precision = F32, int8_cells: bool = False
                 ) -> Tuple[Optional[torch.Tensor], State, Latent]:
    """One window (B, bins, H, W) -> (image or None, new state, latent
    {1, 2, 4, 8})."""
    head = torch.relu(conv(p, "e2vid.head.conv2d", x, prec=prec))
    h, blocks, new = head, [], []
    for i in range(levels):
        enc = f"e2vid.encoders.{i}"
        h = torch.relu(conv(p, f"{enc}.conv.conv2d", h, stride=2, prec=prec))
        h_prev, c_prev = state[i]
        gates = conv(p, f"{enc}.recurrent_block.Gates",
                     torch.cat([h, h_prev], 1), prec=prec,
                     int8_layer=int8_cells)
        gi, gf, go, gg = gates.chunk(4, 1)
        c = torch.sigmoid(gf) * c_prev + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        new.append((h, c))
        blocks.append(h)
    latent = {1: head, **{2 ** (i + 1): b for i, b in enumerate(blocks)}}
    if not decode:
        return None, new, latent
    h = blocks[-1]
    for r in range(residual_blocks):
        rb = f"e2vid.resblocks.{r}"
        y = torch.relu(conv(p, f"{rb}.conv1", h, prec=prec))
        h = torch.relu(conv(p, f"{rb}.conv2", y, prec=prec) + h)
    for i in range(levels):
        h = F.interpolate(h + blocks[levels - 1 - i], scale_factor=2,
                          mode="bilinear", align_corners=False)
        h = torch.relu(conv(p, f"e2vid.decoders.{i}.conv2d", h, prec=prec))
    img = torch.sigmoid(conv(p, "e2vid.pred.conv2d", h + head, prec=prec))
    return img, new, latent


def rollout(p: Params, windows: torch.Tensor, *, base: int, levels: int,
            residual_blocks: int, decode: bool, prec: Precision = F32,
            int8_cells: bool = False, state: Optional[State] = None):
    """(T, B, bins, H, W) windows from zero state -> (last window's image
    or None, final state, last window's latent)."""
    t, b, _, hh, ww = windows.shape
    if state is None:
        state = zero_state(b, hh, ww, base, levels, windows.device)
    img = latent = None
    for i in range(t):
        img, state, latent = e2vid_window(
            p, windows[i], state, levels=levels,
            residual_blocks=residual_blocks, decode=decode and i == t - 1,
            prec=prec, int8_cells=int8_cells)
    return img, state, latent


def _inorm(x: torch.Tensor) -> torch.Tensor:
    return F.instance_norm(x, eps=1e-5)


def _relu_ins(p: Params, name: str, x, prec) -> torch.Tensor:
    return torch.relu(_inorm(conv(p, name + ".model.0", x, prec=prec)))


def _up(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def seghead(p: Params, latent: Latent, *, prec: Precision = F32) -> Latent:
    """The skip-connect (concat) head -> {8: latent, 4, 2: features, 1:
    class logits at full size}."""
    x = latent[8]
    for k in range(5):
        name = f"head.decoder_scale_1.{k}.model"
        y = torch.relu(_inorm(conv(p, name + ".0", x, prec=prec)))
        x = _inorm(conv(p, name + ".3", y, prec=prec)) + x
    x = _relu_ins(p, "head.decoder_scale_1.5", x, prec)
    x = torch.cat([_up(x), latent[4]], 1)
    x = _relu_ins(p, "head.decoder_scale_2.0", x, prec)
    out4 = x = _relu_ins(p, "head.decoder_scale_2.1", x, prec)
    x = torch.cat([_up(x), latent[2]], 1)
    x = _relu_ins(p, "head.decoder_scale_3.0", x, prec)
    out2 = x = _relu_ins(p, "head.decoder_scale_3.1", x, prec)
    x = _relu_ins(p, "head.decoder_scale_4.0", _up(x), prec)
    logits = conv(p, "head.decoder_scale_5.0", x, prec=prec)
    return {8: latent[8], 4: out4, 2: out2, 1: logits}


def _bn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, None, None, p[name + ".weight"], p[name + ".bias"],
                        training=True, eps=1e-5)


def _basic(p: Params, name: str, x, stride: int, prec) -> torch.Tensor:
    y = torch.relu(_bn(p, name + ".bn1",
                       conv(p, name + ".conv1", x, stride=stride, prec=prec)))
    y = _bn(p, name + ".bn2", conv(p, name + ".conv2", y, prec=prec))
    if name + ".downsample.0.weight" in p:
        x = _bn(p, name + ".downsample.1",
                conv(p, name + ".downsample.0", x, stride=stride, prec=prec))
    return torch.relu(y + x)


def front(p: Params, img: torch.Tensor, *, prec: Precision = F32) -> Latent:
    """(B, 1, H, W) image -> {1: image, 2, 4, 8: features}, batch norm on
    the batch's statistics (train mode)."""
    out = {1: img}
    h = torch.relu(_bn(p, "front.bn1",
                       conv(p, "front.conv1", img, stride=2, prec=prec)))
    for scale, layer in ((2, 1), (4, 2), (8, 3)):
        for blk in range(2):
            h = _basic(p, f"front.layer{layer}.{blk}", h,
                       2 if (layer > 1 and blk == 0) else 1, prec)
        out[scale] = h
    return out
