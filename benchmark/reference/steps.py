"""The reference's steps: the supervised and UDA train steps and one scored
streaming segment, from raw events and the benchmark's weights.

``conf`` is a configuration file of ``benchmark/configs`` (as a dict). Every
step runs in float32 (or the control's lowered precision,
:mod:`benchmark.reference.precision`) on whatever device the tensors lie.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import model
from benchmark.reference.model import Latent
from benchmark.reference.losses import (
    RAdam, confusion, l1, leaf_norms, symmetric_js, task_loss)
from benchmark.reference.precision import F32, Precision
from benchmark.reference.voxel import model_input


HEAD_SCALES = (2, 4, 8)   # the latent's scales that the head reads


def windows(conf: dict, events: np.ndarray, device) -> torch.Tensor:
    """(B, T, N, 4) raw events -> (T, B, bins, H, W) model input."""
    out = []
    for sample in events:
        ev = torch.from_numpy(np.ascontiguousarray(sample)).to(device)
        out.append(model_input(
            ev, bins=conf["bins"],
            sensor=(conf["sensor_height"], conf["sensor_width"]),
            crop_bottom=conf["crop_bottom"],
            integer=conf["integer_coordinates"],
            resize_to=conf.get("resize_to")))
    return torch.stack(out, 1)


def _rollout(conf, params, events, device, *, decode, prec, int8_cells):
    with torch.no_grad():
        return model.rollout(
            params, windows(conf, events, device),
            base=conf["e2vid_base_channels"],
            levels=conf["e2vid_num_encoders"],
            residual_blocks=conf["e2vid_num_residual_blocks"],
            decode=decode, prec=prec, int8_cells=int8_cells)


def _trainable(params: Dict[str, torch.Tensor], prefix: str):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()
            if k.startswith(prefix) and v.is_floating_point()
            and "running_" not in k}


def train_steps(conf: dict, params: Dict[str, torch.Tensor],
                batches: List[dict], *, uda: bool = False,
                prec: Precision = F32, device=None,
                latents: Optional[List[Latent]] = None) -> dict:
    """Train steps from ``params`` on ``batches`` (each ``events`` (B, T,
    N, 4), ``label`` (B, H, W); for UDA ``image_a`` (B, 1, H, W) and
    ``label_a``) -> each step's loss, the first step's gradient and the
    parameters' change after the last step, each as norms by leaf.

    With ``latents`` (supervised steps: the head's input latents that the
    program's rollout gave, one {8, 4, 2} a step) the head, the loss and
    the optimizer follow those latents, where they have the shapes of the
    reference's own; the reference's own rollout's latents are returned
    beside (``latents``, on the host) for the rollout's check."""
    device = device or next(iter(params.values())).device
    int8 = conf["train_cells"] == "int8"
    head = _trainable(params, "head.")
    parts = {"head": head}
    if uda:
        parts["front"] = _trainable(params, "front.")
    opts = {k: RAdam(list(v.values()),
                     conf["lr_back"] if k == "head" else conf["lr_front"])
            for k, v in parts.items()}
    losses, grad1, own = [], {}, []
    nc = conf["classes"]
    for i, b in enumerate(batches):
        img_fake, _, latent = _rollout(conf, params, b["events"], device,
                                       decode=uda, prec=prec,
                                       int8_cells=int8)
        if latents is not None:
            own.append({s: latent[s].cpu() for s in HEAD_SCALES})
            given = {s: latents[i][s].to(device).float()
                     for s in HEAD_SCALES}
            if all(given[s].shape == latent[s].shape for s in HEAD_SCALES):
                latent = given
        p = {**params, **{k: v for part in parts.values()
                          for k, v in part.items()}}
        if uda:
            loss_front, loss_head, total = _uda_losses(
                conf, p, b, img_fake, latent, device, prec)
            grads = {"front": torch.autograd.grad(
                         loss_front, list(parts["front"].values())),
                     "head": torch.autograd.grad(
                         loss_head, list(head.values()))}
        else:
            label = torch.from_numpy(b["label"]).to(device)
            logits = model.seghead(p, latent, prec=prec)[1]
            total = task_loss(logits, label, nc) * conf["weight_task_loss"]
            grads = {"head": torch.autograd.grad(total, list(head.values()))}
        losses.append(float(total.detach()))
        if i == 0:
            for k, part in parts.items():
                grad1.update(leaf_norms(dict(zip(part, grads[k]))))
        for k, part in parts.items():
            opts[k].step(list(grads[k]))
    delta = {}
    for part in parts.values():
        delta.update(leaf_norms({k: v - params[k] for k, v in part.items()}))
    out = {"losses": losses, "grad1": grad1, "delta": delta}
    if latents is not None:
        out["latents"] = own
    return out


def _uda_losses(conf, p, b, img_fake, latent_real, device, prec):
    """ESS UDA's losses -> (front loss, head loss, total), as the step's
    gradients split them on DSEC: the image branch's front features are
    detached, the cycle-embedding and cycle-prediction terms train the
    front, the task and event-prediction terms train the head."""
    nc = conf["classes"]
    img_a = torch.from_numpy(b["image_a"]).to(device)
    label_a = torch.from_numpy(b["label_a"]).to(device)
    latent_a = {k: v.detach() for k, v in
                model.front(p, img_a, prec=prec).items()}
    t_img = task_loss(model.seghead(p, latent_a, prec=prec)[1], label_a,
                      nc) * conf["weight_task_loss"]
    latent_fake = model.front(p, img_fake, prec=prec)
    e_loss = sum(l1(latent_fake[s], latent_real[s])
                 for s in (2, 4, 8)) * conf["weight_cycle_emb_loss"]
    pred_fake = model.seghead(p, latent_fake, prec=prec)
    pred_real = model.seghead(p, latent_real, prec=prec)
    e_loss = e_loss + symmetric_js(pred_fake[1], pred_real[1].detach())
    t_ev = symmetric_js(pred_real[1], pred_fake[1].detach()) \
        * conf["weight_cycle_pred_loss"]
    for s in (2, 4):
        w = conf["weight_cycle_task_loss"]
        e_loss = e_loss + l1(pred_fake[s], pred_real[s].detach()) * w
        t_ev = t_ev + l1(pred_real[s], pred_fake[s].detach()) * w
    return e_loss, t_img + t_ev, t_img + e_loss + t_ev


@torch.no_grad()
def stream_segment(conf: dict, params: Dict[str, torch.Tensor],
                   events: np.ndarray, label: np.ndarray, *,
                   prec: Precision = F32, device=None) -> dict:
    """One streaming segment from zero state: (S, W, N, 4) events of S
    streams over W windows, the last scored against ``label`` (S, H, W)
    -> the final state [(h, c)] by level and the confusion matrix."""
    device = device or next(iter(params.values())).device
    _, state, latent = _rollout(conf, params, events, device, decode=False,
                                prec=prec, int8_cells=False)
    logits = model.seghead(params, latent, prec=prec)[1]
    lab = torch.from_numpy(label).to(device)
    return {"state": state,
            "cm": confusion(logits.argmax(1), lab, conf["classes"])}

