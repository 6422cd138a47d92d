"""Recurrent E2VID rollout over a stack of event windows.

Counterpart of ``ess_tpu/recon/reconstructor.py::Reconstructor`` (``step``,
``rollout``) on the eval path: windows arrive already normalized from the
pipeline, the rollout starts from zero state, runs encoder-only until the
last window and decodes only that one. A Python loop takes the place of the
JAX ``lax.scan``. As there, the rollout runs in block space by default:
every window is folded into 2x2 space-to-depth blocks and the model's head
and first-encoder convs run as 3x3 convs over them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ess_tpu_torch.models.e2vid import RecurrentUNet, zero_recurrent_state
from ess_tpu_torch.ops.conv_s2d import space_to_depth
from ess_tpu_torch.ops.pad import CropGeometry


@dataclass(frozen=True)
class Reconstructor:
    """Model plus the static input geometry and, per rollout, the ConvLSTM
    cell (``lstm_impl``: a resolved cell name; None = the model's), the
    layout (``block_space``: head and first encoder on space-to-depth
    blocks, the same function over the same parameters) and the block
    convs' implementation (``block_conv_impl``: ``'xla'``, ``'pallas'`` or
    ``'pallas_int8'``; None = the model's)."""

    model: RecurrentUNet
    height: int
    width: int
    lstm_impl: Optional[str] = None
    block_space: bool = True
    block_conv_impl: Optional[str] = None

    @property
    def geometry(self) -> CropGeometry:
        return CropGeometry(self.height, self.width, self.model.num_encoders)

    def init_state(self, batch: int, device=None):
        """Zero recurrent state on ``device`` (None: the first CUDA
        device)."""
        g = self.geometry
        return zero_recurrent_state(
            batch, g.padded_height, g.padded_width,
            num_encoders=self.model.num_encoders,
            base_channels=self.model.base_channels,
            dtype=self.model.dtype, device=device)

    def step(self, events: torch.Tensor, state, *, decode: bool = True,
             events_s2d: bool = False):
        """One window (B, C, H, W) -> (image (B, 1, H, W) or None, new
        state, latent). With ``events_s2d`` the window arrives as
        (B, 4C, H/2, W/2) space-to-depth blocks; that needs a block-space
        rollout."""
        g = self.geometry
        if any(g.pads):
            raise ValueError(
                f"a {self.height}x{self.width} rollout padded to "
                f"{(g.padded_height, g.padded_width)}: the port implements "
                "no pad")
        if events_s2d and not self.block_space:
            raise ValueError("events_s2d needs a block-space rollout")
        want = ((self.height // 2, self.width // 2) if events_s2d
                else (self.height, self.width))
        if tuple(events.shape[-2:]) != want:
            raise ValueError(
                f"window {tuple(events.shape[-2:])} for a {self.height}x"
                f"{self.width} rollout"
                + (" in space-to-depth blocks" if events_s2d else ""))
        if self.block_space and not events_s2d:
            events = space_to_depth(events)
        return self.model(events, state, decode=decode,
                          lstm_impl=self.lstm_impl,
                          block_input=self.block_space,
                          block_conv_impl=self.block_conv_impl)

    def rollout(self, windows: torch.Tensor, init_state=None, *,
                decode: bool = True):
        """(T, B, C, H, W) windows -> (final image, final state, final
        latent). ``decode=False`` decodes no window (the image is None):
        the train step reads only the latent."""
        t_dim, b = windows.shape[:2]
        state = (self.init_state(b, windows.device) if init_state is None
                 else init_state)
        for i in range(t_dim - 1):
            _, state, _ = self.step(windows[i], state, decode=False)
        return self.step(windows[t_dim - 1], state, decode=decode)
