"""Recurrent E2VID rollout over a stack of event windows.

Counterpart of ``ess_tpu/recon/reconstructor.py::Reconstructor`` (``step``,
``rollout``) for windows that arrive already normalized, from the pipeline
or from the reconstruction program: every window is reflection-padded to
the UNet-divisible size, the rollout starts from zero state, runs
encoder-only until the last window and decodes only that one. A Python loop
takes the place of the JAX ``lax.scan``. As there, the rollout runs in block
space by default: every padded window is folded into 2x2 space-to-depth
blocks and the model's head and first-encoder convs run as 3x3 convs over
them; a model with a norm rolls out in the standard layout (JAX's
``_use_blocks``).

:meth:`Reconstructor.rollout_events` is JAX's ``rollout_events``, the
in-loop form: each window is voxelized from the batch's event columns
just before its step, so one window's grid is alive at a time instead of
the (T, B, C, H, W) stack. :meth:`Reconstructor.rollout` also takes
space-to-depth block windows (``windows_s2d``), and
:meth:`Reconstructor.rollout_raw` (JAX's) maps each window of a stack or
raw build (``EventPipeline.build_all_stack`` / ``build_all_raw``) to its
block window just before its step. A quad-block model
(``RecurrentUNet(quad_block=True)``) rolls out on 4x4 blocks
(``space_to_depth4``, or the pipeline's ``layout='s4d'`` windows with
``windows_s2d``) from a state whose first level lies in s2d form
(:meth:`Reconstructor.init_state`), in block space as always; with a norm
it rolls out in the standard layout, as JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ess_tpu_torch.models.e2vid import RecurrentUNet, zero_recurrent_state
from ess_tpu_torch.ops.conv_s2d import space_to_depth, space_to_depth4
from ess_tpu_torch.ops.pad import CropGeometry, reflect_pad


@dataclass(frozen=True)
class Reconstructor:
    """Model plus the static input geometry and, per rollout, the ConvLSTM
    cell (``lstm_impl``: a resolved cell name; None = the model's; a ConvGRU
    model has no cell name), the layout (``block_space``: head and first
    encoder on space-to-depth blocks, the same function over the same
    parameters, where the model has no norm) and the block convs'
    implementation (``block_conv_impl``: ``'xla'``, ``'pallas'`` or
    ``'pallas_int8'``; None = the model's)."""

    model: RecurrentUNet
    height: int
    width: int
    lstm_impl: Optional[str] = None
    block_space: bool = True
    block_conv_impl: Optional[str] = None

    @property
    def use_blocks(self) -> bool:
        """Block space asked for and possible: the model has no norm."""
        return self.block_space and self.model.norm is None

    @property
    def geometry(self) -> CropGeometry:
        return CropGeometry(self.height, self.width, self.model.num_encoders)

    @property
    def quad(self) -> bool:
        """A quad-block rollout: the model's ``quad_block`` in block
        space."""
        return self.use_blocks and self.model.quad_block

    def init_state(self, batch: int, device=None):
        """Zero recurrent state at the padded size on ``device`` (None: the
        first CUDA device); a quad-block rollout's first level in s2d
        form."""
        g = self.geometry
        return zero_recurrent_state(
            batch, g.padded_height, g.padded_width,
            num_encoders=self.model.num_encoders,
            base_channels=self.model.base_channels,
            recurrent_block=self.model.recurrent_block,
            quad_block=self.quad, dtype=self.model.dtype, device=device)

    def step(self, events: torch.Tensor, state, *, decode: bool = True,
             events_s2d: bool = False):
        """One window (B, C, H, W): reflect pad -> recurrent forward.
        Returns (image (B, 1, Hp, Wp) or None, new state, latent);
        :func:`ess_tpu_torch.ops.pad.crop_output` crops the image back.
        With ``events_s2d`` the window arrives as (B, 4C, H/2, W/2)
        space-to-depth blocks, or (B, 16C, H/4, W/4) 4x4 blocks for a
        quad-block rollout; that needs a block-space rollout and a
        geometry that needs no pad."""
        g = self.geometry
        if events_s2d:
            if not self.use_blocks:
                raise ValueError("events_s2d needs a block-space rollout")
            if any(g.pads):
                raise ValueError(
                    f"events_s2d: a {self.height}x{self.width} rollout pads "
                    f"to {(g.padded_height, g.padded_width)}")
        d = (4 if self.quad else 2) if events_s2d else 1
        want = (self.height // d, self.width // d)
        if tuple(events.shape[-2:]) != want:
            raise ValueError(
                f"window {tuple(events.shape[-2:])} for a {self.height}x"
                f"{self.width} rollout"
                + (f" in {d}x{d} blocks" if events_s2d else ""))
        if not events_s2d:
            events = reflect_pad(events, g)
            if self.use_blocks:
                events = (space_to_depth4 if self.quad
                          else space_to_depth)(events)
        return self.model(events, state, decode=decode,
                          lstm_impl=self.lstm_impl,
                          block_input=self.use_blocks,
                          block_conv_impl=self.block_conv_impl)

    def rollout(self, windows: torch.Tensor, init_state=None, *,
                decode: bool = True, windows_s2d: bool = False,
                time_major: bool = True):
        """(T, B, C, H, W) windows -> (final image, final state, final
        latent). ``decode=False`` decodes no window (the image is None):
        the train step reads only the latent. ``windows_s2d``: (T, B, 4C,
        H/2, W/2) space-to-depth block windows (:meth:`step`'s
        ``events_s2d``); ``time_major=False``: (B, T, ...)."""
        if not time_major:
            windows = windows.transpose(0, 1)
        t_dim, b = windows.shape[:2]
        state = (self.init_state(b, windows.device) if init_state is None
                 else init_state)
        for i in range(t_dim - 1):
            _, state, _ = self.step(windows[i], state, decode=False,
                                    events_s2d=windows_s2d)
        return self.step(windows[t_dim - 1], state, decode=decode,
                         events_s2d=windows_s2d)

    def rollout_raw(self, raw: torch.Tensor, stats: Optional[torch.Tensor],
                    window_map: Callable[..., torch.Tensor],
                    init_state=None, *, decode: bool = True):
        """A stack or raw build's ``raw`` (T, B, ...) and ``stats`` (T, B,
        3) or None -> (final image, final state, final latent), as
        :meth:`rollout` with ``windows_s2d``: window ``i`` is
        ``window_map(raw[i], stats[i])``, mapped just before its step."""
        t_dim, b = raw.shape[:2]
        state = (self.init_state(b, raw.device) if init_state is None
                 else init_state)

        def window(i):
            return window_map(raw[i], None if stats is None else stats[i])

        for i in range(t_dim - 1):
            _, state, _ = self.step(window(i), state, decode=False,
                                    events_s2d=True)
        return self.step(window(t_dim - 1), state, decode=decode,
                         events_s2d=True)

    def rollout_events(self, soa: Dict[str, torch.Tensor],
                       voxel_fn: Callable[..., torch.Tensor],
                       init_state=None, *, decode: bool = True):
        """The in-loop rollout: f32 event columns ``"ev_x"``, ``"ev_y"``,
        ``"ev_t"``, ``"ev_p"``, ``"ev_valid"`` (B, T, N) and the offsets
        the batch carries (``"ev_band_offsets"``, else
        ``"ev_tile_offsets"``, else none) -> (final image, final state,
        final latent), as :meth:`rollout`. Window ``i`` is
        ``voxel_fn(x, y, t, p, valid, tile_offsets=)`` of the batch's
        ``[:, i]`` columns (``EventPipeline.make_window_fn``), voxelized
        just before its step: T voxelizer launches where :meth:`rollout`
        takes one batched build. A packed batch is decoded before it gets
        here (``EventPipeline.decode_packed``)."""
        key = ("ev_band_offsets" if "ev_band_offsets" in soa
               else "ev_tile_offsets")
        offs = soa.get(key)
        b, t_dim = soa["ev_x"].shape[:2]

        def window(i):
            col = lambda k: soa[k][:, i]
            return voxel_fn(col("ev_x"), col("ev_y"), col("ev_t"),
                            col("ev_p"), col("ev_valid"),
                            tile_offsets=None if offs is None else offs[:, i])

        state = (self.init_state(b, soa["ev_x"].device) if init_state is None
                 else init_state)
        for i in range(t_dim - 1):
            _, state, _ = self.step(window(i), state, decode=False)
        return self.step(window(t_dim - 1), state, decode=decode)
