"""Recurrent E2VID rollout over a stack of event windows.

Counterpart of ``ess_tpu/recon/reconstructor.py`` (``Reconstructor``,
``preprocess_event_tensor``): every window is preprocessed (``flip``
reverses H and W, then ``normalize`` standardizes each sample's nonzero
entries; both as JAX's fields, ``normalize`` on by default, so the
pipeline's and the reconstruction program's windows, which arrive
normalized, pass ``normalize=False`` as JAX's callers do),
reflection-padded to the UNet-divisible size and stepped; the rollout
starts from zero state, runs encoder-only until the last window and
decodes only that one (``no_recurrent``: only the last window, from the
initial state), and ``standardize`` min-max scales each decoded image.
:meth:`Reconstructor.rollout_all` decodes every window. A Python loop
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
from ess_tpu_torch.ops.voxel import normalize_nonzero


def preprocess_event_tensor(events: torch.Tensor, *, normalize: bool = True,
                            flip: bool = False) -> torch.Tensor:
    """Per-sample preprocessing of (B, C, H, W) event tensors: ``flip``
    reverses H and W, then ``normalize`` standardizes each sample's
    nonzero entries to mean 0 and std 1."""
    if flip:
        events = events.flip(-2, -1)
    if normalize:
        events = normalize_nonzero(events)
    return events


def standardize_images(img: torch.Tensor) -> torch.Tensor:
    """Per-image min-max scaling over (C, H, W) to [0, 1], the range
    floored at 1e-12."""
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    return (img - lo) / torch.clamp(hi - lo, min=1e-12)


def _copy_state(state):
    """A copy of a recurrent state: per level an (h, c) pair or h alone,
    memory formats kept."""
    return tuple(tuple(t.clone() for t in level)
                 if isinstance(level, tuple) else level.clone()
                 for level in state)


@dataclass(frozen=True)
class Reconstructor:
    """Model plus the static input geometry, JAX's per-window options
    (``normalize``, ``flip``, ``standardize``, ``no_recurrent``: the state
    is not carried from window to window) and, per rollout, the ConvLSTM
    cell (``lstm_impl``: a resolved cell name; None = the model's; a ConvGRU
    model has no cell name), the layout (``block_space``: head and first
    encoder on space-to-depth blocks, the same function over the same
    parameters, where the model has no norm) and the block convs'
    implementation (``block_conv_impl``: ``'xla'``, ``'pallas'`` or
    ``'pallas_int8'``; None = the model's)."""

    model: RecurrentUNet
    height: int
    width: int
    normalize: bool = True
    flip: bool = False
    standardize: bool = False
    no_recurrent: bool = False
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
        """One window (B, C, H, W): flip and normalize (the fields) ->
        reflect pad -> recurrent forward -> ``standardize`` of a decoded
        image. Returns (image (B, 1, Hp, Wp) or None, new state, latent);
        :func:`ess_tpu_torch.ops.pad.crop_output` crops the image back.
        With ``events_s2d`` the window arrives as (B, 4C, H/2, W/2)
        space-to-depth blocks, or (B, 16C, H/4, W/4) 4x4 blocks for a
        quad-block rollout; that needs a block-space rollout, a geometry
        that needs no pad and no ``flip``, and ``normalize`` standardizes
        the blocks (the same value set)."""
        g = self.geometry
        if events_s2d:
            if not self.use_blocks:
                raise ValueError("events_s2d needs a block-space rollout")
            if self.flip:
                raise ValueError("events_s2d windows cannot be flipped")
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
        if events_s2d:
            if self.normalize:
                events = normalize_nonzero(events)
        else:
            events = reflect_pad(preprocess_event_tensor(
                events, normalize=self.normalize, flip=self.flip), g)
            if self.use_blocks:
                events = (space_to_depth4 if self.quad
                          else space_to_depth)(events)
        img, new_state, latent = self.model(
            events, state, decode=decode, lstm_impl=self.lstm_impl,
            block_input=self.use_blocks,
            block_conv_impl=self.block_conv_impl)
        if img is not None and self.standardize:
            img = standardize_images(img)
        return img, new_state, latent

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
        for i in self._carried(t_dim):
            _, state, _ = self.step(windows[i], state, decode=False,
                                    events_s2d=windows_s2d)
        return self.step(windows[t_dim - 1], state, decode=decode,
                         events_s2d=windows_s2d)

    def _carried(self, t_dim: int) -> range:
        """The windows stepped encoder-only before the last: every one but
        the last, none with ``no_recurrent`` (the last window then steps
        from the initial state, as JAX's rollouts skip their scan)."""
        return range(0 if self.no_recurrent else t_dim - 1)

    def rollout_all(self, windows: torch.Tensor, init_state=None, *,
                    time_major: bool = True):
        """Decode every window: (T, B, C, H, W) windows (``time_major=
        False``: (B, T, ...)) -> (images (T, B, 1, Hp, Wp), final state),
        the reconstruction program's frames. With ``no_recurrent`` each
        window steps from a copy of the initial state (the CUDA cell
        updates its c in place), which is also the final state returned."""
        if not time_major:
            windows = windows.transpose(0, 1)
        t_dim, b = windows.shape[:2]
        state = (self.init_state(b, windows.device) if init_state is None
                 else init_state)
        imgs = []
        for i in range(t_dim):
            if self.no_recurrent:
                img, _, _ = self.step(windows[i], _copy_state(state))
            else:
                img, state, _ = self.step(windows[i], state)
            imgs.append(img)
        return torch.stack(imgs), state

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

        for i in self._carried(t_dim):
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
        just before its step: T voxelizer launches (one with
        ``no_recurrent``) where :meth:`rollout` takes one batched build. A packed batch is decoded before it gets
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
        for i in self._carried(t_dim):
            _, state, _ = self.step(window(i), state, decode=False)
        return self.step(window(t_dim - 1), state, decode=decode)
