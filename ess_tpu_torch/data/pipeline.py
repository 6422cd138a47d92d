"""Event-sample pipeline: voxelize, normalize, crop, resize, augment.

Counterpart of ``ess_tpu/data/pipeline.py`` (``PipelineConfig``, ``to_soa``,
``AugmentParams``, ``EventPipeline.sample_augment``, ``_transform_grid``,
``make_window_fn``, ``apply_label_transform``, ``decode_packed`` and
``build_all``) on every event wire: host-folded band batches
(``ev_band_offsets``), host tile-sorted batches (``ev_tile_offsets``) and
raw batches with no offsets, which are tile-sorted on the device, each with
f32 columns (``ev_x``...) or, for the two host-binned ones, the packed u16
columns (``ev_xq``...; ``decode_packed`` turns them into f32 columns where
the batch lies, with the time already normalized). ``build_all``
voxelizes all B*T windows of a batch in one launch, window-major;
``make_window_fn`` voxelizes one window at a time for the streaming steps
and the in-loop rollout (``Reconstructor.rollout_events``); ``__call__``
builds the dense form, raw (B, T, N, 4) events -> ``"events"`` (B, T, H,
W, C), the batch the steps take prebuilt.

With ``PipelineConfig.rectify`` and a rectify map (DSEC's (480, 640, 2)
lookup, kept on the pipeline's device), every path rectifies raw events on
the device before it voxelizes them (``ops/batch_voxel.rectify_events``);
host-binned wires were rectified on the host, and their offsets with a map
raise.

The transforms run in the JAX package's order: the per-window normalization
at sensor resolution (inside the voxelizer: the nonzero standardization does
not commute with a resize), the bottom crop (DSEC 480 -> 440, DDD17
260 -> 200 rows), the bilinear resize (DDD17's 346 -> 352 width, with
``align_corners`` as the reference), the per-sample crop (DDD17 UDA's
bottom-anchored 120x216, drawn from the post-resize size) and the flip; a
cropped or flipped sample has its windows and its label transformed
together, whatever the representation (``voxel_grid``, ``histogram`` or
``ev_segnet``).

The voxelizer's opt-in pins, JAX's: ``voxel_oh_dtype='int8'`` (the
voxelizers' int8 tent planes, on every path that voxelizes, the dense
``__call__`` aside, as in JAX), ``stack_windows`` (``build_all_stack``:
B1 emits the space-to-depth NCHW window stack, normalization, flip and crop
deferred to a per-window map) and ``raw_windows`` (``build_all_raw``: the
raw band accumulator, the fine space-to-depth transform in the per-window
map); ``build_all(layout='s2d')`` builds space-to-depth block windows.
Each is taken by the steps' rollout under JAX's conditions
(``s2d_capable``, ``stack_capable``, ``raw_capable``;
``train/supervised.py::rollout_form``). The windows of the stack and raw
forms are normalized in f32 and cast last, as the standard build does, so
they equal its windows bit for bit.

Augmentation draws come from an explicit ``torch.Generator``; they cannot
reproduce JAX's PRNG bits, so parity tests pass :class:`AugmentParams`
explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ess_tpu_torch import resolve_device
from ess_tpu_torch.data.native import COORD_SCALE, POL_SCALE, TIME_SCALE
from ess_tpu_torch.ops.batch_voxel import (
    REPRESENTATIONS, effective_bins, flat_windows, voxelize_window_soa)
from ess_tpu_torch.ops.resize import resize_bilinear
from ess_tpu_torch.ops.voxel import normalize_from_stats
from ess_tpu_torch.ops.voxel_scatter import OH_DTYPES, tile_h_for_bins


@dataclass(frozen=True)
class PipelineConfig:
    """Static geometry and augmentation of one event dataset."""

    sensor_height: int
    sensor_width: int
    num_bins: int = 5
    representation: str = "voxel_grid"
    separate_pol: bool = False
    normalize: bool = False          # per-window nonzero normalization
    crop_bottom: int = 0             # rows dropped from the bottom
    resize_to: Optional[Tuple[int, int]] = None   # (H, W) after the crop
    # the reference resizes event tensors with align_corners=True
    resize_align_corners: bool = True
    random_crop: Optional[Tuple[int, int]] = None  # train-time crop (H, W)
    crop_anchor: str = "random"      # 'random' | 'bottom'
    random_flip: bool = False        # train-time horizontal flip
    trilinear: bool = False          # float-coordinate 8-corner voxelizer
                                     # (rectified streams); False = temporal
                                     # bilinear on floored coordinates
    rectify: bool = False            # apply the rectify map on the device
    # tent-plane operands of the voxelizers: 'bfloat16' (JAX's default) and
    # 'float32' take the f32 core, 'int8' the int8 tent planes
    voxel_oh_dtype: str = "bfloat16"
    # raw-window mode (build_all_raw): the rollout maps the voxelizer's raw
    # band accumulator to each window just before its step; None = off
    raw_windows: Optional[bool] = None
    # stack-window mode (build_all_stack): B1 emits the s2d NCHW window
    # stack; x-slot band batches, no resize; None = off
    stack_windows: Optional[bool] = None

    def __post_init__(self):
        if self.representation not in REPRESENTATIONS:
            raise ValueError(f"unknown representation "
                             f"{self.representation!r}; expected one of "
                             f"{REPRESENTATIONS}")
        if self.voxel_oh_dtype not in OH_DTYPES:
            raise ValueError(f"voxel_oh_dtype {self.voxel_oh_dtype!r} not "
                             f"in {OH_DTYPES}")
        for name in ("raw_windows", "stack_windows"):
            if getattr(self, name) not in (None, True, False):
                raise ValueError(f"{name} must be None, True or False, got "
                                 f"{getattr(self, name)!r}")

    @property
    def channels(self) -> int:
        """Channels of a built window. JAX's property gives ``num_bins``
        for ``ev_segnet``; this is the grid's real count (6)."""
        if self.representation == "histogram":
            return 2
        if self.representation == "ev_segnet":
            return 6
        return effective_bins(self.num_bins, self.separate_pol,
                              self.trilinear)

    @property
    def post_crop_size(self) -> Tuple[int, int]:
        return (self.sensor_height - self.crop_bottom, self.sensor_width)

    @property
    def pre_aug_size(self) -> Tuple[int, int]:
        """The size after the bottom crop and the resize: what labels are
        stored at and what the per-sample crop draws from."""
        return (tuple(self.resize_to) if self.resize_to is not None
                else self.post_crop_size)

    def output_size(self, train: bool) -> Tuple[int, int]:
        if train and self.random_crop is not None:
            return tuple(self.random_crop)
        return self.pre_aug_size


def to_soa(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Split an AoS raw-event batch into contiguous SoA buffers.

    {"raw_events": (..., N, 4), "valid": (..., N)} -> {"ev_x", "ev_y",
    "ev_t", "ev_p": (..., N) f32, "ev_valid": (..., N) bool}; host offsets
    ("tile_offsets", "band_offsets") ride along as "ev_tile_offsets" /
    "ev_band_offsets", every other key unchanged. Numpy arrays on the host,
    or tensors where they lie (a batch after ``loader.prefetch_to_device``).
    A packed batch ("ev_xq", ...) is SoA already: only its offsets are
    renamed.
    """
    if "ev_xq" in batch:
        return {("ev_" + k if k in ("tile_offsets", "band_offsets") else k):
                v for k, v in batch.items()}
    out = {k: v for k, v in batch.items()
           if k not in ("raw_events", "valid", "tile_offsets",
                        "band_offsets")}
    raw = batch["raw_events"]
    contiguous = (torch.Tensor.contiguous if isinstance(raw, torch.Tensor)
                  else np.ascontiguousarray)
    for i, k in enumerate(("ev_x", "ev_y", "ev_t", "ev_p")):
        out[k] = contiguous(raw[..., i])
    out["ev_valid"] = contiguous(batch["valid"])
    for k in ("tile_offsets", "band_offsets"):
        if k in batch:
            out["ev_" + k] = batch[k]
    return out


@dataclass(frozen=True)
class AugmentParams:
    """Per-sample augmentation draws, shared across a sample's windows."""

    flip: Optional[torch.Tensor] = None      # (B,) bool
    crop_y: Optional[torch.Tensor] = None    # (B,) integer
    crop_x: Optional[torch.Tensor] = None    # (B,) integer

    def rows(self, lo: int, hi: int) -> "AugmentParams":
        """The draws of samples ``[lo, hi)`` (a data-parallel rank's rows
        of the global batch's draws)."""
        return AugmentParams(*(None if v is None else v[lo:hi]
                               for v in (self.flip, self.crop_y,
                                         self.crop_x)))


def random_flip(x: torch.Tensor, flip: torch.Tensor, batch_dim: int
                ) -> torch.Tensor:
    """Mirror ``x`` along its last (width) axis where ``flip`` (one bool per
    entry of ``x``'s ``batch_dim``) is set."""
    shape = [1] * x.ndim
    shape[batch_dim] = -1
    sel = flip.to(device=x.device, dtype=torch.bool).view(shape)
    return torch.where(sel, x.flip(-1), x)


def crop_per_sample(x: torch.Tensor, crop_y: torch.Tensor,
                    crop_x: torch.Tensor, size: Tuple[int, int]
                    ) -> torch.Tensor:
    """(B, ..., H, W) -> (B, ..., ch, cw): sample ``i`` keeps the window at
    (``crop_y[i]``, ``crop_x[i]``). A gather, so the offsets stay on their
    device."""
    ch, cw = size
    dev = x.device
    rows = crop_y.to(dev).long()[:, None] + torch.arange(ch, device=dev)
    cols = crop_x.to(dev).long()[:, None] + torch.arange(cw, device=dev)
    mid = (1,) * (x.ndim - 3)
    rows = rows.view(-1, *mid, ch, 1).expand(*x.shape[:-2], ch, x.shape[-1])
    x = torch.gather(x, -2, rows)
    cols = cols.view(-1, *mid, 1, cw).expand(*x.shape[:-1], cw)
    return torch.gather(x, -1, cols)


class EventPipeline:
    """Builds model-input windows from event batches.

    ``rectify_map``: an (H, W, 2) array or tensor, stored as an f32 tensor
    on ``device`` (None: where a tensor map lies, else the first CUDA
    device); ``cfg.rectify`` without one raises, as in JAX."""

    def __init__(self, cfg: PipelineConfig, rectify_map=None, *,
                 device=None):
        self.cfg = cfg
        self.rectify_map = None
        if rectify_map is not None:
            if device is None and isinstance(rectify_map, torch.Tensor):
                device = rectify_map.device
            self.rectify_map = torch.as_tensor(
                rectify_map, dtype=torch.float32,
                device=resolve_device(device)).contiguous()
        if cfg.rectify and self.rectify_map is None:
            raise ValueError("rectify=True requires a rectify_map")

    @property
    def _rectify(self) -> Optional[torch.Tensor]:
        """The map the voxelizers apply: None unless ``cfg.rectify``."""
        return self.rectify_map if self.cfg.rectify else None

    def _voxel_kw(self) -> dict:
        cfg = self.cfg
        return dict(num_bins=cfg.num_bins, height=cfg.sensor_height,
                    width=cfg.sensor_width,
                    representation=cfg.representation,
                    separate_pol=cfg.separate_pol, trilinear=cfg.trilinear,
                    normalize=cfg.normalize, rectify_map=self._rectify)

    def sample_augment(self, generator: Optional[torch.Generator],
                       batch_size: int, *, train: bool) -> AugmentParams:
        """Draw one flip bit (p = 0.5) and one crop offset per sample from
        ``generator`` when training with ``random_flip`` / ``random_crop``;
        no augmentation otherwise."""
        cfg = self.cfg
        if not train or generator is None:
            return AugmentParams()
        flip = crop_y = crop_x = None
        if cfg.random_flip:
            flip = torch.rand(batch_size, generator=generator) < 0.5
        if cfg.random_crop is not None:
            ch, cw = cfg.random_crop
            h, w = cfg.pre_aug_size
            if cfg.crop_anchor == "bottom":
                crop_y = torch.full((batch_size,), h - ch)
            else:
                crop_y = torch.randint(0, h - ch + 1, (batch_size,),
                                       generator=generator)
            crop_x = torch.randint(0, w - cw + 1, (batch_size,),
                                   generator=generator)
        return AugmentParams(flip=flip, crop_y=crop_y, crop_x=crop_x)

    def decode_packed(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """A packed batch ("ev_xq", "ev_yq", "ev_tq", "ev_pq": (..., N) and
        "ev_band_offsets" or "ev_tile_offsets") -> the f32 columns "ev_x",
        "ev_y" (u16 / COORD_SCALE), "ev_t" (u16 * (num_bins - 1) /
        TIME_SCALE: the time normalized to [0, num_bins - 1] already),
        "ev_p" (u8 as 0 / 1 on the tile wire, where the voxelizer reads 0
        as -1; i8 / POL_SCALE, the pre-weighted polarity, on the folded
        one) and "ev_valid" (the first ``offsets[..., -1]`` entries of a
        window), with "ev_t_prenormalized" set; every other key unchanged.
        Plain tensor ops on the batch's device, in f32 as the JAX package
        computes them."""
        folded = "ev_band_offsets" in batch
        key = "ev_band_offsets" if folded else "ev_tile_offsets"
        if key not in batch:
            raise ValueError("a packed batch needs ev_band_offsets or "
                             "ev_tile_offsets: its validity is the offsets'")
        f32 = lambda k: batch[k].to(torch.float32)
        out = {k: v for k, v in batch.items()
               if k not in ("ev_xq", "ev_yq", "ev_tq", "ev_pq")}
        out["ev_x"] = f32("ev_xq") * (1.0 / COORD_SCALE)
        out["ev_y"] = f32("ev_yq") * (1.0 / COORD_SCALE)
        out["ev_t"] = f32("ev_tq") * ((self.cfg.num_bins - 1) / TIME_SCALE)
        out["ev_p"] = (f32("ev_pq") * (1.0 / POL_SCALE) if folded
                       else f32("ev_pq"))
        count = batch[key][..., -1:]
        n = out["ev_x"].shape[-1]
        out["ev_valid"] = torch.arange(n, device=count.device) < count
        out["ev_t_prenormalized"] = True
        return out

    def _transform_grid(self, grids: torch.Tensor, aug: AugmentParams
                        ) -> torch.Tensor:
        """(B, C, Hs, Ws) sensor-size grids -> model-input grids: bottom
        crop, resize, per-sample crop, horizontal flip."""
        cfg = self.cfg
        if cfg.crop_bottom > 0:
            grids = grids[:, :, :cfg.sensor_height - cfg.crop_bottom]
        if cfg.resize_to is not None:
            grids = resize_bilinear(grids, *cfg.resize_to,
                                    align_corners=cfg.resize_align_corners)
        if aug.crop_y is not None:
            grids = crop_per_sample(grids, aug.crop_y, aug.crop_x,
                                    cfg.random_crop)
        if aug.flip is not None:
            grids = random_flip(grids, aug.flip, 0)
        return grids

    def make_window_fn(self, aug: AugmentParams, *,
                       t_prenormalized: bool = False,
                       offsets_kind: str = "tile"
                       ) -> Callable[..., torch.Tensor]:
        """fn(x, y, t, p, valid, tile_offsets=None), each (B, N) ->
        (B, C, H_out, W_out) f32: one window per sample on the voxelizer
        that ``offsets_kind`` names, then the spatial transforms.
        ``t_prenormalized``: ``t`` is normalized to [0, num_bins - 1]
        already (a decoded packed window). With ``cfg.rectify`` the raw
        events are rectified first."""
        kw = self._voxel_kw()

        def fn(x, y, t, p, valid, tile_offsets=None):
            grids = voxelize_window_soa(
                x, y, t, p, valid, offsets_kind=offsets_kind,
                tile_offsets=tile_offsets, t_prenormalized=t_prenormalized,
                oh_dtype=self.cfg.voxel_oh_dtype, **kw)
            return self._transform_grid(grids, aug)

        return fn

    # -------------------- space-to-depth, stack and raw builds ----------

    def s2d_capable(self, *, train: bool) -> bool:
        """Whether the batched build can emit space-to-depth windows: the
        voxel grid, transforms expressible in block space (an even bottom
        crop, the flip, no per-sample crop when training), an even sensor
        and a width-only resize to an even width (JAX's conditions; the
        port's voxelizers are always its kernels). Callers check the
        batch's offsets too: a resize needs band offsets."""
        cfg = self.cfg
        resize_ok = cfg.resize_to is None or (
            cfg.resize_to[0] == cfg.post_crop_size[0]
            and cfg.resize_to[1] % 2 == 0)
        return (cfg.representation == "voxel_grid" and resize_ok
                and (cfg.random_crop is None or not train)
                and cfg.crop_bottom % 2 == 0
                and cfg.sensor_height % 2 == 0
                and cfg.sensor_width % 2 == 0
                and not (cfg.rectify and self.rectify_map is not None))

    def s4d_capable(self, *, train: bool) -> bool:
        """:meth:`s2d_capable` for the quad-block (4x4) window layout: the
        bottom crop, the sensor and a resize's width divisible by 4
        (JAX's)."""
        cfg = self.cfg
        return (self.s2d_capable(train=train)
                and cfg.crop_bottom % 4 == 0
                and cfg.sensor_height % 4 == 0
                and cfg.sensor_width % 4 == 0
                and (cfg.resize_to is None or cfg.resize_to[1] % 4 == 0))

    def stack_capable(self, *, train: bool, batch: dict) -> bool:
        """Whether :meth:`build_all_stack` serves ``batch``: the pin on,
        :meth:`s2d_capable`, x-slot band offsets (more groups than bands),
        an even tile height and no resize."""
        cfg = self.cfg
        offs = batch.get("ev_band_offsets")
        if not (cfg.stack_windows and self.s2d_capable(train=train)
                and offs is not None and cfg.resize_to is None):
            return False
        th = tile_h_for_bins(effective_bins(cfg.num_bins, cfg.separate_pol,
                                            cfg.trilinear))
        hp = -(-cfg.sensor_height // th) * th
        return th % 2 == 0 and offs.shape[-1] - 1 > hp // th

    def raw_capable(self, *, train: bool, batch: dict) -> bool:
        """Whether :meth:`build_all_raw` serves ``batch``: the pin on,
        :meth:`s2d_capable` and band offsets (either band wire)."""
        return bool(self.cfg.raw_windows and self.s2d_capable(train=train)
                    and ("ev_band_offsets" in batch
                         or "band_offsets" in batch))

    def _transform_s2d(self, grids: torch.Tensor, aug: AugmentParams,
                       block: int = 2) -> torch.Tensor:
        """(N, b*b*C, H/b, W/b) block windows (``block`` b: 2, or 4 for
        s4d): the bottom crop in block rows and the flip, which reverses
        the block columns and the column phases of the (py * b + px) * C +
        c channels."""
        cfg = self.cfg
        if cfg.crop_bottom > 0:
            grids = grids[:, :, :(cfg.sensor_height - cfg.crop_bottom)
                          // block]
        if aug.flip is not None:
            nsub = block * block
            c = grids.shape[1] // nsub
            perm = torch.arange(nsub * c).view(block, block, c).flip(
                1).reshape(-1)
            flipped = grids[:, perm.to(grids.device)].flip(-1)
            sel = aug.flip.to(device=grids.device, dtype=torch.bool)
            grids = torch.where(sel.view(-1, 1, 1, 1), flipped, grids)
        return grids

    def _flat(self, batch, time_major: bool):
        """(flatten (B, T, ...) -> (B*T, ...), repeat a per-sample draw per
        window, leading shape): window-major with ``time_major``, else
        sample-major."""
        b, t_dim = batch["ev_x"].shape[:2]
        if time_major:
            return ((lambda a: a.transpose(0, 1).reshape(t_dim * b,
                                                         a.shape[-1])),
                    lambda a: a.repeat(t_dim), (t_dim, b))
        return ((lambda a: a.reshape(b * t_dim, a.shape[-1])),
                lambda a: a.repeat_interleave(t_dim), (b, t_dim))

    def _folded_build(self, batch, layout: str, **kw):
        """A band batch (decoded) through the voxelizer in ``layout``
        ('stack' or 'raw'), window-major: (out (T, B, ...), stats (T, B, 3),
        batch)."""
        if "ev_xq" in batch:
            batch = self.decode_packed(batch)
        if "ev_band_offsets" not in batch:
            raise ValueError(f"the {layout} build needs band offsets")
        flat, _, lead = self._flat(batch, True)
        cfg = self.cfg
        out, stats = voxelize_window_soa(
            flat(batch["ev_x"]), flat(batch["ev_y"]), flat(batch["ev_t"]),
            flat(batch["ev_p"]), flat(batch["ev_valid"]),
            tile_offsets=flat(batch["ev_band_offsets"]), offsets_kind="band",
            t_prenormalized=bool(batch.get("ev_t_prenormalized", False)),
            oh_dtype=cfg.voxel_oh_dtype, layout=layout, **self._voxel_kw(),
            **kw)
        return (out.view(*lead, *out.shape[1:]), stats.view(*lead, 3),
                batch)

    def build_all_stack(self, batch: Dict[str, torch.Tensor], *,
                        aug: AugmentParams = AugmentParams(),
                        out_dtype: torch.dtype = torch.float32):
        """A band batch -> ({"raw": the s2d NCHW window stack (T, B, 4C,
        H/2, W/2) f32, "stats": (T, B, 3) or None}, label, window_map), JAX's
        ``build_all_stack``: B1 emits the stack directly, and
        ``window_map(stack_t, stats_t)`` gives window t as (B, 4C, H'/2,
        W/2) in ``out_dtype``: normalized in f32 from the kernel's stats,
        flipped in block space, cropped, cast last (channels-last memory,
        as ``space_to_depth`` leaves a window). Its windows are the
        standard build's, bit for bit, in blocks."""
        cfg = self.cfg
        stack, stats, batch = self._folded_build(batch, "stack")

        def window_map(r: torch.Tensor, s: Optional[torch.Tensor]
                       ) -> torch.Tensor:
            if s is not None:
                r = normalize_from_stats(r, s)
            r = self._transform_s2d(r, AugmentParams(flip=aug.flip))
            return _blocks_out(r.permute(0, 2, 3, 1), out_dtype)

        label = batch.get("label")
        if label is not None:
            label = self.apply_label_transform(label, aug)
        return ({"raw": stack, "stats": stats if cfg.normalize else None},
                label, window_map)

    def build_all_raw(self, batch: Dict[str, torch.Tensor], *,
                      aug: AugmentParams = AugmentParams(),
                      out_dtype: torch.dtype = torch.float32):
        """A band batch -> ({"raw": the voxelizer's raw band accumulator
        (T, B, n_bands, C * tile_h, W') f32, "stats": (T, B, 3) or None},
        label, window_map), JAX's ``build_all_raw``. ``window_map(raw_t,
        stats_t)`` gives window t as (B, 4C, H'/2, W'/2) in ``out_dtype``:
        normalized in f32, cut to the sensor width, flipped (a reversal of
        x), the fine space-to-depth transform, cropped, cast last. With a
        width resize (DDD17) the build normalizes and resizes before the
        map, as JAX does (the normalization does not commute with it), and
        ``stats`` is None."""
        cfg = self.cfg
        resize = (cfg.resize_to[1] if cfg.resize_to is not None
                  and cfg.resize_to[1] != cfg.sensor_width else None)
        raw, stats, batch = self._folded_build(
            batch, "raw", resize_width_to=resize,
            resize_align_corners=cfg.resize_align_corners)
        c = effective_bins(cfg.num_bins, cfg.separate_pol, cfg.trilinear)
        th = tile_h_for_bins(c)
        out_h = cfg.sensor_height - cfg.crop_bottom
        out_w = resize or cfg.sensor_width

        def window_map(r: torch.Tensor, s: Optional[torch.Tensor]
                       ) -> torch.Tensor:
            if s is not None:
                r = normalize_from_stats(r, s)
            r = r[..., :out_w]
            if aug.flip is not None:
                r = random_flip(r, aug.flip, 0)
            b, n_bands = r.shape[:2]
            g = r.reshape(b, n_bands, c, th // 2, 2, out_w // 2, 2).permute(
                0, 1, 3, 5, 4, 6, 2).reshape(b, n_bands * th // 2,
                                             out_w // 2, 4 * c)
            return _blocks_out(g[:, :out_h // 2], out_dtype)

        label = batch.get("label")
        if label is not None:
            label = self.apply_label_transform(label, aug)
        defer = cfg.normalize and resize is None
        return ({"raw": raw, "stats": stats if defer else None}, label,
                window_map)

    def apply_label_transform(self, label: torch.Tensor, aug: AugmentParams
                              ) -> torch.Tensor:
        """The same spatial augmentation on (B, H, W) integer labels, which
        are stored at the pre-augmentation size (after the crop and the
        resize, as the reference's loaders store them)."""
        cfg = self.cfg
        if aug.crop_y is not None and \
                tuple(label.shape[1:]) == tuple(cfg.pre_aug_size):
            label = crop_per_sample(label, aug.crop_y, aug.crop_x,
                                    cfg.random_crop)
        if aug.flip is not None:
            label = random_flip(label, aug.flip, 0)
        return label

    def build_all(self, batch: Dict[str, torch.Tensor], *,
                  aug: AugmentParams = AugmentParams(),
                  out_dtype: torch.dtype = torch.float32,
                  layout: str = "nchw", time_major: bool = True,
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Batch {"ev_x", "ev_y", "ev_t", "ev_p", "ev_valid": (B, T, N),
        "label": (B, H, W)} with "ev_band_offsets" (folded records),
        "ev_tile_offsets" (tile-sorted events), each (B, T, G + 1), or no
        offsets (raw events) -> (windows (T, B, C, H', W') in ``out_dtype``,
        label), with ``aug`` applied to each sample's windows and label
        alike. Key presence picks the voxelizer; a packed batch
        ("ev_xq", ...) is decoded first (:meth:`decode_packed`).

        Windows come out time-major, so the recurrent rollout reads window
        ``t`` as one contiguous block; ``time_major=False`` gives (B, T,
        ...). ``layout='s2d'`` (needs :meth:`s2d_capable`; a resize needs
        band offsets) gives space-to-depth block windows (T, B, 4C, H'/2,
        W'/2) in channels-last memory: the voxelizer's s2d grids (a width
        resize folded in), cropped and flipped in block space
        (:meth:`_transform_s2d`). ``layout='s4d'`` (needs
        :meth:`s4d_capable`) gives the quad-block rollout's 4x4 block
        windows (T, B, 16C, H'/4, W'/4) the same way: the voxelizer's grid
        relaid into 4x4 blocks after the kernel, as the JAX package makes
        its s4d layout outside its Pallas bodies.
        """
        if "ev_xq" in batch:
            batch = self.decode_packed(batch)
        kind = "band" if "ev_band_offsets" in batch else "tile"
        offs = batch.get(f"ev_{kind}_offsets")
        flat, rep, lead = self._flat(batch, time_major)
        aug_w = AugmentParams(*(None if a is None else rep(a)
                                for a in (aug.flip, aug.crop_y, aug.crop_x)))
        pre = bool(batch.get("ev_t_prenormalized", False))
        cols = (flat(batch["ev_x"]), flat(batch["ev_y"]), flat(batch["ev_t"]),
                flat(batch["ev_p"]), flat(batch["ev_valid"]))
        if layout in ("s2d", "s4d"):
            cfg = self.cfg
            capable = (self.s4d_capable if layout == "s4d"
                       else self.s2d_capable)
            if not capable(train=aug.crop_y is not None):
                raise ValueError(f"the {layout} build is not possible with "
                                 f"this pipeline ({layout}_capable)")
            resize = None if cfg.resize_to is None else cfg.resize_to[1]
            if resize is not None and kind != "band":
                raise ValueError(f"an {layout} build with a resize needs "
                                 "pre-folded band offsets")
            extra = (dict(resize_width_to=resize,
                          resize_align_corners=cfg.resize_align_corners)
                     if kind == "band" else {})
            grids = voxelize_window_soa(
                *cols, offsets_kind=kind, t_prenormalized=pre,
                tile_offsets=None if offs is None else flat(offs),
                oh_dtype=cfg.voxel_oh_dtype, layout=layout,
                **self._voxel_kw(), **extra)
            grids = self._transform_s2d(grids.permute(0, 3, 1, 2), aug_w,
                                        4 if layout == "s4d" else 2)
            grids = _blocks_out(grids.permute(0, 2, 3, 1), out_dtype)
            windows = grids.view(*lead, *grids.shape[1:])
            label = batch.get("label")
            if label is not None:
                label = self.apply_label_transform(label, aug)
            return windows, label
        if layout != "nchw":
            raise ValueError(f"build_all: layout {layout!r} not in "
                             "('nchw', 's2d', 's4d')")
        window_fn = self.make_window_fn(aug_w, t_prenormalized=pre,
                                        offsets_kind=kind)
        grids = window_fn(*cols,
                          tile_offsets=None if offs is None else flat(offs))
        grids = grids.to(out_dtype).contiguous()
        windows = grids.view(*lead, *grids.shape[1:])
        label = batch.get("label")
        if label is not None:
            label = self.apply_label_transform(label, aug)
        return windows, label

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, *,
                 train: bool = False,
                 aug: Optional[AugmentParams] = None
                 ) -> Dict[str, torch.Tensor]:
        """The dense form of a raw batch, JAX's ``EventPipeline.__call__``:
        {"raw_events": (B, T, N, 4), "valid": (B, T, N), "label"?, ...} ->
        the same dict with "events" (B, T, H', W', C) in place of
        "raw_events" and "valid" (``ops/batch_voxel.voxelize_windows``'s
        channel-last view) and the label transformed. All B*T windows are
        voxelized in one launch (rectified first with ``cfg.rectify``),
        then cropped, resized and augmented over the flattened window axis.
        ``aug`` defaults to :meth:`sample_augment`'s draws from
        ``generator``."""
        events = batch["raw_events"]
        b, t_dim = events.shape[:2]
        if aug is None:
            aug = self.sample_augment(generator, b, train=train)
        grids = flat_windows(events, batch["valid"], **self._voxel_kw())
        grids = self._transform_grid(grids, AugmentParams(
            *(None if a is None else a.repeat_interleave(t_dim)
              for a in (aug.flip, aug.crop_y, aug.crop_x))))
        out = {k: v for k, v in batch.items()
               if k not in ("raw_events", "valid")}
        out["events"] = grids.view(b, t_dim, *grids.shape[1:]).permute(
            0, 1, 3, 4, 2)
        if "label" in batch:
            out["label"] = self.apply_label_transform(batch["label"], aug)
        return out


def _blocks_out(nhwc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W, C) block windows -> (N, C, H, W) in ``dtype``, cast last,
    in channels-last memory (the strides ``space_to_depth`` gives a
    window, so the rollout's convs see the same tensor layout)."""
    return nhwc.to(dtype).contiguous().permute(0, 3, 1, 2)
