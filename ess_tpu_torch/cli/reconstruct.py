"""Standalone E2VID reconstruction program (PyTorch).

Counterpart of ``ess_tpu/cli/reconstruct.py``, with its flags, defaults,
file names and printed lines: read an event file (``t x y p`` text or zip
with a ``width height`` header), window it by fixed count (``-N``) or fixed
duration (``-T``, ms), voxelize each window (the halo-tiled voxelizer with
the events sorted into tiles on the device), roll it through the recurrent
reconstruction network with carried state and write one 8-bit PNG frame a
window, ``frame_{i:010d}.png``. ``--color`` reads a DAVIS346color Bayer
stream: the four 2x2 phases of the normalized grid run through the same
network as one batch of 4, each with its own state, and are merged with the
gray frame into a BGR frame.

The network is f32 with the plain ConvLSTM cell and the library block
convs, as the JAX program builds it, and TF32 is off. Frames are cropped
back from the padded output centered (``ops/pad.py::crop_output``), where
the JAX program takes the top-left slice (ROADMAP.md, Queue C). ``-c``
loads an upstream ``.pth.tar``; without it the weights are torch's default
initialization drawn from a generator seeded 0 (not the JAX program's flax
initialization, whose values differ). ``--display`` raises: the port has no
window.

``python -m ess_tpu_torch.cli.reconstruct -c e2vid.pth.tar -i events.txt -o out/``

Runs on the first CUDA device; ``main(argv, device="cpu")`` runs on the
CPU with the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
import torch.nn as nn


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="events -> video reconstruction")
    parser.add_argument("-c", "--checkpoint", default="",
                        help="E2VID torch .pth.tar, or empty for seeded "
                             "random weights")
    parser.add_argument("-i", "--input_file", required=True)
    parser.add_argument("-o", "--output_folder", default="reconstruction")
    parser.add_argument("-N", "--window_size", type=int, default=None,
                        help="fixed event count per window")
    parser.add_argument("-T", "--window_duration", type=float, default=None,
                        help="fixed window duration in ms")
    parser.add_argument("--num_bins", type=int, default=5)
    parser.add_argument("--no-normalize", dest="normalize",
                        action="store_false")
    parser.add_argument("--color", action="store_true",
                        help="DAVIS346color Bayer stream -> color frames")
    parser.add_argument("--display", action="store_true",
                        help="show the reconstruction in a window (not "
                             "ported: raises)")
    parser.add_argument("--show_events", action="store_true",
                        help="hstack an event preview left of the frame")
    parser.add_argument("--event_display_mode", default="red-blue",
                        choices=("red-blue", "grayscale"))
    parser.add_argument("--num_bins_to_show", type=int, default=-1)
    parser.add_argument("--display_border_crop", type=int, default=0)
    parser.add_argument("--display_wait_time", type=int, default=1)
    return parser.parse_args(argv)


def seeded_init(model: nn.Module, seed: int = 0) -> None:
    """Draw every conv's parameters as ``nn.Conv2d.reset_parameters`` does
    (Kaiming-uniform weights, uniform biases within 1/sqrt(fan_in)), from a
    CPU generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5),
                                         generator=g)
                if mod.bias is not None:
                    bound = 1.0 / math.sqrt(mod.weight[0].numel())
                    nn.init.uniform_(mod.bias, -bound, bound, generator=g)


def build_model(checkpoint: str, device):
    """The f32 ``RecurrentUNet`` on the plain ConvLSTM cell and library
    block convs: the geometry and weights of ``checkpoint`` (an upstream
    ``.pth.tar``), or the default geometry with :func:`seeded_init`."""
    from ess_tpu_torch.io.convert import load_e2vid_checkpoint
    from ess_tpu_torch.models.e2vid import RecurrentUNet

    kw = dict(lstm_impl="xla", block_conv_impl="xla", dtype=torch.float32,
              device="cpu")
    if checkpoint:
        sd, config = load_e2vid_checkpoint(checkpoint)
        model = RecurrentUNet(
            in_channels=sd["head.conv2d.weight"].shape[1],
            base_channels=int(config.get("base_num_channels", 32)),
            num_encoders=int(config.get("num_encoders", 3)),
            num_residual_blocks=int(config.get("num_residual_blocks", 2)),
            skip_type=str(config.get("skip_type", "sum")), **kw)
        model.load_state_dict(sd)
    else:
        model = RecurrentUNet(**kw)
        seeded_init(model)
    return model.to(device).requires_grad_(False)


def window_tensors(window: np.ndarray, device):
    """A reader's (N, 4) float64 [t, x, y, p] window -> (x, y, t - t[0], p,
    valid), each (1, N) f32 (valid bool) on ``device``: the time shift in
    float64 on the host, one host-to-device copy."""
    cols = np.stack([window[:, 1], window[:, 2], window[:, 0] - window[0, 0],
                     window[:, 3]]).astype(np.float32)
    x, y, t, p = torch.from_numpy(cols).to(device)[:, None]
    return x, y, t, p, torch.ones_like(x, dtype=torch.bool)


def to_frame8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> uint8 (clip, times 255, truncate)."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def main(argv=None, *, device=None) -> None:
    """Reconstruct as the flags say; ``device`` (not a command-line flag)
    runs on another device than the first CUDA one, e.g. ``"cpu"``."""
    args = parse_args(argv)

    from ess_tpu_torch import resolve_device
    from ess_tpu_torch.data.png import imwrite
    from ess_tpu_torch.data.readers import (
        FixedDurationEventReader, FixedSizeEventReader, read_header)
    from ess_tpu_torch.ops.batch_voxel import voxelize_window_soa
    from ess_tpu_torch.ops.pad import crop_output
    from ess_tpu_torch.ops.voxel import normalize_nonzero
    from ess_tpu_torch.recon.display import ImageDisplay
    from ess_tpu_torch.recon.reconstructor import Reconstructor

    # built for its checks only: --display raises, the port has no cv2
    # window to show a frame in; without it the preview flags show nothing,
    # as in JAX
    ImageDisplay(display=args.display, show_events=args.show_events,
                 event_display_mode=args.event_display_mode,
                 num_bins_to_show=args.num_bins_to_show,
                 border=args.display_border_crop)
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    width, height = read_header(args.input_file)
    print(f"sensor size: {width} x {height}")
    if args.color and (height % 2 or width % 2):
        raise ValueError(f"--color needs even sensor sides, got "
                         f"{width} x {height}")

    model = build_model(args.checkpoint, dev)
    recon = Reconstructor(model=model, height=height, width=width,
                          normalize=False)
    state = recon.init_state(1, dev)
    if args.window_duration is not None:
        reader = FixedDurationEventReader(args.input_file,
                                          args.window_duration)
    else:
        reader = FixedSizeEventReader(args.input_file,
                                      args.window_size or 10000)
    if args.color:
        from ess_tpu_torch.recon.color import (
            BAYER_PHASES, bayer_split, merge_channels_into_color_image)
        recon_half = Reconstructor(model=model, height=height // 2,
                                   width=width // 2, normalize=False)
        color_state = recon_half.init_state(4, dev)

    os.makedirs(args.output_folder, exist_ok=True)
    with torch.no_grad():
        for i, window in enumerate(reader):
            grid = voxelize_window_soa(
                *window_tensors(window, dev), num_bins=args.num_bins,
                height=height, width=width, normalize=False)
            if args.normalize:
                grid = normalize_nonzero(grid)
            img, state, _ = recon.step(grid, state)
            frame8 = to_frame8(crop_output(img, recon.geometry)[0, 0])
            frame8 = frame8.cpu().numpy()
            out_path = os.path.join(args.output_folder, f"frame_{i:010d}.png")
            if args.color:
                # the phases are sliced from the normalized full grid
                phases = torch.stack(list(bayer_split(grid[0]).values()))
                imgs, color_state, _ = recon_half.step(phases, color_state)
                imgs8 = to_frame8(crop_output(imgs, recon_half.geometry)[:, 0])
                channels = dict(zip(BAYER_PHASES, imgs8.cpu().numpy()))
                channels["grayscale"] = frame8
                imwrite(out_path, merge_channels_into_color_image(channels))
            else:
                imwrite(out_path, frame8)
            print(f"window {i}: {len(window)} events -> {out_path}")


if __name__ == "__main__":
    main()
