"""Device time of the rollout's two block convs on the fused conv kernels.

The head conv (20 -> 128 channels) and the first encoder's conv (128 -> 64)
of a 440x640 window run as 3x3 convs over 220x320 space-to-depth blocks
(``models.layers.BlockConv``). This tool times both through
``ops.conv3x3.conv3x3_fused`` at the main path's B=8, exact (B4,
``impl='pallas'``) and int8 (B4-int8, ``impl='pallas_int8'``, its prep
launches included), so that two trees can be compared in one call:

    python ess_tpu_torch/tools/bench_block_conv.py [--root DIR] [--calls N]

``--root`` imports ``ess_tpu_torch`` from another checkout (an earlier tree
unpacked with ``git archive``; default: the checkout that holds this file).
Inputs are seeded: post-ReLU activations, fan-in-scaled weights, a bias;
the prepared weights are built once, as ``BlockConv`` caches them. Device
ms per call: CUDA events over ``--calls`` calls after a warm-up, the best
of three such runs, each behind a spin kernel that holds the stream while
the host enqueues the calls, so that the host's cost per call does not
enter the reading. One JSON line per conv and impl, with the card's name
and power limit.
"""

import argparse
import json
import os
import sys

B, H, W = 8, 220, 320
CONVS = (("head", 20, 128), ("encoder 0", 128, 64))
SPIN_CYCLES = 50_000_000   # ~25 ms of a spin kernel at the H100's clocks


def main(argv=None) -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_block_conv: no CUDA device")
    from ess_tpu_torch import bench
    from ess_tpu_torch.ops import conv3x3

    dev = torch.device("cuda", 0)
    card = bench.card()
    g = torch.Generator().manual_seed(0)
    for name, cin, cout in CONVS:
        x = (torch.relu(torch.randn(B, cin, H, W, generator=g)) * 2).to(
            dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = (torch.randn(cout, cin, 3, 3, generator=g)
             * (9 * cin) ** -0.5).to(dev)
        bias = (torch.randn(cout, generator=g) * 0.1).to(dev)
        for impl in ("pallas", "pallas_int8"):
            prep = conv3x3.prepare_conv_weights(
                w, int8=impl == "pallas_int8")

            def run(n):
                for _ in range(n):
                    conv3x3.conv3x3_fused(x, w, bias, relu=True, impl=impl,
                                          prepared=prep)

            run(3)
            best = float("inf")
            for _ in range(3):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                torch.cuda._sleep(SPIN_CYCLES)
                e0.record()
                run(args.calls)
                e1.record()
                torch.cuda.synchronize()
                best = min(best, e0.elapsed_time(e1) / args.calls)
            print(json.dumps({"root": root, "conv": name, "impl": impl,
                              "shape": [B, cin, H, W, cout],
                              "device_ms_per_call": round(best, 4),
                              "device": card}), flush=True)


if __name__ == "__main__":
    main()
