"""PyTorch + CUDA port of ess-tpu (event-based semantic segmentation).

The JAX package ``ess_tpu`` is the reference; this package mirrors its
module paths and never imports JAX. Hand-written CUDA kernels for Hopper
live in ``csrc/`` and are built by :mod:`ess_tpu_torch.kernels` on first
use.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``device`` as given, else the
    first CUDA device. The port runs on the GPU unless the caller asks for
    the CPU, so with no ``device`` and no CUDA device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to build on the CPU")
    return torch.device("cuda", 0)
