"""Build and load the hand-written CUDA kernels of ``ess_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared library
with a plain C interface, ``build/ess_tpu_torch/libkernels_<hash>.so`` at
the repository root, on first use; the hash covers the sources, the headers
and the flags, so an edited source rebuilds. The library is loaded with
``ctypes``: pointers and the CUDA stream travel as ``c_void_p``, and every
entry point returns its ``cudaError_t``, which :func:`check` turns into an
exception. ``build_log`` keeps what ``ptxas -v`` said about each kernel
(registers, shared memory, spills). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ess_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log = ""                          # ptxas report of that build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return nvcc


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _compile(srcs: list[str], lib_path: str) -> str:
    """Compile every source in its own ``nvcc`` process, all at once, then
    link; returns the compilers' reports. Raises if any step fails."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", s, "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        reports, failed = [], []
        for s, p in zip(srcs, procs):
            out, err = p.communicate()
            reports.append(f"{os.path.basename(s)}:\n{out}{err}")
            if p.returncode != 0:
                failed.append(reports[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
        os.replace(so, lib_path)
    return "\n".join(reports)


def _build() -> ctypes.CDLL:
    global build_seconds, build_log
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"libkernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        build_log = _compile(srcs, lib_path)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    voxel_argtypes(lib)
    # the cells: shape (B, H, W, CX, CH), then the plan (th, tw, grid, smem)
    lib.ess_conv_lstm.argtypes = [vp] * 6 + [ci] * 9 + [vp]
    lib.ess_conv_lstm.restype = ci
    lib.ess_conv_lstm_int8_prep.argtypes = [vp] * 4 + [ci] + [vp] * 5 + [
        ci] * 5 + [vp]
    lib.ess_conv_lstm_int8_prep.restype = ci
    lib.ess_conv_lstm_int8.argtypes = [vp] * 7 + [ci] * 9 + [vp]
    lib.ess_conv_lstm_int8.restype = ci
    lib.ess_conv_lstm_mode.argtypes = [vp] * 6 + [ci] * 10 + [vp]
    lib.ess_conv_lstm_mode.restype = ci
    lib.ess_conv_lstm_int8_mode.argtypes = [vp] * 7 + [ci] * 10 + [vp]
    lib.ess_conv_lstm_int8_mode.restype = ci
    lib.ess_level_int8.argtypes = [vp] * 10 + [ci] * 18 + [vp]
    lib.ess_level_int8.restype = ci
    lib.ess_conv3x3.argtypes = [vp] * 4 + [ci] * 11 + [vp]
    lib.ess_conv3x3.restype = ci
    lib.ess_conv3x3_int8_prep.argtypes = [vp] * 3 + [ci] + [vp] * 3 + [
        ci] * 5 + [vp]
    lib.ess_int8_absmax.argtypes = [vp, ctypes.c_longlong, vp, vp]
    lib.ess_int8_absmax.restype = ci
    lib.ess_conv3x3_int8_prep.restype = ci
    lib.ess_conv3x3_int8.argtypes = [vp] * 6 + [ci] * 12 + [vp]
    lib.ess_conv3x3_int8.restype = ci
    cf = ctypes.c_float
    lib.ess_head_cmajor.argtypes = [vp] * 4 + [ci] * 5 + [cf] * 2 + [ci] * 6 + [
        vp]
    lib.ess_head_cmajor.restype = ci
    lib.ess_error_string.argtypes = [ci]
    lib.ess_error_string.restype = ctypes.c_char_p
    return lib


def voxel_argtypes(lib: ctypes.CDLL) -> None:
    """The voxelizers' C signatures: pointers, the shape, the scatter plan
    (threads, grid, smem), then the form (B1 and B3-legacy: layout and q8,
    B3: q8) and the stream."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ess_voxel_folded.argtypes = [vp] * 7 + [ci] * 12 + [vp]
    lib.ess_voxel_folded_band.argtypes = [vp] * 7 + [ci] * 11 + [vp]
    lib.ess_voxel_tiled.argtypes = [vp] * 6 + [ci] * 10 + [vp]
    lib.ess_voxel_tiled_stats.argtypes = [vp] * 7 + [ci] * 10 + [vp]
    for fn in (lib.ess_voxel_folded, lib.ess_voxel_folded_band,
               lib.ess_voxel_tiled, lib.ess_voxel_tiled_stats):
        fn.restype = ci


def get_lib() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (refused launch, bad
    configuration): such a launch never ran, and a later synchronize would
    not report it."""
    if err != 0:
        msg = get_lib().ess_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
