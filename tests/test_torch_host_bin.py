"""Host ghost-folded band binning: the port against the JAX package.

``ess_tpu_torch.ops.voxel_folded.host_band_bin_folded`` (native) and its
numpy reference must reproduce ``ess_tpu.ops.voxel_pallas.
host_band_bin_folded(..., x_slots=True)`` byte for byte: the native paths
run the same C++ (each package builds its own copy), and the numpy paths the
same float64 folds and stable sort. Inputs cover frame-edge, band-boundary
and slot-boundary events and a capacity overflow.

The JAX package builds its library in place, next to the source, with no
private name and no rename, so two test processes can race on it. The
port's tests that call the JAX side load their own copy instead
(:func:`use_private_jax_native`).
"""

import fcntl
import hashlib
import os
import subprocess
import tempfile

import numpy as np
import pytest

import ess_tpu.data.native as jax_native
from ess_tpu.ops.voxel_pallas import host_band_bin_folded as jax_bin

from ess_tpu_torch.ops.voxel_folded import (
    host_band_bin_folded, host_band_bin_folded_ref)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_SRC = os.path.join(_REPO, "native", "ess_host.cpp")
_PRIVATE_DIR = os.path.join(_REPO, "build", "ess_tpu_torch")


def private_jax_native_lib() -> str:
    """The JAX package's native library built from ``native/ess_host.cpp``
    to a private path under ``build/ess_tpu_torch/`` (keyed by a hash of
    the source): one builder at a time under an ``fcntl`` lock, ``g++`` to
    a temporary name, then ``os.replace``, so no process ever loads a
    half-written file."""
    with open(_JAX_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_PRIVATE_DIR, f"libess_host_jax_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_PRIVATE_DIR, exist_ok=True)
    with open(os.path.join(_PRIVATE_DIR, "libess_host_jax.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(path):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_PRIVATE_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                                _JAX_SRC], check=True, capture_output=True)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return path


def use_private_jax_native():
    """A generator for a module-scoped autouse fixture: for the module's
    tests ``ess_tpu.data.native`` points at :func:`private_jax_native_lib`
    (its ``_build`` then finds an up-to-date file and only loads it), so
    ``native/libess_host.so`` is neither read nor written; the module's
    state is restored afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", private_jax_native_lib())
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        yield


_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)


def raw_events(rng, t_dim, n, h, w, *, edges=True):
    """(T, N, 4) raw windows with uniform events, and, with ``edges``,
    a third of them placed in the frame-edge zones, just below band
    boundaries (24-row multiples) and just below x-slot boundaries."""
    raw = np.zeros((t_dim, n, 4), np.float32)
    raw[..., 0] = rng.uniform(0, w - 1, (t_dim, n))
    raw[..., 1] = rng.uniform(0, h - 1, (t_dim, n))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (t_dim, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (t_dim, n))
    if edges:
        k = n // 12
        frac = rng.uniform(0.05, 0.95, (t_dim, k))
        raw[:, 0:k, 0] = -frac                                  # left edge
        raw[:, k:2 * k, 0] = w - 1 + frac                       # right edge
        raw[:, 2 * k:3 * k, 1] = -frac                          # top edge
        raw[:, 3 * k:4 * k, 1] = h - 1 + frac                   # bottom edge
        band = rng.integers(1, max(h // 24, 1) + 1, (t_dim, k))
        raw[:, 4 * k:5 * k, 1] = np.minimum(band * 24 - 1 + frac, h - 1)
        slot = rng.integers(1, max(w // 128, 1) + 1, (t_dim, k))
        raw[:, 5 * k:6 * k, 0] = np.minimum(slot * 128 - 1 + frac, w - 1)
    valid = np.ones((t_dim, n), bool)
    valid[:, n - n // 10:] = False
    return raw, valid


def pathological(rng, t_dim, n, h, w):
    """Every event straddles a band and an x-slot boundary: the ghosts
    overflow the default capacity margin."""
    raw = np.zeros((t_dim, n, 4), np.float32)
    raw[..., 0] = 127.0 + rng.uniform(0.05, 0.95, (t_dim, n))
    band = rng.integers(0, h // 24 - 1, (t_dim, n))
    raw[..., 1] = (band + 1) * 24 - 1 + rng.uniform(0.05, 0.95, (t_dim, n))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (t_dim, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (t_dim, n))
    return raw, np.ones((t_dim, n), bool)


CASES = {
    "48x256": lambda rng: (raw_events(rng, 3, 900, 48, 256), 48, 256),
    "26x170": lambda rng: (raw_events(rng, 2, 700, 26, 170), 26, 170),
    "overflow": lambda rng: (pathological(rng, 2, 600, 72, 256), 72, 256),
}


def assert_bytes_equal(got, want):
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert g.tobytes() == w_.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_jax(case):
    (raw, valid), h, w = CASES[case](np.random.default_rng(3))
    want = jax_bin(raw, valid, height=h, width=w, bins=5, x_slots=True)
    got = host_band_bin_folded(raw, valid, height=h, width=w, bins=5)
    assert_bytes_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_reference_matches_jax_numpy(case, monkeypatch):
    (raw, valid), h, w = CASES[case](np.random.default_rng(4))
    # the JAX entry point takes its numpy body when its native lib is absent
    monkeypatch.setattr(jax_native, "band_bin_folded", lambda *a, **k: None)
    want = jax_bin(raw, valid, height=h, width=w, bins=5, x_slots=True)
    got = host_band_bin_folded_ref(raw, valid, height=h, width=w, bins=5)
    assert_bytes_equal(got, want)
    if case == "overflow":
        assert got[0].shape[1] > raw.shape[1] + raw.shape[1] // 8
