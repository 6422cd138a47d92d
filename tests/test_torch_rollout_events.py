"""The in-loop rollout: each window voxelized just before its step
(``Reconstructor.rollout_events`` and the steps' ``precompute=False``),
against the JAX package and against the port's precomputed form.

``tiny_config`` (base 8, 6 classes, f32) at a 48x256 sensor (2 bands x 2
x-slots), B=2, T=3, with the weights carried over by ``params_from_jax``.
The JAX side runs its Pallas voxelizers and cells in interpret mode with
f32 tent planes; the port runs its plain versions on CPU tensors.

- ``rollout_events`` of the validation rollout against JAX's
  ``Reconstructor.rollout_events`` on five wires: host-folded records
  (``ev_band_offsets``), host tile-sorted events (``ev_tile_offsets``),
  raw events sorted on the device (no offsets), and the packed folded and
  packed tile wires, decoded first as the steps decode them. Raw and tile
  coordinates lie on the 1/64-pixel lattice
  (``tests/test_torch_streaming.py``). Bounds: the final image, latent and
  recurrent state atol 1e-4 (the eval step's bounds,
  ``tests/test_torch_eval_step.py``).
- The steps with ``precompute=False``: in
  tests/test_torch_rollout_events_steps.py.
"""

import jax
import numpy as np
import pytest
import torch

from ess_tpu.data.pipeline import AugmentParams as JaxAugment
from ess_tpu.ops.voxel_pallas import host_tile_bin
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.data.pipeline import AugmentParams
from ess_tpu_torch.io.convert import params_from_jax
from tests.test_torch_eval_step import folded_batch
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread
from tests.test_torch_packed_steps import (
    jax_batch, packed_batch, port_modules, port_pipeline, torch_batch)
from tests.test_torch_train_step import (B, CLASSES, H, T, W, jax_pipeline,
                                         slice_config)

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

N = 1500
WIRES = ("band", "tile", "raw", "packed_folded", "packed_tile")


def lattice_batch(rng, wire: str) -> dict:
    """(B, T, N) raw events on the 1/64 lattice with window-relative times,
    host tile-sorted for ``'tile'``, and a label with ignored rows."""
    raw = np.zeros((B, T, N, 4), np.float32)
    raw[..., 0] = rng.integers(0, (W - 1) * 64, (B, T, N)) / 64.0
    raw[..., 1] = rng.integers(0, (H - 1) * 64, (B, T, N)) / 64.0
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (B, T, N)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (B, T, N))
    valid = np.ones((B, T, N), bool)
    valid[..., N - N // 10:] = False
    out = {}
    if wire == "tile":
        rs, vs, os_ = zip(*(host_tile_bin(raw[i], valid[i], height=H,
                                          width=W) for i in range(B)))
        raw, valid = np.stack(rs), np.stack(vs)
        out["ev_tile_offsets"] = np.stack(os_)
    out.update({"ev_x": raw[..., 0], "ev_y": raw[..., 1],
                "ev_t": raw[..., 2], "ev_p": raw[..., 3], "ev_valid": valid})
    label = rng.integers(0, CLASSES, (B, H, W))
    label[:, :3] = 255
    out["label"] = label
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def wire_batch(wire: str, seed: int) -> dict:
    if wire == "band":
        return folded_batch(np.random.default_rng(seed))
    if wire.startswith("packed"):
        return packed_batch(wire.removeprefix("packed_"), seed)
    return lattice_batch(np.random.default_rng(seed), wire)


def window_fns(jpipe, pipe, batch):
    """Both packages' per-window voxelizers for ``batch`` (decoded)."""
    pre = bool(batch.get("ev_t_prenormalized", False))
    kind = "band" if "ev_band_offsets" in batch else "tile"
    return (jpipe.make_window_fn(JaxAugment(), t_prenormalized=pre,
                                 offsets_kind=kind),
            pipe.make_window_fn(AugmentParams(), t_prenormalized=pre,
                                offsets_kind=kind))


def assert_states_close(got, want):
    for (h_p, c_p), (h_j, c_j) in zip(got, want, strict=True):
        for p, j in ((h_p, h_j), (c_p, c_j)):
            np.testing.assert_allclose(p.numpy(), np.moveaxis(
                np.asarray(j), -1, 1), atol=1e-4, rtol=0)


@pytest.mark.parametrize("wire", WIRES)
def test_rollout_events_matches_jax(wire):
    cfg = slice_config(None)
    cols = wire_batch(wire, 0)
    mods = jax_build(cfg)
    state = jax_init_state(mods, jax.random.PRNGKey(0))
    pmods = port_modules(cfg, state)
    jpipe, pipe = jax_pipeline(False), port_pipeline()
    jsoa, soa = jax_batch(cols), torch_batch(cols)
    if wire.startswith("packed"):
        jsoa, soa = jpipe.decode_packed(jsoa), pipe.decode_packed(soa)
    jfn, fn = window_fns(jpipe, pipe, soa)
    img_j, state_j, lat_j = jax.device_get(mods.recon_val.rollout_events(
        state.e2vid_params, jsoa, jfn))
    calls = []

    def counted(*a, **k):
        calls.append(k["tile_offsets"] is None)
        return fn(*a, **k)

    with torch.no_grad():
        img, st, lat = pmods.recon_val.rollout_events(soa, counted)
        assert calls == [wire == "raw"] * T
        np.testing.assert_allclose(img.numpy(), np.moveaxis(img_j, -1, 1),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(lat[8].numpy(),
                                   np.moveaxis(lat_j[8], -1, 1), atol=1e-4,
                                   rtol=0)
        assert_states_close(st, state_j)
        # the precomputed rollout of the same batch
        windows, _ = pipe.build_all(soa)
        img2, st2, lat2 = pmods.recon_val.rollout(windows)
        torch.testing.assert_close(img, img2, atol=1e-5, rtol=0)
        torch.testing.assert_close(lat[8], lat2[8], atol=1e-5, rtol=0)
        # decode=False decodes no window
        assert pmods.recon_val.rollout_events(soa, fn, decode=False)[0] is None
