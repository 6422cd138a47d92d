"""The port's reconstruction program against the JAX package's, on the CPU.

One seeded ``.pth.tar`` in the upstream layout (the port's ``RecurrentUNet``
state dict, base 8, under ``unetrecurrent.``, with a ``model`` config) feeds
both ``load_e2vid_checkpoint``s. Both CLIs run on the same written event
file:

- at 64x48, which needs no pad, with ``-N``, ``-T`` with
  ``--no-normalize``, and ``--color``: the same file names, and frames
  within 1 grey level on at most 1 % of the pixels (color: 2 levels, 2 %);
  both compute the same f32 function with sums in other orders;
- at 50x38, which pads, the port's frames against JAX's ``Reconstructor``
  with JAX's ``crop_output`` (the centered crop), under the same bound; the
  JAX CLI's frames are, bit for bit, the top-left slice of the same padded
  output instead (ROADMAP.md, Queue C).

The port's CLI runs with ``sys.modules['cv2'] = None``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.cli import reconstruct as jax_cli
from ess_tpu.data.readers import FixedSizeEventReader
from ess_tpu.io.convert import load_e2vid_checkpoint
from ess_tpu.models import RecurrentUNet as JaxUNet
from ess_tpu.ops.batch_voxel import voxelize_window_soa
from ess_tpu.ops.pad import crop_output
from ess_tpu.ops.voxel import normalize_nonzero
from ess_tpu.recon import Reconstructor as JaxReconstructor

from ess_tpu_torch.cli import reconstruct
from ess_tpu_torch.data import png
from ess_tpu_torch.models.e2vid import RecurrentUNet
from tests.test_torch_loop import one_torch_thread

cv2 = pytest.importorskip("cv2")
_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

BASE = 8


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory) -> str:
    """Seeded weights in the upstream E2VID layout; the weights are twice
    the default initialization's so that frames span many grey levels."""
    model = RecurrentUNet(base_channels=BASE, device="cpu")
    reconstruct.seeded_init(model, seed=3)
    path = str(tmp_path_factory.mktemp("ckpt") / "e2vid.pth.tar")
    torch.save({
        "state_dict": {f"unetrecurrent.{k}": 2 * v
                       for k, v in model.state_dict().items()},
        "model": {"num_bins": 5, "num_encoders": 3,
                  "base_num_channels": BASE, "num_residual_blocks": 2,
                  "skip_type": "sum"}}, path)
    return path


def write_events(path: str, width: int, height: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1.0, n))
    # events clustered on a few blobs, so that frames have structure
    cx = rng.uniform(0, width, 6)[rng.integers(0, 6, n)]
    cy = rng.uniform(0, height, 6)[rng.integers(0, 6, n)]
    x = np.clip(np.rint(cx + rng.normal(0, 4, n)), 0, width - 1).astype(int)
    y = np.clip(np.rint(cy + rng.normal(0, 4, n)), 0, height - 1).astype(int)
    p = rng.integers(0, 2, n)
    with open(path, "w") as f:
        f.write(f"{width} {height}\n")
        for i in range(n):
            f.write(f"{t[i]:.6f} {x[i]} {y[i]} {p[i]}\n")
    return path


def frame8(img) -> np.ndarray:
    """The JAX CLI's 8-bit frame of an f32 image."""
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def run_port(monkeypatch, argv):
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        reconstruct.main(argv, device="cpu")


def frames(folder: str) -> dict:
    return {name: cv2.imread(os.path.join(folder, name), cv2.IMREAD_UNCHANGED)
            for name in sorted(os.listdir(folder))}


def within(got: np.ndarray, want: np.ndarray, levels: int, share: float):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    off = np.abs(got.astype(np.int16) - want)
    assert off.max() <= levels, off.max()
    assert (off > 0).mean() <= share, (off > 0).mean()


@pytest.mark.parametrize("flags,levels,share", [
    (["-N", "1000"], 1, 0.01),
    (["-T", "250", "--no-normalize"], 1, 0.01),
    (["-N", "2000", "--color"], 2, 0.02)],
    ids=["N", "T-no-normalize", "color"])
def test_cli_matches_jax_without_pad(tmp_path, monkeypatch, capsys, ckpt,
                                     flags, levels, share):
    events = write_events(str(tmp_path / "events.txt"), 64, 48, 4000, 1)
    jax_cli.main(["-c", ckpt, "-i", events, "-o", str(tmp_path / "jax")]
                 + flags)
    jax_out = capsys.readouterr().out
    run_port(monkeypatch, ["-c", ckpt, "-i", events,
                           "-o", str(tmp_path / "port")] + flags)
    port_out = capsys.readouterr().out
    want, got = frames(str(tmp_path / "jax")), frames(str(tmp_path / "port"))
    assert list(got) == list(want) and len(got) >= 2
    assert port_out.replace("/port/", "/jax/") == jax_out
    for name in want:
        assert got[name].shape == ((48, 64, 3) if "--color" in flags
                                   else (48, 64))
        within(got[name], want[name], levels, share)
        assert got[name].std() > 5   # the frames are not flat


def test_cli_crops_centered_where_jax_takes_the_top_left(tmp_path,
                                                         monkeypatch, ckpt):
    """50x38 pads 1 + 1 rows and 3 + 3 columns: the port writes JAX's
    ``Reconstructor`` output cropped by ``crop_output``; the JAX CLI writes
    the top-left 38x50 of the same output."""
    h, w = 38, 50
    events = write_events(str(tmp_path / "events.txt"), w, h, 3000, 2)
    jax_cli.main(["-c", ckpt, "-i", events, "-o", str(tmp_path / "jax"),
                  "-N", "1000"])
    run_port(monkeypatch, ["-c", ckpt, "-i", events,
                           "-o", str(tmp_path / "port"), "-N", "1000"])

    params, config = load_e2vid_checkpoint(ckpt)
    model = JaxUNet(base_channels=BASE, num_encoders=3)
    recon = JaxReconstructor(model=model, height=h, width=w, normalize=False)
    assert recon.geometry.pads == (1, 1, 3, 3)
    step = jax.jit(lambda p, g, s: recon.step(p, g, s))
    state = recon.init_state(1)
    want_port, want_jax = [], []
    for window in FixedSizeEventReader(events, 1000):
        t, x, y, p = window.T
        grid = voxelize_window_soa(
            jnp.asarray(x, jnp.float32)[None],
            jnp.asarray(y, jnp.float32)[None],
            jnp.asarray(t - t[0], jnp.float32)[None],
            jnp.asarray(p, jnp.float32)[None], jnp.ones((1, len(x)), bool),
            num_bins=5, height=h, width=w, normalize=False)
        img, state, _ = step(params, jax.jit(normalize_nonzero)(grid), state)
        want_port.append(frame8(crop_output(img, recon.geometry)[0, :, :, 0]))
        want_jax.append(frame8(img[0, :h, :w, 0]))
    got_port, got_jax = frames(str(tmp_path / "port")), frames(
        str(tmp_path / "jax"))
    assert list(got_port) == list(got_jax) and len(got_port) == 3
    for i, name in enumerate(got_port):
        within(got_port[name], want_port[i], 1, 0.01)
        np.testing.assert_array_equal(got_jax[name], want_jax[i])
        assert (want_port[i] != want_jax[i]).mean() > 0.5


def test_written_frames_decode_without_cv2(tmp_path, monkeypatch):
    """Default seeded weights, no checkpoint: one PNG a window, decoded by
    the port's own reader."""
    events = write_events(str(tmp_path / "events.txt"), 64, 48, 2500, 3)
    run_port(monkeypatch, ["-i", events, "-o", str(tmp_path / "out"),
                           "-N", "1000"])
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == [f"frame_{i:010d}.png" for i in range(2)]
    with open(tmp_path / "out" / names[0], "rb") as f:
        assert png.decode(f.read()).shape == (48, 64)


def test_display_raises_and_needs_a_gpu_by_default(tmp_path):
    events = write_events(str(tmp_path / "events.txt"), 64, 48, 100, 4)
    with pytest.raises(RuntimeError, match="display"):
        reconstruct.main(["-i", events, "--display"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reconstruct.main(["-i", events, "-o", str(tmp_path / "o")])
