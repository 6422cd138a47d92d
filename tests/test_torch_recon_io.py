"""The reconstruction program's host helpers against cv2 and the JAX package.

- ``data/png.py::imwrite``: gray and BGR images of odd sizes decode, through
  ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``, to exactly the pixels that
  ``cv2.imwrite`` stores for them, and the port's own ``decode`` reads them
  back (in R, G, B order).
- ``recon/color.py``: ``bgr_to_lab`` and ``lab_to_bgr`` against
  ``cv2.cvtColor`` over every one of the 2^24 8-bit triples. Bound, stated
  before the first run: the target is equality; at most 1 level per
  channel on at most 0.5 % of the values would be accepted. Result: equal
  at every triple, both ways. ``bayer_split``, ``shift_image`` and
  ``merge_channels_into_color_image`` equal JAX's (cv2) versions on seeded
  images; the ``'HSV'`` and ``'HLS'`` branches raise.
- ``cli/reconstruct.py::to_frame8`` equals JAX's ``to_uint8``.
"""

import numpy as np
import pytest
import torch

from ess_tpu.recon import color as jax_color

from ess_tpu_torch.cli.reconstruct import to_frame8
from ess_tpu_torch.data import png
from ess_tpu_torch.recon import color

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (260, 346), (1, 1, 3),
                                   (5, 9, 3), (38, 50, 3), (260, 346, 3)])
def test_imwrite_reads_back_as_cv2_writes(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    png.imwrite(ours, img)
    cv2.imwrite(theirs, img)
    want = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
    got = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)
    with open(ours, "rb") as f:
        back = png.decode(f.read())
    np.testing.assert_array_equal(back, img[:, :, ::-1] if img.ndim == 3
                                  else img)


def test_imwrite_refuses_other_images(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4,), np.uint8)):
        with pytest.raises(ValueError):
            png.imwrite(str(tmp_path / "x.png"), bad)


def all_triples(part: int) -> np.ndarray:
    """A quarter of the 2^24 8-bit triples as a (1024, 4096, 3) image."""
    v = np.arange(256, dtype=np.uint8)
    a, b, c = np.meshgrid(v[64 * part:64 * (part + 1)], v, v, indexing="ij")
    return np.stack([a, b, c], -1).reshape(1024, 4096, 3)


@pytest.mark.parametrize("part", range(4))
@pytest.mark.parametrize("way", ["BGR2LAB", "LAB2BGR"])
def test_lab_conversions_equal_cv2_everywhere(way, part):
    """Every triple, in four parts; see the module docstring's bound."""
    src = all_triples(part)
    fn = color.bgr_to_lab if way == "BGR2LAB" else color.lab_to_bgr
    want = cv2.cvtColor(src, getattr(cv2, f"COLOR_{way}"))
    got = fn(src)
    off = np.abs(got.astype(np.int16) - want)
    assert off.max() <= 1 and (off > 0).mean() <= 0.005
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(260, 346), (48, 64), (38, 50)])
def test_merge_matches_jax(hw):
    h, w = hw
    rng = np.random.default_rng(h + w)
    channels = {ch: rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
                for ch in "RGWB"}
    channels["grayscale"] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    got = color.merge_channels_into_color_image(dict(channels))
    want = jax_color.merge_channels_into_color_image(dict(channels))
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    lab_gray = cv2.cvtColor(got, cv2.COLOR_BGR2LAB)[:, :, 0]
    assert np.abs(lab_gray.astype(int) - channels["grayscale"]).mean() < 2


def test_bayer_split_shift_and_uint8_match_jax():
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(26, 36, 5)).astype(np.float32)
    want = jax_color.bayer_split(grid)
    got = color.bayer_split(torch.from_numpy(np.moveaxis(grid, -1, 0)))
    assert list(got) == list(want) == ["R", "G", "W", "B"]
    for ch in want:
        np.testing.assert_array_equal(got[ch].numpy(),
                                      np.moveaxis(want[ch], -1, 0))
    img = rng.integers(0, 256, (9, 11), dtype=np.uint8)
    for dx, dy in ((1, 1), (1, 0), (0, 1), (-1, 2), (0, -2)):
        np.testing.assert_array_equal(
            color.shift_image(img.copy(), dx, dy),
            jax_color.shift_image(img.copy(), dx, dy))
    x = rng.normal(0.5, 0.6, (30, 40)).astype(np.float32)
    np.testing.assert_array_equal(to_frame8(torch.from_numpy(x)).numpy(),
                                  jax_color.to_uint8(x))


@pytest.mark.parametrize("space", ["HSV", "HLS"])
def test_unported_colorspaces_raise(space):
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        color.upsample_color_image(img[:, :, 0], img, space)
