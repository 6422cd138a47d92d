"""The port's HSV and HLS conversions and lightness replacements against
cv2, which the JAX package calls (skipped where cv2 is absent).

``recon/color.py``'s ``bgr_to_hsv``, ``hsv_to_bgr``, ``bgr_to_hls`` and
``hls_to_bgr`` equal ``cv2.cvtColor``'s 8-bit ``COLOR_BGR2HSV``,
``COLOR_HSV2BGR``, ``COLOR_BGR2HLS`` and ``COLOR_HLS2BGR`` on all 2^24
triples (hue codes up to 255 included on the way back), laid out in rows
of 4096 pixels and (all of them for HSV2BGR, a quarter for the others)
of 16 (cv2's HSV2BGR rounds the pixels of a row past its last 32-pixel
vector block and truncates the others), and on frames
of widths 346, 47 and 33, and
``upsample_color_image`` with ``'HSV'`` and ``'HLS'`` equals the JAX
function's on seeded frames and on the BGR image a color merge builds
(the phases of ``merge_channels_into_color_image`` upsampled, shifted and
green-averaged, as the port's and JAX's merges build it). All exact.
"""

import numpy as np
import pytest

from ess_tpu.recon import color as jax_color

from ess_tpu_torch.recon import color
from tests.test_torch_loop import one_torch_thread

cv2 = pytest.importorskip("cv2")

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

CHUNK = 1 << 22


def all_triples(k: int) -> np.ndarray:
    """The k-th quarter of all 2^24 8-bit triples as a (1024, 4096, 3)
    image."""
    c = np.arange(k * CHUNK, (k + 1) * CHUNK, dtype=np.uint32)
    return np.stack([c & 255, (c >> 8) & 255, c >> 16], -1).astype(
        np.uint8).reshape(1024, 4096, 3)


@pytest.mark.parametrize("name,code", [
    ("bgr_to_hsv", "COLOR_BGR2HSV"), ("hsv_to_bgr", "COLOR_HSV2BGR"),
    ("bgr_to_hls", "COLOR_BGR2HLS"), ("hls_to_bgr", "COLOR_HLS2BGR")])
def test_conversion_equals_cv2_on_all_triples(name, code):
    fn, code = getattr(color, name), getattr(cv2, code)
    for k in range(4):
        img = all_triples(k)
        np.testing.assert_array_equal(fn(img), cv2.cvtColor(img, code))
        if k == 0 or name == "hsv_to_bgr":    # the one with two paths
            img = img.reshape(-1, 16, 3)
            np.testing.assert_array_equal(fn(img), cv2.cvtColor(img, code))
    rng = np.random.default_rng(2)
    for w in (346, 47, 33):
        img = rng.integers(0, 256, (300, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(fn(img), cv2.cvtColor(img, code))


def merge_bgr(channels):
    """The BGR image JAX's merge hands ``upsample_color_image``."""
    up = {ch: cv2.resize(channels[ch], dsize=None, fx=2, fy=2,
                         interpolation=cv2.INTER_LINEAR)
          for ch in ("R", "G", "W", "B")}
    up["B"] = jax_color.shift_image(up["B"], dx=1, dy=1)
    up["G"] = jax_color.shift_image(up["G"], dx=1, dy=0)
    up["W"] = jax_color.shift_image(up["W"], dx=0, dy=1)
    green = cv2.addWeighted(src1=up["G"], alpha=0.5, src2=up["W"], beta=0.5,
                            gamma=0.0, dtype=cv2.CV_8U)
    return np.dstack([up["B"], green, up["R"]])


@pytest.mark.parametrize("space", ["HSV", "HLS", "LAB"])
def test_upsample_color_image_matches_jax(space):
    rng = np.random.default_rng(3)
    h, w = 130, 173
    gray = rng.integers(0, 256, (2 * h, 2 * w)).astype(np.uint8)
    bgr = rng.integers(0, 256, (2 * h, 2 * w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        color.upsample_color_image(gray, bgr, space),
        jax_color.upsample_color_image(gray, bgr, space))
    channels = {ch: rng.integers(0, 256, (h, w)).astype(np.uint8)
                for ch in ("R", "G", "W", "B")}
    merged = merge_bgr(channels)
    np.testing.assert_array_equal(
        color.upsample_color_image(gray, merged, space),
        jax_color.upsample_color_image(gray, merged, space))
    if space == "LAB":
        channels["grayscale"] = gray
        np.testing.assert_array_equal(
            jax_color.upsample_color_image(gray, merged, space),
            color.merge_channels_into_color_image(channels))


def test_unknown_colorspace_raises():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError):
        color.upsample_color_image(img[..., 0], img, "YUV")
