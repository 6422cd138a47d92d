"""The port's post-processing and display against the JAX package's.

Device ops (``recon/postprocess.py``) on seeded frames, NCHW against JAX's
NHWC: ``robust_min`` / ``robust_max`` within 1e-6 relative (both
interpolate linearly between ranks in the same f32 expressions; the
auto-HDR bounds below are held equal), ``gaussian_kernel`` within 1e-7,
``unsharp_mask`` within 1e-6, ``zero_hot_pixels`` exactly;
``rescale_intensity`` and ``IntensityRescaler`` (fixed and auto-HDR over
12 frames of the DAVIS346's 260x346, the median window full and sliding)
equal except that at most 1e-4 of the pixels may differ by one level,
1/255: both floor the same f32 expression, whose last bit may differ
where it lies on an integer.

``bilateral_filter``, the port's numpy emulation, against JAX's
``cv2.bilateralFilter`` (skipped where cv2 is absent) for sigma 0, 0.5, 1
and 3 on random and smooth 260x346 frames and a random 480x640 one:
identical at sigma 0; else at most one level apart, on at most 2e-4 of the
pixels, and only where the emulation's ``sum / wsum`` lies within 1e-4 of
an integer. OpenCV's x86 build filters 8-bit images with Intel IPP, whose
exact arithmetic the emulation does not reproduce: at such ties its
truncation may land one level lower (the border rule, reflect-101 with the
outer columns rounded, is matched on every frame here).

``display.py``: ``make_event_preview`` and ``ImageDisplay.compose``
exactly, every mode, border and stacking; ``display=True`` raises.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ess_tpu.recon import display as jax_display
from ess_tpu.recon import postprocess as jax_post

from ess_tpu_torch.recon import display, postprocess
from tests.test_torch_loop import one_torch_thread

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

FLOOR_SHARE = 1e-4


def frames(seed, n=2, h=48, w=64):
    """(N, H, W, 1) frames around [0, 1] with outliers beyond it."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 0.3, (n, h, w, 1)).astype(np.float32)
    x.reshape(-1)[rng.integers(0, x.size, 20)] = 4.0
    return x


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def floor_close(got: torch.Tensor, want) -> None:
    d = np.abs(got.numpy() - np.moveaxis(np.asarray(want), -1, 1))
    assert d.max() <= 1.0 / 255 + 1e-7
    assert (d > 0).mean() <= FLOOR_SHARE


@pytest.mark.parametrize("q", [5.0, 50.0, 95.0, 0.0, 100.0])
def test_robust_bounds_match_jax(q):
    x = frames(1)
    np.testing.assert_allclose(
        float(postprocess.robust_min(nchw(x), q)),
        float(jax_post.robust_min(jnp.asarray(x), q)), rtol=1e-6)
    np.testing.assert_allclose(
        float(postprocess.robust_max(nchw(x), q)),
        float(jax_post.robust_max(jnp.asarray(x), q)), rtol=1e-6)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.2, 0.7), (0.3, 0.3)])
def test_rescale_intensity_matches_jax(bounds):
    x = frames(3)
    floor_close(postprocess.rescale_intensity(nchw(x), *bounds),
                jax_post.rescale_intensity(jnp.asarray(x), *bounds))


@pytest.mark.parametrize("auto_hdr", [False, True])
def test_intensity_rescaler_matches_jax(auto_hdr):
    kw = dict(auto_hdr=auto_hdr, imin=0.1, imax=0.9, median_filter_size=5,
              percentile=3.0)
    port, ref = postprocess.IntensityRescaler(**kw), jax_post.IntensityRescaler(
        **kw)
    for i in range(12):
        x = frames(10 + i, n=1, h=260, w=346) * (1 + 0.1 * i)
        floor_close(port(nchw(x)), ref(jnp.asarray(x)))
    if auto_hdr:
        assert list(port._mins) == list(ref._mins)
        assert list(port._maxs) == list(ref._maxs)


@pytest.mark.parametrize("size,sigma,amount", [(5, 1.0, 0.3), (3, 0.6, 1.5),
                                               (7, 2.0, 0.0)])
def test_unsharp_mask_matches_jax(size, sigma, amount):
    np.testing.assert_allclose(
        postprocess.gaussian_kernel(size, sigma).numpy(),
        np.asarray(jax_post.gaussian_kernel(size, sigma)), rtol=0, atol=1e-7)
    x = np.concatenate([frames(4), frames(5)], -1)          # two channels
    got = postprocess.unsharp_mask(nchw(x), amount, sigma, size)
    want = jax_post.unsharp_mask(jnp.asarray(x), amount, sigma, size)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want),
                                                        -1, 1),
                               rtol=0, atol=1e-6)


def test_zero_hot_pixels_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 12, 9, 3)).astype(
        np.float32)
    hot = np.array([[0, 0], [8, 11], [3, 4], [9, 2], [-1, 5], [4, 12]])
    got = postprocess.zero_hot_pixels(nchw(x), hot)
    want = jax_post.zero_hot_pixels(jnp.asarray(x), hot)
    np.testing.assert_array_equal(got.numpy(),
                                  np.moveaxis(np.asarray(want), -1, 1))
    assert postprocess.zero_hot_pixels(nchw(x), []).data_ptr() == nchw(
        x).data_ptr() or torch.equal(postprocess.zero_hot_pixels(
            nchw(x), []), nchw(x))


def bilateral_frame(kind, h=260, w=346, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((h, w)).astype(np.float32)
    y, x = np.mgrid[:h, :w]
    return (0.5 + 0.4 * np.sin(x / 13.0) * np.cos(y / 7.0)
            + 0.05 * rng.standard_normal((h, w))).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 3.0])
@pytest.mark.parametrize("kind,hw", [("random", (260, 346)),
                                     ("smooth", (260, 346)),
                                     ("random", (480, 640))])
def test_bilateral_filter_matches_cv2(sigma, kind, hw):
    pytest.importorskip("cv2")
    img = bilateral_frame(kind, *hw)
    want = jax_post.bilateral_filter(img, sigma)
    got = postprocess.bilateral_filter(img, sigma)
    if sigma <= 0:
        assert got is img and want is img
        return
    assert got.dtype == want.dtype == np.float32
    g8, w8 = np.rint(got * 255).astype(int), np.rint(want * 255).astype(int)
    off = g8 != w8
    # the tie count of this cv2 build, recorded in PERF.md (run with -s)
    print(f"bilateral {kind} {hw[0]}x{hw[1]} sigma {sigma}: "
          f"{int(off.sum())} of {off.size} pixels one level apart")
    assert np.abs(g8 - w8).max() <= 1
    assert off.mean() <= 2e-4
    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    q = postprocess.bilateral_quotients(img8, 25.0 * sigma)[off]
    assert np.all(np.abs(q - np.rint(q)) <= 1e-4), q


def test_event_preview_and_compose_match_jax():
    rng = np.random.default_rng(8)
    ev = rng.normal(0, 3, (5, 20, 30)).astype(np.float32)
    ev[:, 5] = 0.0
    gray = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    bgr = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    for mode in ("red-blue", "grayscale"):
        for nb in (-1, 2):
            np.testing.assert_array_equal(
                display.make_event_preview(ev, mode, nb),
                jax_display.make_event_preview(ev, mode, nb))
            for border in (0, 3):
                for show in (False, True):
                    kw = dict(show_events=show, event_display_mode=mode,
                              num_bins_to_show=nb, border=border)
                    port, ref = display.ImageDisplay(**kw), \
                        jax_display.ImageDisplay(**kw)
                    for img in (gray, bgr):
                        got = port.compose(img, ev)
                        np.testing.assert_array_equal(got,
                                                      ref.compose(img, ev))
    with pytest.raises(RuntimeError, match="display"):
        display.ImageDisplay(display=True)
