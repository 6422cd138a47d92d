"""The port's PNG decoder on 8-bit gray and RGB files
(``ess_tpu_torch.data.png``) against cv2 on the CPU.

- :func:`png.decode` equals ``cv2.imread(path, IMREAD_UNCHANGED)`` (with
  the channels in R, G, B order) on every pixel of gray and RGB PNGs that
  cv2 writes at several compression levels and that :func:`encode` writes
  with each of the five row filters forced, and a mix of them;
- the C++ unfilter (``csrc/image_host.cpp``) equals the plain Python one,
  :func:`png.unfilter_ref`, on every filter at 1 and 3 bytes a pixel, and
  so does its fused gray mix with the plain mix of the plain unfilter;
- :func:`png.imread_gray` equals ``cv2.imread(path, 0)`` on every pixel of
  those files: cv2 turns RGB into gray inside libpng, and the port's C++
  and plain conversions reproduce that mix exactly;
- palette, 16-bit, alpha and interlaced PNGs raise ``ValueError``, and a
  C++ source that does not build makes the decoder raise.

Every comparison is exact.
"""

import struct
import zlib

import numpy as np
import pytest

from ess_tpu_torch.data import png


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


cv2 = pytest.importorskip("cv2")

KINDS = [0, 1, 2, 3, 4, "mixed"]


def encode(img: np.ndarray, kinds, level: int = 6) -> bytes:
    """An 8-bit gray (H, W) or RGB (H, W, 3) PNG of ``img`` with row ``y``
    filtered by ``kinds[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth),
    every row filtered at once from the unfiltered image."""
    h = img.shape[0]
    ch = 1 if img.ndim == 2 else 3
    x = img.reshape(h, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, ch:] = x[:, :-ch]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, ch:] = x[:-1, :-ch]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    k = np.asarray(kinds, np.int64)
    filtered = ((x - preds[k, np.arange(h)]) & 255).astype(np.uint8)
    raw = np.concatenate([k.astype(np.uint8)[:, None], filtered], 1)
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, 8, 0 if ch == 1 else 2,
                       0, 0, 0)
    return png_bytes(ihdr, zlib.compress(raw.tobytes(), level))


def png_bytes(ihdr: bytes, data: bytes) -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", data)
            + chunk(b"IEND", b""))


def kinds_for(kind, h):
    return [y % 5 for y in range(h)] if kind == "mixed" else [kind] * h


def scene(h=61, w=97, channels=3, seed=0):
    """A smooth scene with noise and flat patches, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = [128 + 100 * np.sin(xx / (7 + 3 * c) + yy / (11 + c))
              for c in range(channels)]
    img = np.stack(planes, -1) + rng.normal(0, 6, (h, w, channels))
    img[h // 3: h // 2, w // 4: w // 2] = 77
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def unchanged(path):
    """``cv2.imread(path, IMREAD_UNCHANGED)`` with RGB channels in R, G, B
    order."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_decode_cv2_written(tmp_path, channels, level):
    img = scene(channels=channels, seed=level)
    path = tmp_path / "x.png"
    # cv2 writes B, G, R: hand it the scene reversed to store R, G, B
    assert cv2.imwrite(str(path), img[..., ::-1] if channels == 3 else img,
                       [cv2.IMWRITE_PNG_COMPRESSION, level])
    got = png.decode(path.read_bytes())
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, unchanged(path))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_each_filter(tmp_path, channels, kind):
    img = scene(channels=channels, seed=7)
    path = tmp_path / "f.png"
    path.write_bytes(encode(img, kinds_for(kind, img.shape[0])))
    np.testing.assert_array_equal(unchanged(path), img)
    np.testing.assert_array_equal(png.decode(path.read_bytes()), img)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", [1, 2, 33])
def test_unfilter_matches_plain(channels, kind, width):
    """The C++ unfilter against the plain one on random filtered bytes,
    every filter, 1 and 3 bytes a pixel, rows narrower than a pixel's
    neighbourhood included."""
    rng = np.random.default_rng(width * 10 + channels)
    h = 23
    rows = rng.integers(0, 256, (h, 1 + width * channels)).astype(np.uint8)
    rows[:, 0] = kinds_for(kind, h)
    want = png.unfilter_ref(rows, channels)
    np.testing.assert_array_equal(png.unfilter(rows, channels), want)
    if channels == 3:
        np.testing.assert_array_equal(
            png.unfilter_gray(rows),
            png.rgb_to_gray_ref(want.reshape(h, width, 3)))


@pytest.mark.parametrize("writer", ["cv2", "numpy"])
@pytest.mark.parametrize("channels", [1, 3])
def test_imread_gray_matches_cv2(tmp_path, writer, channels):
    img = scene(channels=channels, seed=11)
    path = tmp_path / "g.png"
    if writer == "cv2":
        cv2.imwrite(str(path), img[..., ::-1] if channels == 3 else img)
    else:
        path.write_bytes(encode(img, kinds_for("mixed", img.shape[0])))
    got = png.imread_gray(str(path))
    assert got.dtype == np.uint8 and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, cv2.imread(str(path), 0))


def test_gray_mix_every_level(tmp_path):
    """``imread_gray`` (the C++ unfilter with its gray mix) and the plain
    mix of the decoded pixels against cv2 on random RGB pixels, all 256
    gray levels included (they pass through)."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    img[0, :, :] = np.repeat(np.arange(96, dtype=np.uint8)[:, None], 3, 1)
    img[1, :, :] = np.repeat(np.arange(160, 256, dtype=np.uint8)[:, None],
                             3, 1)
    img[2, :, :] = np.repeat(np.arange(96, 192, dtype=np.uint8)[:, None],
                             3, 1)
    path = tmp_path / "rgb.png"
    path.write_bytes(encode(img, kinds_for("mixed", 64)))
    want = cv2.imread(str(path), 0)
    np.testing.assert_array_equal(png.imread_gray(str(path)), want)
    np.testing.assert_array_equal(png.rgb_to_gray_ref(img), want)


@pytest.mark.parametrize("kind", ["palette", "gray16", "rgb16", "gray_alpha",
                                  "rgba", "interlaced_rgb", "filter_rgb"])
def test_other_kinds_raise(tmp_path, kind):
    h, w = 8, 5
    depth, color, interlace, raw = 8, 2, 0, bytes(h * (3 * w + 1))
    if kind == "palette":
        color, raw = 3, bytes(h * (w + 1))
    elif kind in ("gray16", "rgb16"):
        depth, color = 16, 0 if kind == "gray16" else 2
    elif kind == "gray_alpha":
        color, raw = 4, bytes(h * (2 * w + 1))
    elif kind == "rgba":
        color, raw = 6, bytes(h * (4 * w + 1))
    elif kind == "interlaced_rgb":
        interlace = 1
    else:
        raw = bytes([5]) + raw[1:]
    path = tmp_path / "x.png"
    path.write_bytes(png_bytes(
        struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace),
        zlib.compress(raw)))
    with pytest.raises(ValueError):
        png.imread_gray(str(path))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A C++ source that does not compile makes the decoder raise; it
    never falls back to the Python loop."""
    bad = tmp_path / "image_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(png, "_SRC", str(bad))
    monkeypatch.setattr(png, "_lib", None)
    data = encode(scene(channels=3), kinds_for("mixed", 61))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        png.decode(data)
