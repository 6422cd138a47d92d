"""The port's cv2-free PNG mask reader and nearest resize
(``ess_tpu_torch.data.png``) against ``cv2.imread(path, 0)`` and
``cv2.resize(..., INTER_NEAREST)`` on the CPU: masks that
``tests.test_datasets_integration.make_ddd17_dir`` writes, PNGs that cv2
writes at several compression levels, PNGs filtered by hand with each of
the five row filters (cv2 picks Sub and Average on these images) and a mix
of them, and the DDD17 346x260 -> 352x200 resize at every pixel. Other
kinds of PNG (RGB, 16-bit, interlaced) raise. Every comparison is exact.
"""

import struct
import zlib

import numpy as np
import pytest

from ess_tpu_torch.data import png

cv2 = pytest.importorskip("cv2")

H, W = 260, 346


def images():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 6, (H, W)).astype(np.uint8)
    labels[::7] = 255
    labels[50:120, 30:200] = 3
    ramp = (np.add.outer(np.arange(H), np.arange(W)) // 3 % 256).astype(
        np.uint8)
    noise = rng.integers(0, 256, (H, W)).astype(np.uint8)
    return {"labels": labels, "ramp": ramp, "noise": noise}


def encode(img: np.ndarray, kinds) -> bytes:
    """An 8-bit grayscale PNG of ``img`` with row ``y`` filtered by
    ``kinds[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w = img.shape
    rows, prev = [], np.zeros(w, np.int32)
    for y in range(h):
        r = img[y].astype(np.int32)
        a = np.concatenate([[0], r[:-1]])
        c = np.concatenate([[0], prev[:-1]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = [np.zeros_like(a), a, prev, (a + prev) >> 1, paeth][kinds[y]]
        rows.append(bytes([kinds[y]]) + ((r - pred) & 255).astype(
            np.uint8).tobytes())
        prev = r
    return png_bytes(struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0),
                     zlib.compress(b"".join(rows)))


def png_bytes(ihdr: bytes, data: bytes) -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", data)
            + chunk(b"IEND", b""))


def test_reads_ddd17_masks(tmp_path):
    from tests.test_datasets_integration import make_ddd17_dir

    make_ddd17_dir(str(tmp_path), n_dirs=2, n_masks=3, n_events=500)
    paths = sorted(tmp_path.glob("dir*/segmentation_masks/*.png"))
    assert len(paths) == 6
    for p in paths:
        got = png.read_gray8(str(p))
        assert got.dtype == np.uint8 and got.shape == (H, W)
        np.testing.assert_array_equal(got, cv2.imread(str(p), 0))


@pytest.mark.parametrize("level", [0, 1, 3, 6, 9])
@pytest.mark.parametrize("name", ["labels", "ramp", "noise"])
def test_reads_cv2_pngs(tmp_path, name, level):
    img = images()[name]
    path = str(tmp_path / "m.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    got = png.read_gray8(path)
    np.testing.assert_array_equal(got, cv2.imread(path, 0))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_each_row_filter(tmp_path, kind):
    img = images()["noise"]
    kinds = ([y % 5 for y in range(H)] if kind == "mixed" else [kind] * H)
    data = encode(img, kinds)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(cv2.imread(str(path), 0), img)
    np.testing.assert_array_equal(png.decode_gray8(data), img)


@pytest.mark.parametrize("dst", [(200, 352), (100, 173), (300, 500),
                                 (7, 3), (260, 346)])
def test_resize_nearest_matches_cv2(dst):
    img = images()["noise"]
    got = png.resize_nearest(img, *dst)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    assert got.shape == want.shape == dst
    np.testing.assert_array_equal(got, want)


def test_ddd17_label_geometry(tmp_path):
    """The loader's path: a written mask read and squeezed to 200x352,
    equal at every pixel to cv2's read and resize."""
    img = images()["labels"]
    path = str(tmp_path / "seg_00001.png")
    cv2.imwrite(path, img)
    got = png.resize_nearest(png.read_gray8(path), 200, 352)
    want = cv2.resize(cv2.imread(path, 0), (352, 200),
                      interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb", "gray16", "interlaced", "filter",
                                  "not_png"])
def test_other_pngs_raise(tmp_path, kind):
    img = images()["labels"]
    path = tmp_path / "x.png"
    if kind == "rgb":
        cv2.imwrite(str(path), np.stack([img] * 3, -1))
    elif kind == "gray16":
        cv2.imwrite(str(path), img.astype(np.uint16) * 257)
    elif kind == "interlaced":
        path.write_bytes(png_bytes(
            struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 1),
            zlib.compress(bytes(H * (W + 1)))))
    elif kind == "filter":
        rows = bytearray(H * (W + 1))
        rows[0] = 5
        path.write_bytes(png_bytes(
            struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0),
            zlib.compress(bytes(rows))))
    else:
        path.write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError):
        png.read_gray8(str(path))
