"""The port's sensor-A image sets against the JAX package's, and their
image operations against cv2, on the CPU.

- Each function of ``ess_tpu_torch.data.imgproc`` against the cv2 call it
  reproduces: resizes (the C++ one and its numpy plain version), blurs and
  the 3x3 filter equal at every pixel;
  warps' labels (nearest) equal on all pixels for the affine warp and on
  all but 0.01 % for the perspective one; warps' images within 1 level,
  unequal on at most 0.1 % of pixels; ``perspective_transform`` within
  1e-7 of ``cv2.getPerspectiveTransform``.
- ``CityscapesGray`` (both geometry modes, augmentation on over 32
  indices x 2 passes, and off), ``DDD17Gray`` and ``ConcatImages`` against
  the JAX classes on the same written trees (frames written by cv2 and by
  a numpy writer with mixed row filters). Per sample: the same
  augmentation draws (the generators end in the same state); labels equal
  on at least 99.9 % of pixels, on all of them where no warp was drawn;
  images within 1/255 but on at most 0.1 % of pixels (a level that a warp
  moves can grow to 2 through the contrast or sharpen that follow),
  equal where no warp was drawn. The DDD17 event set's paired validation
  frame, now read without cv2, equals the JAX set's.

The JAX class passes float64 target corners to
``cv2.getPerspectiveTransform`` in its perspective augmentation, which cv2
refuses (it asks for float32 points): the comparisons run the JAX side with
that call given float32 corners (:func:`float32_corners`), and
``test_jax_perspective_needs_float32_corners`` shows the refusal.
"""

import os

import numpy as np
import pytest

from ess_tpu_torch.data import imgproc
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_png_rgb import encode, scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


cv2 = pytest.importorskip("cv2")

CITY_HW = (128, 256)      # written frames; the sets resize them
SAMPLES = 32              # indices of the augmented comparisons
IMG_SHARE = 1e-3          # pixels allowed past 1/255 (module docstring)
LABEL_SHARE = 1e-3        # labels allowed to differ


def make_cityscapes_tree(root, n_train=SAMPLES, n_val=4, hw=CITY_HW,
                         seed=0):
    """A Cityscapes tree of RGB ``leftImg8bit`` frames and gray
    ``gtFine_labelIds`` masks over two cities; odd frames are written by
    cv2, even ones by :func:`encode` with mixed row filters."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            city = f"city{i % 2}"
            for sub in ("leftImg8bit", "gtFine"):
                os.makedirs(os.path.join(root, sub, split, city),
                            exist_ok=True)
            stem = os.path.join(root, "{}", split, city, f"{city}_{i:06d}")
            img = scene(*hw, channels=3, seed=int(rng.integers(1 << 30)))
            ids = rng.integers(0, 34, (hw[0] // 8, hw[1] // 8))
            label = np.kron(ids, np.ones((8, 8), np.int64)).astype(np.uint8)
            img_path = stem.format("leftImg8bit") + "_leftImg8bit.png"
            lbl_path = stem.format("gtFine") + "_gtFine_labelIds.png"
            if i % 2:
                cv2.imwrite(img_path, img[..., ::-1])
                cv2.imwrite(lbl_path, label)
            else:
                kinds = [int(k) for k in rng.integers(0, 5, hw[0])]
                with open(img_path, "wb") as f:
                    f.write(encode(img, kinds))
                with open(lbl_path, "wb") as f:
                    f.write(encode(label, kinds))


def add_ddd17_frames(root, n_masks, seed=0):
    """Grayscale frames in each recording's ``imgs/`` beside its masks
    (``tests.test_datasets_integration.make_ddd17_dir``), one for each
    mask; every third one RGB."""
    rng = np.random.default_rng(seed)
    for j, d in enumerate(sorted(os.listdir(root))):
        img_dir = os.path.join(root, d, "imgs")
        os.makedirs(img_dir, exist_ok=True)
        for m in range(n_masks):
            rgb = (m + j) % 3 == 0
            img = scene(260, 346, channels=3 if rgb else 1,
                        seed=int(rng.integers(1 << 30)))
            path = os.path.join(img_dir, f"img_{m + 1:05d}.png")
            if m % 2:
                cv2.imwrite(path, img[..., ::-1] if rgb else img)
            else:
                with open(path, "wb") as f:
                    f.write(encode(img, [int(k) for k in
                                         rng.integers(0, 5, 260)]))


def float32_corners(monkeypatch):
    """Give ``cv2.getPerspectiveTransform`` float32 points, as it requires
    (module docstring)."""
    orig = cv2.getPerspectiveTransform
    monkeypatch.setattr(cv2, "getPerspectiveTransform",
                        lambda s, d, *a: orig(np.float32(s), np.float32(d),
                                              *a))


def check_sample(got, want, warped):
    """The per-sample bounds of the module docstring."""
    assert sorted(got) == sorted(want) == ["image", "label"]
    assert got["image"].dtype == want["image"].dtype == np.float32
    assert got["label"].dtype == want["label"].dtype == np.uint8
    assert got["image"].shape == want["image"].shape
    assert got["label"].shape == want["label"].shape
    if not warped:
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["label"], want["label"])
        return
    far = np.abs(got["image"] - want["image"]) > 1 / 255 + 1e-6
    assert far.mean() <= IMG_SHARE, far.mean()
    assert (got["label"] != want["label"]).mean() <= LABEL_SHARE


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    make_cityscapes_tree(root)
    return root


@pytest.fixture(scope="module")
def ddd17_root(tmp_path_factory):
    from tests.test_datasets_integration import make_ddd17_dir

    root = str(tmp_path_factory.mktemp("ddd17"))
    make_ddd17_dir(root, n_masks=2, n_events=500)
    add_ddd17_frames(root, 2)
    return root


# ---------------------------------------------------------------- imgproc


@pytest.mark.parametrize("src,dst", [
    ((1024, 2048), (256, 512)), ((1024, 2048), (440, 640)),
    ((512, 1024), (256, 512)), ((260, 346), (260, 352)),
    ((128, 256), (256, 512)), ((37, 91), (100, 150)), ((100, 150), (37, 91))])
def test_resize_linear(src, dst):
    img = np.random.default_rng(src[0]).integers(0, 256, src).astype(np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(imgproc.resize_linear(img, *dst), want)
    np.testing.assert_array_equal(imgproc.resize_linear_ref(img, *dst), want)


def warp_draws(n, seed):
    """(image, label ids, affine map, corner jitter) as the augmentation
    draws them, at several sizes."""
    rng = np.random.default_rng(seed)
    for t in range(n):
        h, w = [(200, 352), (64, 96), (120, 216), (37, 53)][t % 4]
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        if t % 2:
            img = cv2.GaussianBlur(img, (0, 0), 2)
        label = rng.integers(0, 34, (h, w)).astype(np.uint8)
        scale = 1.0 + rng.uniform(0, 0.5)
        tx, ty = rng.uniform(-.1, .1) * w, rng.uniform(-.1, .1) * h
        m = np.array([[scale, 0, tx + (1 - scale) * w / 2],
                      [0, scale, ty + (1 - scale) * h / 2]], np.float32)
        s = rng.uniform(0.05, 0.1)
        src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
        dst = (src + rng.uniform(-s, s, (4, 2)).astype(np.float32)
               * [w, h]).astype(np.float32)
        yield img, label, m, src, dst


def within_one_level(got, want):
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 1
    return (d > 0).sum(), d.size


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_affine(seed):
    unequal = total = 0
    for img, label, m, _, _ in warp_draws(20, seed):
        h, w = img.shape
        kw = dict(borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR, **kw)
        n, size = within_one_level(imgproc.warp_affine(img, m, h, w), want)
        unequal, total = unequal + n, total + size
        want = cv2.warpAffine(label, m, (w, h), flags=cv2.INTER_NEAREST, **kw)
        np.testing.assert_array_equal(
            imgproc.warp_affine(label, m, h, w, nearest=True), want)
    assert unequal / total <= 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_perspective(seed):
    unequal = total = label_unequal = 0
    for img, label, _, src, dst in warp_draws(20, seed):
        h, w = img.shape
        want_m = cv2.getPerspectiveTransform(src, dst)
        m = imgproc.perspective_transform(src, dst)
        np.testing.assert_allclose(m, want_m, rtol=0, atol=1e-7)
        kw = dict(borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        want = cv2.warpPerspective(img, want_m, (w, h),
                                   flags=cv2.INTER_LINEAR, **kw)
        n, size = within_one_level(imgproc.warp_perspective(img, m, h, w),
                                   want)
        unequal, total = unequal + n, total + size
        want = cv2.warpPerspective(label, want_m, (w, h),
                                   flags=cv2.INTER_NEAREST, **kw)
        got = imgproc.warp_perspective(label, m, h, w, nearest=True)
        label_unequal += (got != want).sum()
    assert unequal / total <= 1e-3
    assert label_unequal / total <= 1e-4


@pytest.mark.parametrize("hw", [(200, 352), (64, 96), (7, 9)])
def test_blurs_and_filter(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.gaussian_blur(img),
                                  cv2.GaussianBlur(img, (0, 0), 1.0))
    np.testing.assert_array_equal(imgproc.box_blur3(img),
                                  cv2.blur(img, (3, 3)))
    for row in (True, False):
        k = np.zeros((3, 3), np.float32)
        if row:
            k[1, :] = 1 / 3
        else:
            k[:, 1] = 1 / 3
        np.testing.assert_array_equal(imgproc.filter2d3(img, k),
                                      cv2.filter2D(img, -1, k))


# ------------------------------------------------------------ whole samples


def recording(monkeypatch, cls, log):
    """Wrap ``cls._augment`` to append, per call, the state its generator
    ends in."""
    orig = cls._augment

    def augment(self, img, label, rng):
        out = orig(self, img, label, rng)
        log.append(rng.bit_generator.state["state"])
        return out

    monkeypatch.setattr(cls, "_augment", augment)


def counting_warps(monkeypatch, calls):
    for name in ("warp_affine", "warp_perspective"):
        orig = getattr(imgproc, name)

        def wrapped(*a, _orig=orig, **kw):
            calls.append(1)
            return _orig(*a, **kw)

        monkeypatch.setattr(imgproc, name, wrapped)


@pytest.mark.parametrize("augmentation", [True, False])
@pytest.mark.parametrize("mode,hw", [("random_crop", (200, 352)),
                                     ("full_frame", (440, 640))])
def test_cityscapes_matches_jax(monkeypatch, city_root, mode, hw,
                                augmentation):
    from ess_tpu.data.cityscapes import CityscapesGray as JaxCityscapesGray
    from ess_tpu_torch.data.cityscapes import CityscapesGray

    float32_corners(monkeypatch)
    want_draws, got_draws, warps = [], [], []
    recording(monkeypatch, JaxCityscapesGray, want_draws)
    recording(monkeypatch, CityscapesGray, got_draws)
    counting_warps(monkeypatch, warps)
    kw = dict(height=hw[0], width=hw[1], semseg_num_classes=6,
              augmentation=augmentation, random_crop=mode == "random_crop",
              seed=3)
    jax_set, port_set = (JaxCityscapesGray(city_root, **kw),
                         CityscapesGray(city_root, **kw))
    assert port_set.images == jax_set.images
    assert port_set.labels == jax_set.labels
    assert len(port_set) == SAMPLES
    n_warped = 0
    for _ in range(2):
        for i in range(SAMPLES):
            warps.clear()
            got, want = port_set[i], jax_set[i]
            assert got_draws == want_draws
            n_warped += bool(warps)
            check_sample(got, want, bool(warps))
    assert len(got_draws) == (2 * SAMPLES if augmentation else 0)
    if augmentation:
        assert n_warped > 0


def test_cityscapes_val_split_matches_jax(city_root):
    from ess_tpu.data.cityscapes import CityscapesGray as JaxCityscapesGray
    from ess_tpu_torch.data.cityscapes import CityscapesGray

    kw = dict(height=200, width=352, split="val", semseg_num_classes=11,
              augmentation=True, standardization=True)
    jax_set, port_set = (JaxCityscapesGray(city_root, **kw),
                         CityscapesGray(city_root, **kw))
    assert len(port_set) == len(jax_set) == 4
    for i in range(4):
        check_sample(port_set[i], jax_set[i], warped=False)


def test_jax_perspective_needs_float32_corners(city_root):
    """Unpatched, the JAX class's perspective augmentation raises in cv2
    for the samples that draw it; the port reads every sample."""
    from ess_tpu.data.cityscapes import CityscapesGray as JaxCityscapesGray
    from ess_tpu_torch.data.cityscapes import CityscapesGray

    kw = dict(height=200, width=352, augmentation=True, seed=3)
    jax_set, port_set = (JaxCityscapesGray(city_root, **kw),
                         CityscapesGray(city_root, **kw))
    refused = 0
    for i in range(SAMPLES):
        assert port_set[i]["image"].shape == (200, 352, 1)
        try:
            jax_set[i]
        except cv2.error as e:
            assert "getPerspectiveTransform" in str(e)
            refused += 1
    assert refused > 0


@pytest.mark.parametrize("split", ["train", "valid"])
def test_ddd17_gray_matches_jax(ddd17_root, split):
    from ess_tpu.data.ddd17_gray import DDD17Gray as JaxDDD17Gray
    from ess_tpu_torch.data.ddd17_gray import DDD17Gray

    jax_set, port_set = JaxDDD17Gray(ddd17_root, split), DDD17Gray(
        ddd17_root, split)
    assert port_set.pairs == jax_set.pairs
    assert len(port_set) == (10 if split == "train" else 2)
    for i in range(len(port_set)):
        got = port_set[i]
        assert got["image"].shape == (200, 352, 1)
        check_sample(got, jax_set[i], warped=False)


def test_concat_images_matches_jax(monkeypatch, city_root, ddd17_root):
    from ess_tpu.data.cityscapes import CityscapesGray as JaxCityscapesGray
    from ess_tpu.data.ddd17_gray import ConcatImages as JaxConcatImages
    from ess_tpu.data.ddd17_gray import DDD17Gray as JaxDDD17Gray
    from ess_tpu_torch.data.cityscapes import CityscapesGray
    from ess_tpu_torch.data.ddd17_gray import ConcatImages, DDD17Gray

    float32_corners(monkeypatch)
    warps = []
    counting_warps(monkeypatch, warps)
    kw = dict(height=200, width=352, augmentation=True, seed=5)
    want = JaxConcatImages(JaxCityscapesGray(city_root, **kw),
                           JaxDDD17Gray(ddd17_root))
    got = ConcatImages(CityscapesGray(city_root, **kw), DDD17Gray(ddd17_root))
    assert len(got) == len(want) == SAMPLES + 10
    for i in range(len(got)):
        warps.clear()
        g = got[i]
        check_sample(g, want[i], bool(warps))


_private_jax_native = pytest.fixture(scope="module")(use_private_jax_native)


def test_ddd17_events_paired_frame_matches_jax(ddd17_root,
                                               _private_jax_native):
    """The DDD17 event set's validation sample with its paired frame
    (``require_paired_data``): the frame read and resized without cv2
    equals the JAX set's at every pixel, as does the rest of the sample."""
    from ess_tpu.data.ddd17 import DDD17Events as JaxDDD17Events
    from ess_tpu_torch.data.ddd17 import DDD17Events

    kw = dict(split="valid", nr_events_data=2, nr_events_window=128,
              require_paired_data=True)
    got, want = DDD17Events(ddd17_root, **kw), JaxDDD17Events(ddd17_root,
                                                              **kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w) and g["image"].shape == (200, 352, 1)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_image_sets_load_no_cv2_or_pil(city_root, ddd17_root):
    """Reading augmented Cityscapes samples and DDD17 frames in a fresh
    interpreter loads neither cv2 nor PIL."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from ess_tpu_torch.data.cityscapes import CityscapesGray\n"
        "from ess_tpu_torch.data.ddd17_gray import DDD17Gray\n"
        f"c = CityscapesGray({city_root!r}, 200, 352, augmentation=True)\n"
        "for i in range(8): c[i]\n"
        f"DDD17Gray({ddd17_root!r})[0]\n"
        "bad = [m for m in ('cv2', 'PIL') if m in sys.modules]\n"
        "assert not bad, bad\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
