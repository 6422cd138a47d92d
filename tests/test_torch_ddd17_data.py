"""The port's DDD17 host event path against the JAX package's, on trees
written by ``tests.test_datasets_integration.make_ddd17_dir``.

``DDD17EventStore`` (memmaps and image index), ``window_for_image``,
``native.pad_windows_ddd17`` and ``DDD17Events`` (the directory split, both
window modes, the squeeze-resized label, the ``'folded'`` integer band
binning at 5 and 10 bins and the ``'tile'`` binning) give arrays equal to
the JAX package's. The masks are PNGs read with ``cv2``, which this test
machine has and the H100 machine does not: the mask read is checked on the
CPU only, and the event path without it (``events_for_image``) is what
``chip_smoke.py`` drives on the card.
"""

import numpy as np
import pytest

from ess_tpu.data import native as jax_native
from ess_tpu.data.ddd17 import DDD17Events as JaxDDD17Events
from ess_tpu.data.slicer import DDD17EventStore as JaxStore

from ess_tpu_torch.data import native
from ess_tpu_torch.data.ddd17 import (DDD17Events, chunk_bounds,
                                      events_for_image, get_split_dirs)
from ess_tpu_torch.data.slicer import DDD17EventStore
from tests.test_datasets_integration import make_ddd17_dir
from tests.test_torch_host_bin import use_private_jax_native


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("ddd17")
    make_ddd17_dir(str(root), n_masks=2, n_events=6000)
    return str(root)


def assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_store_and_windows_match_jax(tree):
    d = sorted(get_split_dirs([f"{tree}/dir{i}" for i in range(7)],
                              "train"))[0]
    got, want = DDD17EventStore.open(d), JaxStore.open(d)
    np.testing.assert_array_equal(got.img_index, want.img_index)
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(want.t))
    np.testing.assert_array_equal(np.asarray(got.xyp), np.asarray(want.xyp))
    for fixed in (False, True):
        np.testing.assert_array_equal(
            got.window_for_image(1, fixed_duration=fixed, nr_events=700),
            want.window_for_image(1, fixed_duration=fixed, nr_events=700))
    starts, ends = chunk_bounds(got, 1, nr_events_data=3,
                                nr_events_window=400, fixed_duration=True)
    for a, b in zip(native.pad_windows_ddd17(got.t, got.xyp, starts, ends,
                                             300),
                    jax_native.pad_windows_ddd17(want.t, want.xyp, starts,
                                                 ends, 300)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split,fixed,binning,bins", [
    ("train", False, "folded", 5), ("valid", True, "folded", 5),
    ("train", False, "folded", 10), ("test", False, "tile", 5),
    ("train", True, "tile", 10)])
def test_dataset_matches_jax(tree, split, fixed, binning, bins):
    kw = dict(split=split, nr_events_data=4, nr_events_window=512,
              fixed_duration=fixed, tile_bins=bins, binning=binning)
    got, want = DDD17Events(tree, **kw), JaxDDD17Events(tree, **kw)
    assert got.files == want.files and len(got) == len(want) > 0
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i])
    s = got[0]
    assert s["label"].shape == (200, 352)
    assert s["raw_events"].shape[:2] == (4, 512)


def test_paired_frame_and_raw_windows_match_jax(tree):
    """The validation split with paired data (the fixture writes no frame,
    so only ``label_original`` is added) and the unbinned windows."""
    kw = dict(split="valid", nr_events_data=2, nr_events_window=256,
              require_paired_data=True, tile_bin=False)
    got, want = DDD17Events(tree, **kw)[0], JaxDDD17Events(tree, **kw)[0]
    assert "label_original" in got and "image" not in got
    assert_samples_equal(got, want)


def test_events_for_image_needs_no_png(tree):
    """The event path alone: a store, an image index and the binning."""
    store = DDD17EventStore.open(f"{tree}/dir0")
    out = events_for_image(store, 0, nr_events_data=3, nr_events_window=200)
    assert out["raw_events"].shape == (3, 200, 4)
    assert out["band_offsets"].shape == (3, 11 * 3 + 1)
    with pytest.raises(ValueError):
        events_for_image(store, 0, binning="packed")
