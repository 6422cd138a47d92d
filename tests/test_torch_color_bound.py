"""The bound of ``chip_smoke.py`` phase 5f's color check:
``recon/color.py::merge_move_bound``, the largest move of a merged color
value that a one-level move of one value of the frames the merge reads
can cause.

The full scan (all 2^24 BGR triples, every gray level; ~8 s on one CPU
core) reads 38 levels for a one-level move of B, G or R and 10 for one of
the gray level, the resize and the G/W mean each moving a value by at
most one level. The chip smoke runs the full scan; this test scans the
triples with B >= 224, an eighth of them, whose maxima equal the full
scan's (both 38 and 10, checked against the full scan).
"""

import numpy as np

from ess_tpu_torch.data.imgproc import resize_linear
from ess_tpu_torch.recon import color
import pytest


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


FULL_SCAN = {"resize": 1, "green": 1, "color": 38, "gray": 10, "bound": 38}


def test_merge_move_bound():
    assert color.merge_move_bound(b_min=224) == FULL_SCAN


def test_one_level_moves_through_the_merge():
    """Seeded frames with one value of one input frame moved by one level:
    no merged value moves by more than the bound, and the merge's first
    steps move one of B, G, R by at most one level."""
    rng = np.random.default_rng(5)
    worst = 0
    for trial in range(24):
        ch = {k: rng.integers(0, 256, (6, 8), np.uint8)
              for k in ("R", "G", "W", "B")}
        ch["grayscale"] = rng.integers(0, 256, (12, 16), np.uint8)
        key = ("R", "G", "W", "B", "grayscale")[trial % 5]
        moved = {k: v.copy() for k, v in ch.items()}
        y, x = (rng.integers(0, n) for n in moved[key].shape)
        v = moved[key][y, x]
        moved[key][y, x] = v + 1 if v < 255 else v - 1
        if key != "grayscale":
            up = resize_linear(ch[key], 12, 16).astype(np.int16)
            assert np.abs(up - resize_linear(moved[key], 12, 16)).max() <= 1
        a = color.merge_channels_into_color_image(ch).astype(np.int16)
        b = color.merge_channels_into_color_image(moved)
        worst = max(worst, int(np.abs(a - b).max()))
    assert 0 < worst <= FULL_SCAN["bound"]
