"""Frame assembly for a live display of reconstructed frames.

Counterpart of ``ess_tpu/recon/display.py``: ``make_event_preview`` (the
red-blue BGR or grayscale preview of a voxel grid) and ``ImageDisplay``
(outer-border crop, the event preview hstacked left of the frame), pure
numpy. The port has no window: JAX's ``ImageDisplay(display=True)`` opens
a cv2 window and ``__call__`` shows a frame in it; the port never imports
cv2, so ``display=True`` raises and there is no ``__call__``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def make_event_preview(events_chw: np.ndarray, mode: str = "red-blue",
                       num_bins_to_show: int = -1) -> np.ndarray:
    """(C, H, W) voxel grid -> uint8 preview of the sum over its last
    ``num_bins_to_show`` bins (all with -1): ``'red-blue'`` (H, W, 3) BGR,
    positive sums blue and negative red; ``'grayscale'`` (H, W), the sum
    over [-10, 10] mapped to [0, 255]."""
    assert mode in ("red-blue", "grayscale")
    bins = (events_chw if num_bins_to_show < 0
            else events_chw[-num_bins_to_show:])
    sum_events = np.sum(bins, axis=0)
    if mode == "red-blue":
        prev = np.zeros(sum_events.shape + (3,), np.uint8)
        prev[:, :, 0][sum_events > 0] = 255
        prev[:, :, 2][sum_events < 0] = 255
        return prev
    m, big = -10.0, 10.0
    return np.clip((255.0 * (sum_events - m) / (big - m)).astype(np.uint8),
                   0, 255)


class ImageDisplay:
    """The frames of a reconstruction stream as a display would show them
    (:meth:`compose`); ``display=True`` raises: the port has no window."""

    def __init__(self, *, display: bool = False, show_events: bool = False,
                 event_display_mode: str = "red-blue",
                 num_bins_to_show: int = -1, border: int = 0):
        if display:
            raise RuntimeError("ImageDisplay(display=True) is not ported: "
                               "the port has no cv2 window")
        self.show_events = show_events
        self.event_display_mode = event_display_mode
        self.num_bins_to_show = num_bins_to_show
        self.border = border

    def crop_outer_border(self, img: np.ndarray) -> np.ndarray:
        b = self.border
        return img if b == 0 else img[b:-b, b:-b]

    def compose(self, img: np.ndarray,
                events_chw: Optional[np.ndarray] = None) -> np.ndarray:
        """The shown frame: ``img`` with its border cropped, and with
        ``show_events`` the cropped event preview of ``events_chw`` to its
        left (a gray side stacked to three channels where the other has
        them)."""
        img = self.crop_outer_border(img)
        if not self.show_events:
            return img
        assert events_chw is not None
        preview = self.crop_outer_border(make_event_preview(
            events_chw, mode=self.event_display_mode,
            num_bins_to_show=self.num_bins_to_show))
        if preview.ndim == 3 and img.ndim == 2:
            img = np.dstack([img] * 3)
        elif img.ndim == 3 and preview.ndim == 2:
            preview = np.dstack([preview] * 3)
        return np.hstack([preview, img])
