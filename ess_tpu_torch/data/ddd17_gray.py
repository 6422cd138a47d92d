"""DDD17 grayscale-frame image dataset (sensor-A variant).

Counterpart of ``ess_tpu/data/ddd17_gray.py``: (image, label) pairs from the
grayscale frames in each DDD17 recording's ``imgs/`` directory beside its
``segmentation_masks/``, for image-domain training on DDD17's own frames,
and :class:`ConcatImages`, which joins it to ``CityscapesGray`` for the
'DDD17_Cityscapes_gray' image domain. Frames and masks are read and resized
by :mod:`ess_tpu_torch.data.png` and :mod:`ess_tpu_torch.data.imgproc`, not
cv2.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from ess_tpu_torch.data import imgproc, png
from ess_tpu_torch.data.ddd17 import (
    RESIZED_SHAPE, SENSOR_SHAPE, get_split_dirs)


class DDD17Gray:
    """(image, label) pairs from DDD17 recordings' grayscale frames."""

    def __init__(self, root: str, split: str = "train",
                 height: int = RESIZED_SHAPE[0],
                 width: int = RESIZED_SHAPE[1]):
        data_dirs = sorted(glob.glob(os.path.join(root, "dir*")))
        if not data_dirs:
            raise FileNotFoundError(f"no DDD17 'dir*' folders under {root}")
        self.height, self.width = height, width
        self.pairs: List[tuple[str, str]] = []
        for d in get_split_dirs(data_dirs, split):
            for mask in sorted(glob.glob(
                    os.path.join(d, "segmentation_masks", "*.png"))):
                fid = os.path.basename(mask).split("_")[-1]
                for name in (f"img_{fid}", fid.zfill(14)):
                    img = os.path.join(d, "imgs", name)
                    if os.path.exists(img):
                        self.pairs.append((img, mask))
                        break
        if not self.pairs:
            raise FileNotFoundError(
                "no paired DDD17 frames found (imgs/ missing?)")

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_path, mask_path = self.pairs[idx]
        img = png.imread_gray(img_path)
        label = png.imread_gray(mask_path)
        # the event branch's geometry: 352 wide, the 60 bottom rows cropped
        img = imgproc.resize_linear(img, SENSOR_SHAPE[0],
                                    self.width)[: self.height]
        label = png.resize_nearest(label, self.height, self.width)
        return {
            "image": (img.astype(np.float32) / 255.0)[..., None],
            "label": label.astype(np.uint8),
        }


class ConcatImages:
    """Concatenate image datasets (the 'DDD17_Cityscapes_gray' mix)."""

    def __init__(self, *datasets):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        di = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[di][idx - int(self._offsets[di])]
