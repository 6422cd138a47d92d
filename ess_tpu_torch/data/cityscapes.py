"""Cityscapes grayscale still-image dataset (sensor A, host ingest).

Counterpart of ``ess_tpu/data/cityscapes.py``: ``leftImg8bit`` frames read
gray, ``gtFine`` label ids remapped to 6 or 11 train ids after augmentation
(geometric border fill, id 0, lands on ignore 255 through the lookup
table), in two geometry modes:

- ``random_crop`` (the DDD17 pairing): resize to 256x512, keep the top
  ``height`` rows, then augment and crop to (height, width), or centre-crop;
- full frame (the DSEC pairing): resize straight to (height, width).

The training augmentations, their order and their draws are the JAX
package's: the n-th access of a sample draws from
``np.random.default_rng((seed, index, n))`` and so draws what it draws there,
whatever thread reads it. The pixels go through
:mod:`ess_tpu_torch.data.png` and :mod:`ess_tpu_torch.data.imgproc`, not
cv2; their docstrings state each operation's bound against cv2. One
difference is deliberate: the perspective augmentation's target corners are
rounded to float32 before the map is solved, as ``cv2.getPerspectiveTransform``
requires (the JAX package passes float64 corners there, which cv2 refuses).
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Dict, List, Tuple

import numpy as np

from ess_tpu_torch.core import labels as labels_mod
from ess_tpu_torch.data import imgproc, png


class CityscapesGray:
    def __init__(
        self,
        root: str,
        height: int,
        width: int,
        split: str = "train",
        semseg_num_classes: int = 6,
        augmentation: bool = False,
        random_crop: bool = True,
        standardization: bool = False,
        seed: int = 6,
    ):
        self.height, self.width = height, width
        self.split = split
        self.num_classes = semseg_num_classes
        self.augmentation = augmentation
        self.random_crop = random_crop
        # per-image min-max rescale to the full 8-bit range
        self.standardization = standardization
        self.resize_hw: Tuple[int, int] = ((256, 512) if random_crop
                                           else (height, width))
        self.seed = seed
        # accesses of each index so far, for the per-(index, pass) generators
        self._pass_lock = threading.Lock()
        self._pass_count: dict = {}

        img_dir = os.path.join(root, "leftImg8bit", split)
        self.images: List[str] = sorted(
            glob.glob(os.path.join(img_dir, "*", "*_leftImg8bit.png")))
        if not self.images:
            raise FileNotFoundError(f"no Cityscapes images under {img_dir}")
        self.labels = [
            p.replace(os.sep + "leftImg8bit" + os.sep,
                      os.sep + "gtFine" + os.sep)
            .replace("_leftImg8bit.png", "_gtFine_labelIds.png")
            for p in self.images
        ]

    def __len__(self) -> int:
        return len(self.images)

    def _rng_for(self, index: int) -> np.random.Generator:
        with self._pass_lock:
            n = self._pass_count.get(index, 0)
            self._pass_count[index] = n + 1
        return np.random.default_rng((self.seed, index, n))

    def _augment(self, img: np.ndarray, label: np.ndarray,
                 rng: np.random.Generator):
        h, w = self.height, self.width

        if rng.random() < 0.5:  # HorizontalFlip
            img, label = img[:, ::-1], label[:, ::-1]

        if rng.random() < 0.5:  # ShiftScaleRotate(scale 0..0.5, shift 0.1)
            scale = 1.0 + rng.uniform(0.0, 0.5)
            shift_lim = 0.1 if self.random_crop else 0.0
            tx = rng.uniform(-shift_lim, shift_lim) * img.shape[1]
            ty = rng.uniform(-shift_lim, shift_lim) * img.shape[0]
            m = np.array([[scale, 0, tx + (1 - scale) * img.shape[1] / 2],
                          [0, scale, ty + (1 - scale) * img.shape[0] / 2]],
                         np.float32)
            size = img.shape[:2]
            img = imgproc.warp_affine(img, m, *size)
            label = imgproc.warp_affine(label, m, *size, nearest=True)

        # PadIfNeeded + RandomCrop to (h, w)
        ph, pw = max(h - img.shape[0], 0), max(w - img.shape[1], 0)
        if ph or pw:
            pad = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
            img, label = np.pad(img, pad), np.pad(label, pad)
        y0 = rng.integers(0, img.shape[0] - h + 1)
        x0 = rng.integers(0, img.shape[1] - w + 1)
        img = img[y0: y0 + h, x0: x0 + w]
        label = label[y0: y0 + h, x0: x0 + w]

        if rng.random() < 0.2:  # GaussNoise
            img = np.clip(
                img.astype(np.float32) + rng.normal(0, 10, img.shape), 0, 255
            ).astype(np.uint8)

        if rng.random() < 0.2:  # Perspective(scale 0.05..0.1)
            s = rng.uniform(0.05, 0.1)
            jitter = rng.uniform(-s, s, (4, 2)).astype(np.float32) * [w, h]
            src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
            m = imgproc.perspective_transform(
                src, (src + jitter).astype(np.float32))
            img = imgproc.warp_perspective(img, m, h, w)
            label = imgproc.warp_perspective(label, m, h, w, nearest=True)

        if rng.random() < 0.5:  # RandomBrightnessContrast
            alpha = 1.0 + rng.uniform(-0.2, 0.2)
            beta = rng.uniform(-0.2, 0.2) * 255
            img = np.clip(img.astype(np.float32) * alpha + beta, 0,
                          255).astype(np.uint8)

        if rng.random() < 0.5:  # OneOf(Sharpen, Blur, MotionBlur)
            choice = rng.integers(0, 3)
            if choice == 0:
                blur = imgproc.gaussian_blur(img)
                img = np.clip(
                    img.astype(np.float32) * 1.5
                    - blur.astype(np.float32) * 0.5, 0, 255).astype(np.uint8)
            elif choice == 1:
                img = imgproc.box_blur3(img)
            else:
                k = np.zeros((3, 3), np.float32)
                if rng.random() < 0.5:
                    k[1, :] = 1 / 3
                else:
                    k[:, 1] = 1 / 3
                img = imgproc.filter2d3(img, k)

        return img, label

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = png.imread_gray(self.images[idx])
        label = png.imread_gray(self.labels[idx])
        rh, rw = self.resize_hw
        img = imgproc.resize_linear(img, rh, rw)
        label = png.resize_nearest(label, rh, rw)

        if self.standardization:
            lo, hi = int(img.min()), int(img.max())
            img = (255.0 * (img.astype(np.float32) - lo)
                   / max(hi - lo, 1)).astype(np.uint8)

        train_aug = self.augmentation and self.split == "train"
        if self.random_crop:
            img, label = img[: self.height], label[: self.height]
            if train_aug:
                img, label = self._augment(img, label, self._rng_for(idx))
            else:  # centre crop to (height, width)
                x0 = max((img.shape[1] - self.width) // 2, 0)
                img = img[:, x0: x0 + self.width]
                label = label[:, x0: x0 + self.width]
        elif train_aug:
            img, label = self._augment(img, label, self._rng_for(idx))

        label = labels_mod.id_to_train_id(label, self.num_classes)
        return {
            "image": (img.astype(np.float32) / 255.0)[..., None],
            "label": label.astype(np.uint8),
        }
