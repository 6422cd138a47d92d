"""Visualization helpers (host-side numpy).

Counterpart of ``ess_tpu/utils/viz.py``: event-tensor -> red/blue RGB
previews, voxel-grid previews, semseg colorization with a checkerboard for
ignore pixels, image grids, latent PCA images, embedding dumps,
confusion-matrix figures, bounding boxes, flow and disparity images, and
parameter counts. Latents are the port's channel-first ones; matplotlib and
``cv2`` are imported only inside the functions that draw with them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def event_histogram_rgb(hist_2hw: np.ndarray) -> np.ndarray:
    """2-channel (neg, pos) histogram -> HWC RGB (pos=red, neg=blue),
    matching viz_utils.createRGBImage's histogram branch."""
    neg, pos = hist_2hw[0], hist_2hw[1]
    h, w = pos.shape
    rgb = np.zeros((h, w, 3), np.float32)
    rgb[..., 0] = np.clip(pos, 0, 1)
    rgb[..., 2] = np.clip(neg, 0, 1)
    return rgb


def voxel_grid_rgb(grid_chw: np.ndarray) -> np.ndarray:
    """Voxel grid -> temporal-colored polarity preview (viz_utils.py:55-99
    spirit: sum of bins scaled into red/blue by sign)."""
    s = grid_chw.sum(axis=0)
    m = max(np.abs(s).max(), 1e-6)
    h, w = s.shape
    rgb = np.zeros((h, w, 3), np.float32)
    rgb[..., 0] = np.clip(s / m, 0, 1)
    rgb[..., 2] = np.clip(-s / m, 0, 1)
    return rgb


def colorize_semseg(
    labels_hw: np.ndarray, color_map: np.ndarray, ignore_label: int = 255,
    checker: int = 4,
) -> np.ndarray:
    """trainId map -> RGB; ignore pixels get a gray checkerboard
    (viz_utils.prepare_semseg semantics)."""
    h, w = labels_hw.shape
    out = np.zeros((h, w, 3), np.uint8)
    valid = labels_hw != ignore_label
    safe = np.where(valid, labels_hw, 0).astype(np.int64)
    safe = np.clip(safe, 0, len(color_map) - 1)
    out[...] = color_map[safe]
    yy, xx = np.mgrid[0:h, 0:w]
    checkerboard = (((yy // checker) + (xx // checker)) % 2) * 64 + 96
    for c in range(3):
        out[..., c] = np.where(valid, out[..., c], checkerboard.astype(np.uint8))
    return out


def make_grid(images: Sequence[np.ndarray], nrow: int = 4,
              pad: int = 2) -> np.ndarray:
    """Tile HWC images into a grid (torchvision.utils.make_grid analogue)."""
    imgs = [np.asarray(im) for im in images]
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    ncol = nrow
    nrows = math.ceil(len(imgs) / ncol)
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, 3),
                    imgs[0].dtype)
    for i, im in enumerate(imgs):
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=-1)
        if im.shape[-1] == 1:
            im = np.repeat(im, 3, axis=-1)
        r, c = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + c * (w + pad)
        grid[y0: y0 + im.shape[0], x0: x0 + im.shape[1]] = im
    return grid


def latent_pca_rgb(latent_chw: np.ndarray) -> np.ndarray:
    """Project a (C, H, W) latent onto its top-3 PCA components as an
    (H, W, 3) RGB image: PCA over spatial positions, min-max scaled per
    channel (the JAX function on the same latent in HWC)."""
    c, h, w = latent_chw.shape
    flat = np.moveaxis(np.asarray(latent_chw), 0, -1).reshape(-1, c)
    flat = flat.astype(np.float64)
    flat = flat - flat.mean(axis=0)
    # top-3 principal directions via SVD of the (pixels, C) matrix
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T  # (pixels, 3)
    proj = proj.reshape(h, w, 3)
    lo = proj.min(axis=(0, 1), keepdims=True)
    hi = proj.max(axis=(0, 1), keepdims=True)
    return ((proj - lo) / np.clip(hi - lo, 1e-12, None)).astype(np.float32)


def embedding_dump(latents: np.ndarray, labels: Optional[np.ndarray],
                   path: str) -> None:
    """Write (N, D) embeddings (+ labels) as TSV for projector tools —
    TensorBoard's projector reads."""
    np.savetxt(path, latents.reshape(len(latents), -1), delimiter="\t", fmt="%.5f")
    if labels is not None:
        with open(path + ".labels.tsv", "w") as f:
            for l in labels:
                f.write(f"{l}\n")


def confusion_matrix_figure(cm: np.ndarray, class_names: Sequence[str],
                            normalize: bool = True):
    """matplotlib figure of a confusion matrix (viz_utils.py:148-182).
    Returns None when matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    cm = np.asarray(cm, np.float64)
    if normalize:
        cm = cm / np.clip(cm.sum(axis=1, keepdims=True), 1e-12, None)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(cm, interpolation="nearest", cmap="Blues")
    ax.set_xticks(range(len(class_names)))
    ax.set_yticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=45, ha="right")
    ax.set_yticklabels(class_names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    thresh = cm.max() / 2 if cm.size else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:.2f}", ha="center",
                    color="white" if cm[i, j] > thresh else "black",
                    fontsize=7)
    fig.tight_layout()
    return fig


def draw_bounding_box(
    image: np.ndarray, box: Sequence[int], *,
    class_name: Optional[str] = None, ground_truth: bool = False,
) -> np.ndarray:
    """Draw one [y, x, height, width] box outline in an (H, W, 3) image.

    As the DSEC dataset tooling's ``drawBoundingBox``: cyan for ground
    truth, magenta for predictions; the optional class label is rendered
    via cv2 when available (gated import — label text is cosmetic).
    """
    img = image.astype(np.float32).copy()
    color = np.array([0.0, 1.0, 1.0] if ground_truth else [1.0, 0.0, 1.0],
                     np.float32)
    y, x, h, w = (int(v) for v in box[:4])
    y2, x2 = min(y + h, img.shape[0] - 1), min(x + w, img.shape[1] - 1)
    img[y, x:x2] = color
    img[y:y2, x2] = color
    img[y2, x:x2] = color
    img[y:y2, x] = color
    if class_name:
        try:
            import cv2
            cv2.putText(img, class_name, (x + 1, y2 - 2),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1,
                        cv2.LINE_AA)
        except Exception:
            pass  # text overlay is cosmetic; the box itself is drawn
    return img


def draw_bounding_boxes(
    image: np.ndarray, boxes: np.ndarray, *,
    class_names: Optional[Sequence[str]] = None, ground_truth: bool = True,
) -> np.ndarray:
    """Draw [y, x, height, width] boxes until the first all-zero row
    (drawBoundingBoxes, DSEC/utils/viz_utils.py:105-128 semantics)."""
    img = image.astype(np.float32)
    for i, box in enumerate(np.asarray(boxes)):
        if np.sum(box) == 0:
            break
        img = draw_bounding_box(
            img, box, class_name=class_names[i] if class_names else None,
            ground_truth=ground_truth)
    return img


def flow_rgb(flow_n2hw: np.ndarray) -> np.ndarray:
    """(N, 2, H, W) flow maps -> (N, 3, H, W) float RGB in [0, 1].

    HSV direction/magnitude encoding matching visualizeFlow
    (DSEC/utils/viz_utils.py:171-188): hue = angle, value = per-sample
    min-max-normalized magnitude, full saturation — in pure numpy (no cv2
    dependency; colorsys-equivalent HSV->RGB math).
    """
    flow = np.asarray(flow_n2hw, np.float32)
    n, _, h, w = flow.shape
    out = np.zeros((n, 3, h, w), np.float32)
    for i in range(n):
        fx, fy = flow[i, 0], flow[i, 1]
        mag = np.hypot(fx, fy)
        ang = np.arctan2(fy, fx) % (2 * np.pi)
        hue = ang / (2 * np.pi) * 6.0                       # [0, 6)
        lo, hi = float(mag.min()), float(mag.max())
        v = (mag - lo) / (hi - lo) if hi > lo else np.zeros_like(mag)
        c = v                                               # s = 1
        ximg = c * (1.0 - np.abs(hue % 2.0 - 1.0))
        z = np.zeros_like(c)
        sector = np.floor(hue).astype(np.int32) % 6
        rgb = np.select(
            [sector == 0, sector == 1, sector == 2,
             sector == 3, sector == 4, sector == 5],
            [np.stack([c, ximg, z]), np.stack([ximg, c, z]),
             np.stack([z, c, ximg]), np.stack([z, ximg, c]),
             np.stack([ximg, z, c]), np.stack([c, z, ximg])])
        out[i] = rgb
    return out


def disparity_rgb(disp_hw: np.ndarray, *, max_disp: float = 80.0) -> np.ndarray:
    """(H, W) disparity map -> (H, W, 3) uint8 RGB via the inferno colormap.

    As the DSEC tooling's ``disp_img_to_rgb_img``: pixels with
    disparity <= 0 stay black; positive disparities normalize to
    [0, max_disp] (clipped) and map through matplotlib's inferno. The
    reference converts RGB->BGR for cv2.imshow at the end; we keep RGB (the
    writers here consume RGB) — byte-identical per channel otherwise.
    Falls back to a grayscale ramp when matplotlib is unavailable.
    """
    disp = np.asarray(disp_hw, np.float64)
    mask = disp > 0
    norm = np.clip(disp / max_disp, 0.0, 1.0)
    try:
        import matplotlib
        rgb = matplotlib.colormaps["inferno"](norm)[..., :3]
    except (ImportError, AttributeError, KeyError):  # pragma: no cover
        rgb = np.repeat(norm[..., None], 3, axis=-1)
    out = np.zeros(disp.shape + (3,), np.float64)
    out[mask] = rgb[mask]
    return (255 * out).astype(np.uint8)


def disparity_overlay(image_1c: np.ndarray, disp_rgb: np.ndarray,
                      *, alpha: float = 0.1) -> np.ndarray:
    """Blend a grayscale image under a disparity RGB map (uint8).

    get_disp_overlay semantics (DSEC/dataset/visualization.py:29-32):
    ``alpha * image + (1 - alpha) * disp_rgb`` with cv2.addWeighted's
    round-half-away-from-zero saturating arithmetic.
    """
    img = np.repeat(np.asarray(image_1c, np.float64)[..., None], 3, axis=-1)
    out = alpha * img + (1.0 - alpha) * np.asarray(disp_rgb, np.float64)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def count_params(source) -> int:
    """Total element count of an ``nn.Module``'s parameters, or of a state
    dict's tensors."""
    tensors = (source.parameters() if hasattr(source, "parameters")
               else source.values())
    return sum(int(np.prod(tuple(t.shape))) for t in tensors)
