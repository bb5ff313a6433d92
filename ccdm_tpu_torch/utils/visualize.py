"""Qualitative prediction grids -> PNG (a copy of `ccdm_tpu/utils/visualize.py`
that writes with `utils/png.py`).

Parity: `grid_of_predictions` + vendored `save_image`
(`ddpm/trainer.py:76-133,569-579`): for a few validation images, render rows
of [condition | ground truth | N sampled segmentations]. Pure NumPy.
"""

from __future__ import annotations

import os

import numpy as np

from ccdm_tpu_torch.data.cityscapes_labels import decode_target_to_color
from ccdm_tpu_torch.utils.png import write_png


def class_map_to_rgb(class_map: np.ndarray, num_classes: int) -> np.ndarray:
    """[H,W] int -> [H,W,3] uint8. Cityscapes palette for 20 classes,
    grayscale ramp otherwise (parity intent: `_onehot_to_color_image`,
    `ddpm/utils.py:95-125`)."""
    if num_classes == 20:
        return decode_target_to_color(class_map).astype(np.uint8)
    scale = 255 // max(num_classes - 1, 1)
    g = (class_map.astype(np.int32) * scale).clip(0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def image_to_rgb(img: np.ndarray) -> np.ndarray:
    """[H,W,C] float (roughly [-1,1] or [0,1]) -> [H,W,3] uint8."""
    x = np.asarray(img, dtype=np.float32)
    lo, hi = float(x.min()), float(x.max())
    if lo < -0.01:  # symmetric range
        x = (x + 1.0) / 2.0
    elif hi > 1.5:
        x = x / 255.0
    x = np.clip(x, 0, 1)
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return (x[..., :3] * 255 + 0.5).astype(np.uint8)


def prediction_grid(
    images: np.ndarray,       # [N,H,W,C]
    labels: np.ndarray,       # [N,H,W] int
    predictions: np.ndarray,  # [N,S,H,W] int
    num_classes: int,
    pad: int = 2,
) -> np.ndarray:
    """Rows: one per image -> [condition | label | S predictions], uint8 RGB."""
    n, s = predictions.shape[:2]
    h, w = labels.shape[1:3]
    cols = 2 + s
    grid = np.full((n * (h + pad) + pad, cols * (w + pad) + pad, 3), 255, np.uint8)

    def paste(r, c, tile):
        y, x = pad + r * (h + pad), pad + c * (w + pad)
        grid[y:y + h, x:x + w] = tile

    for i in range(n):
        paste(i, 0, image_to_rgb(images[i]))
        paste(i, 1, class_map_to_rgb(labels[i], num_classes))
        for j in range(s):
            paste(i, 2 + j, class_map_to_rgb(predictions[i, j], num_classes))
    return grid


def save_grid(grid: np.ndarray, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_png(path, grid)
