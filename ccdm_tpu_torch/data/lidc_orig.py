"""LIDC-IDRI v2: PNG-folder variant (HPU-Net crop release); a copy of
`ccdm_tpu/data/lidc_orig.py` that reads its PNGs with `utils/png.py`.

Layout parity with `datasets/lidc_orig.py:84-156`:
`$CCDM_LIDC_ORIG_PATH/lidc_crops_{split}/{split}/{images,gt}/*/*.png`, with 4
ground-truth PNGs per image (sorted file list reshaped `[N, 4]`). Transform
parity (`lidc_orig.py:57-81,131-142`): labels `/255`, one-hot; image
`to_tensor` (/255) then center-crop 128 and `*2 - 1`; training additionally
flips (p=.5 each) and rotates k*90.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ccdm_tpu_torch.utils.png import read_png

NUM_CLASSES = 2
BACKGROUND_CLASS = None
RESOLUTION = 128


def default_base_path() -> str:
    return os.environ.get("CCDM_LIDC_ORIG_PATH", os.path.expanduser("~/data/LIDC"))


def _file_lists(split: str, base: Optional[str] = None):
    base = base or default_base_path()
    root = os.path.join(base, f"lidc_crops_{split}", split)
    images = sorted(glob.glob(os.path.join(root, "images", "*", "*.png")))
    gts = np.array(sorted(glob.glob(os.path.join(root, "gt", "*", "*.png"))))
    if not images:
        raise FileNotFoundError(f"no LIDC crops under {root!r}; set $CCDM_LIDC_ORIG_PATH")
    return images, gts.reshape((len(images), 4), order="C")  # lidc_orig.py:88


def _read(path: str) -> np.ndarray:
    return read_png(path)


def _center_crop(arr: np.ndarray, size: int = RESOLUTION) -> np.ndarray:
    h, w = arr.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return arr[top:top + size, left:left + size]


def _prep_image(raw: np.ndarray) -> np.ndarray:
    img = raw.astype(np.float32) / 255.0
    img = _center_crop(img)[..., None]
    return img * 2.0 - 1.0  # lidc_orig.py:67,141


def _prep_mask(raw: np.ndarray) -> np.ndarray:
    lbl = (raw.astype(np.float32) / 255.0).astype(np.int64)
    return _center_crop(lbl)


class LIDCOrigTrain:
    def __init__(self, images, gts):
        self.image_files = images
        self.gt_files = gts

    def __len__(self):
        return len(self.image_files)

    def get(self, index: int, rng: np.random.Generator):
        img = _prep_image(_read(self.image_files[index]))
        lbl = _prep_mask(_read(self.gt_files[index, int(rng.integers(0, 4))]))
        if rng.random() < 0.5:
            img, lbl = img[:, ::-1], lbl[:, ::-1]
        if rng.random() < 0.5:
            img, lbl = img[::-1, :], lbl[::-1, :]
        k = int(rng.integers(0, 4))
        img, lbl = np.rot90(img, k, axes=(0, 1)), np.rot90(lbl, k, axes=(0, 1))
        x0 = np.eye(NUM_CLASSES, dtype=np.float32)[np.ascontiguousarray(lbl)]
        return {"image": np.ascontiguousarray(img, dtype=np.float32), "x0": x0}


class LIDCOrigTest:
    def __init__(self, images, gts, indices=None):
        self.image_files = images
        self.gt_files = gts
        self.indices = np.arange(len(images)) if indices is None else np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def get(self, index: int, rng=None):
        i = int(self.indices[index])
        img = _prep_image(_read(self.image_files[i]))
        labels = np.stack([
            np.eye(NUM_CLASSES, dtype=np.float32)[_prep_mask(_read(self.gt_files[i, a]))]
            for a in range(4)
        ])
        return {"image": img, "labels": labels,
                "likelihoods": np.full((4,), 0.25, dtype=np.float32)}


def training_dataset(base_path: Optional[str] = None) -> LIDCOrigTrain:
    return LIDCOrigTrain(*_file_lists("train", base_path))


def _subset(ds: LIDCOrigTest, max_size: Optional[int]) -> LIDCOrigTest:
    if not max_size or max_size >= len(ds):
        return ds
    perm = np.random.default_rng(1).permutation(len(ds))[:max_size]
    return LIDCOrigTest(ds.image_files, ds.gt_files, indices=perm)


def validation_dataset(max_size: Optional[int] = None, base_path: Optional[str] = None) -> LIDCOrigTest:
    return _subset(LIDCOrigTest(*_file_lists("val", base_path)), max_size)


def test_dataset(max_size: Optional[int] = None, base_path: Optional[str] = None) -> LIDCOrigTest:
    return _subset(LIDCOrigTest(*_file_lists("test", base_path)), max_size)


def get_num_classes() -> int:
    return NUM_CLASSES


def get_ignore_class():
    return BACKGROUND_CLASS


def is_multi_annotator() -> bool:
    """Test samples carry all 4 expert masks (dataset-module protocol flag
    used by the GED-vs-mIoU evaluation dispatch)."""
    return True
