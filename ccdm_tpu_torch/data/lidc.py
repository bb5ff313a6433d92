"""LIDC-IDRI v1: HDF5-backed multi-annotator lung-nodule dataset (a copy of
`ccdm_tpu/data/lidc.py`, held equal to it by `tests/test_torch_trainer.py`).

Schema parity with the reference (`datasets/lidc.py:86-90`): one HDF5 file
with `train`/`val`/`test` groups, each holding `images [N,128,128]` float in
[-0.5, 0.5], `labels [N,4,128,128]` uint8 (4 expert masks), `uids [N]`.

Sample protocol parity:
- training (`lidc.py:100-148`): pick one of the 4 annotator masks uniformly,
  random h/v flip (p=.5 each), random k*90-degree rotation, image scaled by 2
  to [-1, 1]; returns `(image [H,W,1] f32, x0 one-hot [H,W,2] f32)`
- val/test (`lidc.py:177-210`): all 4 expert masks one-hot `[4,H,W,2]` plus
  uniform likelihoods `[.25]*4`; image *2; val subset is a seeded random
  split, test subset the first `max_size` items

The file path comes from `$CCDM_LIDC_PATH` (the reference hard-codes
host-specific paths, `lidc.py:16-21`). Everything is NumPy on the host; the
device only ever sees stacked channels-last batches.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

NUM_CLASSES = 2
RESOLUTION = 128
BACKGROUND_CLASS = None  # lidc.py:25 — no ignore class


def default_file_path() -> str:
    return os.environ.get("CCDM_LIDC_PATH", os.path.expanduser("~/data/data_lidc.hdf5"))


def _open_group(split: str, file_path: Optional[str] = None):
    path = file_path or default_file_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LIDC HDF5 file not found at {path!r}; set $CCDM_LIDC_PATH "
            "(schema: train/val/test groups with images/labels/uids)")
    import h5py  # only where a file is read: the card's machine has no h5py

    return h5py.File(path, "r")[split]


def one_hot(labels: np.ndarray, num_classes: int = NUM_CLASSES) -> np.ndarray:
    return np.eye(num_classes, dtype=np.float32)[labels.astype(np.int64)]


def train_transform(image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
    """Flips, k*90 rotation, image*2 (parity: `lidc.py:128-148`), channels-last."""
    img = image.astype(np.float32)
    lbl = label.astype(np.int64)
    if rng.random() < 0.5:
        img, lbl = img[:, ::-1], lbl[:, ::-1]  # hflip
    if rng.random() < 0.5:
        img, lbl = img[::-1, :], lbl[::-1, :]  # vflip
    k = int(rng.integers(0, 4))
    img, lbl = np.rot90(img, k), np.rot90(lbl, k)
    img = np.ascontiguousarray(img)[..., None] * 2.0
    return img.astype(np.float32), one_hot(np.ascontiguousarray(lbl))


class LIDCTrain:
    """Training view: one random annotator per fetch + augmentation."""

    def __init__(self, group, seed: int = 0):
        self.images = group["images"]
        self.labels = group["labels"]
        self._base_seed = seed

    def __len__(self):
        return len(self.images)

    def get(self, index: int, rng: np.random.Generator):
        image = np.asarray(self.images[index], dtype=np.float32)
        annotator = int(rng.integers(0, 4))  # lidc.py:102
        label = np.asarray(self.labels[index][annotator])
        img, x0 = train_transform(image, label, rng)
        return {"image": img, "x0": x0}


class LIDCTest:
    """Eval view: all four expert masks + uniform likelihoods (`lidc.py:177-198`)."""

    def __init__(self, group, indices: Optional[np.ndarray] = None):
        self.images = group["images"]
        self.labels = group["labels"]
        self.indices = np.arange(len(self.images)) if indices is None else np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def get(self, index: int, rng=None):
        i = int(self.indices[index])
        image = np.asarray(self.images[i], dtype=np.float32)[..., None] * 2.0
        masks = np.asarray(self.labels[i])  # [4, H, W]
        labels = np.stack([one_hot(masks[a]) for a in range(4)])  # [4,H,W,2]
        return {
            "image": image.astype(np.float32),
            "labels": labels,
            "likelihoods": np.full((4,), 0.25, dtype=np.float32),
        }


def training_dataset(file_path: Optional[str] = None) -> LIDCTrain:
    return LIDCTrain(_open_group("train", file_path))


def validation_dataset(max_size: Optional[int] = 500, file_path: Optional[str] = None) -> LIDCTest:
    group = _open_group("val", file_path)
    ds = LIDCTest(group)
    if max_size is None or max_size >= len(ds):
        return ds
    # seeded random subset (parity intent: seeded random_split, lidc.py:160)
    perm = np.random.default_rng(1).permutation(len(ds))[:max_size]
    return LIDCTest(group, indices=perm)


def test_dataset(max_size: Optional[int] = 500, indices=None,
                 file_path: Optional[str] = None) -> LIDCTest:
    group = _open_group("test", file_path)
    if indices is not None:
        return LIDCTest(group, indices=np.asarray(indices))
    ds = LIDCTest(group)
    if max_size is None or max_size >= len(ds):
        return ds
    return LIDCTest(group, indices=np.arange(max_size))  # lidc.py:210


def get_num_classes() -> int:
    return NUM_CLASSES


def get_ignore_class():
    return BACKGROUND_CLASS


def is_multi_annotator() -> bool:
    """Test samples carry all 4 expert masks (dataset-module protocol flag
    used by the GED-vs-mIoU evaluation dispatch)."""
    return True
