"""Synthetic LIDC-like data for tests, smoke training, and benchmarking (a
copy of `ccdm_tpu/data/synthetic.py`, held equal to it by
`tests/test_torch_trainer.py`).

Generates images with soft circular "nodules" and 4 correlated-but-distinct
annotator masks, in exactly the HDF5 schema the real LIDCv1 file uses
(`datasets/lidc.py:86-90`): `images [N,H,W]` float in [-0.5, 0.5],
`labels [N,4,H,W]` uint8. The LIDC dataset views accept these dict groups
interchangeably with h5py groups.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ccdm_tpu_torch.data.lidc import LIDCTest, LIDCTrain


def make_synthetic_lidc_group(n: int = 32, resolution: int = 128, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    h = w = resolution
    yy, xx = np.mgrid[0:h, 0:w]
    images = np.empty((n, h, w), dtype=np.float32)
    labels = np.zeros((n, 4, h, w), dtype=np.uint8)
    for i in range(n):
        cy, cx = rng.uniform(0.25 * h, 0.75 * h), rng.uniform(0.25 * w, 0.75 * w)
        r = rng.uniform(0.05, 0.15) * h
        dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        blob = np.exp(-((dist / r) ** 2))
        images[i] = np.clip(0.4 * blob + 0.05 * rng.standard_normal((h, w)), -0.5, 0.5)
        for a in range(4):
            # each "expert" thresholds at a different radius; one may see nothing
            thresh = r * rng.uniform(0.7, 1.4)
            if rng.random() < 0.15:
                continue
            labels[i, a] = (dist < thresh).astype(np.uint8)
    return {"images": images, "labels": labels,
            "uids": np.arange(n, dtype=np.int64)}


def synthetic_training_dataset(n: int = 32, resolution: int = 128, seed: int = 0) -> LIDCTrain:
    return LIDCTrain(make_synthetic_lidc_group(n, resolution, seed))


def synthetic_test_dataset(n: int = 8, resolution: int = 128, seed: int = 1) -> LIDCTest:
    return LIDCTest(make_synthetic_lidc_group(n, resolution, seed))


# Module protocol (same surface as data/lidc.py) so `dataset_file:
# ccdm_tpu.data.synthetic` (which `data/registry.py` maps here) works end to
# end in the trainer.
NUM_CLASSES = 2
BACKGROUND_CLASS = None


def training_dataset():
    return synthetic_training_dataset(n=64)


def validation_dataset(max_size=16):
    return synthetic_test_dataset(n=min(max_size or 16, 16), seed=1)


def test_dataset(max_size=16, indices=None):
    ds = synthetic_test_dataset(n=16, seed=2)
    if indices is not None:
        return LIDCTest({"images": ds.images, "labels": ds.labels}, indices=np.asarray(indices))
    if max_size is not None and max_size < len(ds):
        return LIDCTest({"images": ds.images, "labels": ds.labels},
                        indices=np.arange(max_size))
    return ds


def get_num_classes() -> int:
    return NUM_CLASSES


def get_ignore_class():
    return BACKGROUND_CLASS


def is_multi_annotator() -> bool:
    """Test samples carry all 4 expert masks (dataset-module protocol flag
    used by the GED-vs-mIoU evaluation dispatch)."""
    return True
