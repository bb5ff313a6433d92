"""Cityscapes semantic segmentation (20 train classes: 19 + ignore 19); a copy
of `ccdm_tpu/data/cityscapes.py` that reads its PNGs with `utils/png.py`.

Parity with `datasets/cityscapes.py`: images under
`$CCDM_CITYSCAPES_PATH/leftImg8bit/{split}/{city}/*_leftImg8bit.png`, labels
`gtFine/{split}/{city}/*_gtFine_labelIds.png`; label ids mapped to train ids
via `encode_target` (`cityscapes.py:29-30`), class weights zero the ignore
class (`cityscapes.py:25-26`). The torchvision `datasets.Cityscapes` wrapper
is replaced by a direct folder scan; `TransformedImgLblDataset` semantics
(`ddpm/dataset_utils.py:181-197`: transform pipeline, one-hot encode,
optional original-label passthrough) live in `CityscapesDataset.get`.

Default path keeps the reference's `${TMPDIR}/cityscapes/` convention
(`cityscapes.py:15`), overridable via `$CCDM_CITYSCAPES_PATH`.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ccdm_tpu_torch.data.cityscapes_labels import encode_target
from ccdm_tpu_torch.data.transforms import TransformPipeline, build_transforms
from ccdm_tpu_torch.utils.png import read_png

NUM_CLASSES = 20
BACKGROUND_CLASS = 19


def default_base_path() -> str:
    return os.environ.get(
        "CCDM_CITYSCAPES_PATH",
        os.path.expandvars("${TMPDIR}/cityscapes/"),
    )


def get_weights() -> np.ndarray:
    w = np.ones((NUM_CLASSES,), dtype=np.float32)
    w[BACKGROUND_CLASS] = 0.0  # cityscapes.py:25-26
    return w


def labels_to_categories(arr: np.ndarray) -> np.ndarray:
    return encode_target(arr)


def _scan(split: str, base: Optional[str] = None):
    base = base or default_base_path()
    img_glob = os.path.join(base, "leftImg8bit", split, "*", "*_leftImg8bit.png")
    images = sorted(glob.glob(img_glob))
    if not images:
        raise FileNotFoundError(f"no Cityscapes images matching {img_glob!r}; "
                                "set $CCDM_CITYSCAPES_PATH")
    labels = [
        p.replace(os.sep + "leftImg8bit" + os.sep, os.sep + "gtFine" + os.sep)
         .replace("_leftImg8bit.png", "_gtFine_labelIds.png")
        for p in images
    ]
    missing = [p for p in labels if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"{len(missing)} gtFine labelIds files missing, e.g. {missing[0]!r}")
    return images, labels


class CityscapesDataset:
    """Folder-backed dataset producing `{'image','x0'[, 'label','original_labels']}`."""

    def __init__(self, images, labels, pipeline: Optional[TransformPipeline],
                 return_metadata: bool = False, indices=None):
        self.image_files = images
        self.label_files = labels
        self.pipeline = pipeline
        self.return_metadata = return_metadata
        self.indices = np.arange(len(images)) if indices is None else np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        if rng is None:  # eval paths draw nothing random; crop/flip are train-only
            rng = np.random.default_rng(index)
        i = int(self.indices[index])
        img = read_png(self.image_files[i], mode="RGB")
        lbl = labels_to_categories(read_png(self.label_files[i]))
        metadata: Optional[dict] = {} if self.return_metadata else None
        if self.pipeline is not None:
            img, lbl, metadata = self.pipeline(img, lbl, rng, metadata)
        img = img.astype(np.float32)
        lbl = lbl.astype(np.int64)
        out = {
            "image": img,
            "x0": np.eye(NUM_CLASSES, dtype=np.float32)[lbl],
            "label": lbl.astype(np.int32),
        }
        if metadata and "original_labels" in metadata:
            out["original_labels"] = metadata["original_labels"]
        if self.return_metadata:
            out["image_file"] = self.image_files[i]
        return out


def _build_pipeline(params: Optional[dict], train: bool) -> Optional[TransformPipeline]:
    if not params:
        return None
    key = "dataset_pipeline_train" if train else "dataset_pipeline_val"
    names = params.get(key)
    settings = params.get(f"{key}_settings", {})
    if not names:
        return None
    return build_transforms(names, settings, NUM_CLASSES)


def training_dataset(params: Optional[dict] = None, base_path: Optional[str] = None) -> CityscapesDataset:
    imgs, lbls = _scan("train", base_path)
    return CityscapesDataset(imgs, lbls, _build_pipeline(params, train=True))


def validation_dataset(max_size: Optional[int] = 64, params: Optional[dict] = None,
                       base_path: Optional[str] = None,
                       return_metadata: bool = False) -> CityscapesDataset:
    imgs, lbls = _scan("val", base_path)
    ds = CityscapesDataset(imgs, lbls, _build_pipeline(params, train=False),
                           return_metadata=return_metadata)
    if max_size and max_size < len(ds):
        perm = np.random.default_rng(1).permutation(len(ds))[:max_size]
        ds.indices = perm  # seeded random subset (cityscapes.py:54-55)
    return ds


def test_dataset(max_size: Optional[int] = 128, params: Optional[dict] = None,
                 base_path: Optional[str] = None,
                 return_metadata: bool = False) -> CityscapesDataset:
    return validation_dataset(max_size, params, base_path, return_metadata)


def get_num_classes() -> int:
    return NUM_CLASSES


def get_ignore_class() -> int:
    return BACKGROUND_CLASS


def is_multi_annotator() -> bool:
    """Single ground-truth label per image -> confusion-matrix mIoU path."""
    return False
