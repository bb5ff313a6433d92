"""Cityscapes label metadata: the official 35-class table and id<->trainId maps
(a copy of `ccdm_tpu/data/cityscapes_labels.py`).

The rows are the public Cityscapes benchmark constants
(github.com/mcordts/cityscapesScripts, labels.py); the reference vendors the
same table (`datasets/cityscapes_config.py:34-70`, `evaluation/labels.py`).
Train-id convention parity with the reference: the 19 eval classes get train
ids 0..18 and every void/ignored id collapses onto train id 19
(`cityscapes_config.py:87-93`), giving NUM_CLASSES = 20.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LabelSpec:
    name: str
    id: int
    train_id: int
    category: str
    category_id: int
    has_instances: bool
    ignore_in_eval: bool
    color: Tuple[int, int, int]


# (name, id, trainId, category, catId, hasInstances, ignoreInEval, color)
_ROWS = [
    ("unlabeled", 0, 255, "void", 0, False, True, (0, 0, 0)),
    ("ego vehicle", 1, 255, "void", 0, False, True, (0, 0, 0)),
    ("rectification border", 2, 255, "void", 0, False, True, (0, 0, 0)),
    ("out of roi", 3, 255, "void", 0, False, True, (0, 0, 0)),
    ("static", 4, 255, "void", 0, False, True, (0, 0, 0)),
    ("dynamic", 5, 255, "void", 0, False, True, (111, 74, 0)),
    ("ground", 6, 255, "void", 0, False, True, (81, 0, 81)),
    ("road", 7, 0, "flat", 1, False, False, (128, 64, 128)),
    ("sidewalk", 8, 1, "flat", 1, False, False, (244, 35, 232)),
    ("parking", 9, 255, "flat", 1, False, True, (250, 170, 160)),
    ("rail track", 10, 255, "flat", 1, False, True, (230, 150, 140)),
    ("building", 11, 2, "construction", 2, False, False, (70, 70, 70)),
    ("wall", 12, 3, "construction", 2, False, False, (102, 102, 156)),
    ("fence", 13, 4, "construction", 2, False, False, (190, 153, 153)),
    ("guard rail", 14, 255, "construction", 2, False, True, (180, 165, 180)),
    ("bridge", 15, 255, "construction", 2, False, True, (150, 100, 100)),
    ("tunnel", 16, 255, "construction", 2, False, True, (150, 120, 90)),
    ("pole", 17, 5, "object", 3, False, False, (153, 153, 153)),
    ("polegroup", 18, 255, "object", 3, False, True, (153, 153, 153)),
    ("traffic light", 19, 6, "object", 3, False, False, (250, 170, 30)),
    ("traffic sign", 20, 7, "object", 3, False, False, (220, 220, 0)),
    ("vegetation", 21, 8, "nature", 4, False, False, (107, 142, 35)),
    ("terrain", 22, 9, "nature", 4, False, False, (152, 251, 152)),
    ("sky", 23, 10, "sky", 5, False, False, (70, 130, 180)),
    ("person", 24, 11, "human", 6, True, False, (220, 20, 60)),
    ("rider", 25, 12, "human", 6, True, False, (255, 0, 0)),
    ("car", 26, 13, "vehicle", 7, True, False, (0, 0, 142)),
    ("truck", 27, 14, "vehicle", 7, True, False, (0, 0, 70)),
    ("bus", 28, 15, "vehicle", 7, True, False, (0, 60, 100)),
    ("caravan", 29, 255, "vehicle", 7, True, True, (0, 0, 90)),
    ("trailer", 30, 255, "vehicle", 7, True, True, (0, 0, 110)),
    ("train", 31, 16, "vehicle", 7, True, False, (0, 80, 100)),
    ("motorcycle", 32, 17, "vehicle", 7, True, False, (0, 0, 230)),
    ("bicycle", 33, 18, "vehicle", 7, True, False, (119, 11, 32)),
    ("license plate", -1, 255, "vehicle", 7, False, True, (0, 0, 142)),
]

LABELS = [LabelSpec(*row) for row in _ROWS]

NUM_TRAIN_CLASSES = 20  # 19 eval classes + ignore class 19
IGNORE_TRAIN_ID = 19

# id -> trainId lookup; index -1 (license plate) resolves via negative indexing,
# matching the reference's array layout (`cityscapes_config.py:87-89`).
ID_TO_TRAIN_ID = np.array(
    [lbl.train_id if lbl.train_id != 255 else IGNORE_TRAIN_ID for lbl in LABELS],
    dtype=np.int64,
)

# trainId -> representative label id (first id claiming each train id), with
# ignore class mapping back to id 0 (`cityscapes_config.py:90-92`).
TRAIN_ID_TO_ID = np.array(
    [lbl.id for lbl in LABELS if lbl.train_id not in (-1, 255)] + [0], dtype=np.int64
)

# trainId -> color (ignore class = black), `cityscapes_config.py:72-74`.
TRAIN_ID_TO_COLOR = np.array(
    [lbl.color for lbl in LABELS if lbl.train_id not in (-1, 255)] + [(0, 0, 0)],
    dtype=np.uint8,
)


def encode_target(target: np.ndarray) -> np.ndarray:
    """Label ids -> train ids in [0, 19] (parity: `cityscapes_config.py:96-99`)."""
    return ID_TO_TRAIN_ID[np.asarray(target)]


def decode_target_to_color(target: np.ndarray) -> np.ndarray:
    """Train ids -> RGB colors; 255 treated as ignore (`cityscapes_config.py:102-106`)."""
    t = np.asarray(target).copy()
    t[t == 255] = IGNORE_TRAIN_ID
    return TRAIN_ID_TO_COLOR[t]


def map_train_id_to_id(target: np.ndarray) -> np.ndarray:
    """Train ids -> submission label ids (`cityscapes_config.py:114-118`)."""
    t = np.asarray(target).copy()
    t[t == 255] = IGNORE_TRAIN_ID
    return TRAIN_ID_TO_ID[t]
