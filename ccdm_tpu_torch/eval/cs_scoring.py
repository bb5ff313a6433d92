"""Official-protocol Cityscapes scoring of label-id PNGs (a copy of
`ccdm_tpu/eval/cs_scoring.py` that reads with `utils/png.py` and counts the
confusion matrix with the port's native library, `ccdm_tpu_torch/native.py`).

Re-implements the scoring path the reference vendors from
`cityscapesscripts` (`evaluation/cs_eval.py:579+` `evaluateImgLists` /
`evaluatePair`): a confusion matrix over *label ids* accumulated across
(prediction, ground-truth) PNG pairs, reduced to per-class IoU over the 19
eval classes, per-category IoU, and pixel accuracy, exported as JSON.

The reference's optional Cython `addToConfusionMatrix` fast path
(`cs_eval.py:15-21`), its only native-code dependency, is the C++ loop of
`csrc/confusion_matrix.cpp`, built at first use.

Instance-weighted iIoU (`cs_eval.py:725-762,377-396,451-468`) is computed
when `*_instanceIds.png` annotations are available: every ground-truth
instance contributes weighted TP/FN with weight = avgClassSize / instance
size (official `args.avgClassSize` constants, `cs_eval.py:267-278`); FP
stays unweighted from the confusion matrix. Instance paths default to the
reference's `labelIds -> instanceIds` filename substitution
(`cs_eval.py:686`); iIoU entries are None/NaN when no instance file exists.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ccdm_tpu_torch.data.cityscapes_labels import LABELS
from ccdm_tpu_torch.native import add_to_confusion_matrix
from ccdm_tpu_torch.utils.png import read_png

LOGGER = logging.getLogger(__name__)

MAX_ID = 256  # label ids fit in uint8

EVAL_LABELS = [l for l in LABELS if not l.ignore_in_eval and l.id >= 0]
CATEGORIES = sorted({l.category for l in EVAL_LABELS})

# Official average instance sizes (pixels) used as iIoU weights
# (`cs_eval.py:267-278` `args.avgClassSize`).
AVG_CLASS_SIZE = {
    "bicycle": 4672.3249222261,
    "caravan": 36771.8241758242,
    "motorcycle": 6298.7200839748,
    "rider": 3930.4788056518,
    "bus": 35732.1511111111,
    "train": 67583.7075812274,
    "car": 12794.0202738185,
    "person": 3462.4756337644,
    "truck": 27855.1264367816,
    "trailer": 16926.9763313609,
}

# Classes that carry instances (iIoU is defined only for these).
INSTANCE_LABELS = [l for l in EVAL_LABELS if l.has_instances]

def _instance_categories() -> Dict[str, List[int]]:
    """Categories whose every label (id >= 0) has instances.

    Parity: `generateInstanceStats` (`cs_eval.py:314-332`) — only `id < 0`
    labels are skipped, so ignored-in-eval instance classes (caravan 29,
    trailer 30) DO join the category labelIds, exactly like the official
    scorer (Cityscapes: "human" and "vehicle")."""
    out: Dict[str, List[int]] = {}
    for cat in sorted({l.category for l in LABELS if l.id >= 0}):
        members = [l for l in LABELS if l.category == cat and l.id >= 0]
        if members and all(l.has_instances for l in members):
            out[cat] = [l.id for l in members]
    return out

INSTANCE_CATEGORIES = _instance_categories()


def accumulate_instance_stats(pred: np.ndarray, inst: np.ndarray,
                              stats: Dict) -> None:
    """Fold one image's instance-weighted TP/FN into `stats`.

    Parity: `evaluatePair` instance section (`cs_eval.py:723-762`): instance
    ids are `label_id * 1000 + n` (ids <= 1000 are crowd/stuff regions and
    skipped); each instance contributes tp/fn weighted by
    `avgClassSize[label] / instance_size`."""
    id2label = {l.id: l for l in LABELS}
    category_masks = {
        cat: np.isin(pred, ids) for cat, ids in INSTANCE_CATEGORIES.items()
    }
    for inst_id in np.unique(inst[inst > 1000]):
        label = id2label.get(int(inst_id) // 1000)
        if label is None or label.ignore_in_eval or label.name not in stats["classes"]:
            continue
        mask = inst == inst_id
        inst_size = int(np.count_nonzero(mask))
        tp = int(np.count_nonzero(pred[mask] == label.id))
        weight = AVG_CLASS_SIZE[label.name] / float(inst_size)
        cls = stats["classes"][label.name]
        cls["tpWeighted"] += tp * weight
        cls["fnWeighted"] += (inst_size - tp) * weight
        if label.category in stats["categories"]:
            cat_tp = int(np.count_nonzero(mask & category_masks[label.category]))
            cat = stats["categories"][label.category]
            cat["tpWeighted"] += cat_tp * weight
            cat["fnWeighted"] += (inst_size - cat_tp) * weight


def _empty_instance_stats() -> Dict:
    return {
        "classes": {l.name: {"tpWeighted": 0.0, "fnWeighted": 0.0}
                    for l in INSTANCE_LABELS},
        "categories": {cat: {"tpWeighted": 0.0, "fnWeighted": 0.0}
                       for cat in INSTANCE_CATEGORIES},
    }


def _inst_iou(tp_w: float, fn_w: float, fp: float) -> float:
    denom = tp_w + fp + fn_w
    return tp_w / denom if denom > 0 else float("nan")


def _iou_for_ids(cm: np.ndarray, ids: List[int], all_eval_ids: List[int]) -> float:
    """IoU of the union-of-ids 'class' against everything else, official
    semantics: FP counts only pixels whose gt is an *evaluated* class."""
    ids = list(ids)
    tp = float(cm[np.ix_(ids, ids)].sum())
    fn = float(cm[ids, :].sum() - tp)
    gt_eval_rows = np.zeros(MAX_ID, dtype=bool)
    gt_eval_rows[all_eval_ids] = True
    fp = float(cm[np.ix_(gt_eval_rows, ids)].sum() - tp)
    denom = tp + fp + fn
    return tp / denom if denom > 0 else float("nan")


def score_img_lists(
    pred_list: Sequence[str],
    gt_list: Sequence[str],
    export_file: Optional[str] = None,
    inst_list: Optional[Sequence[Optional[str]]] = None,
) -> Dict:
    """Score prediction PNGs (label-id space) against gtFine labelIds PNGs.

    Returns the official-shaped result dict: per-class IoU, mean IoU,
    per-category IoU, mean category IoU, pixel accuracy, and — when
    `*_instanceIds.png` annotations exist — instance-weighted iIoU per class
    and category. `inst_list` overrides the default instance path derivation
    (the reference's `labelIds -> instanceIds` substitution, `cs_eval.py:686`);
    entries may be None for images without instance annotations.
    Parity: `evaluateImgLists` (`cs_eval.py:579+`) + JSON export
    (`eval_cdm.py:424-432`).
    """
    assert len(pred_list) == len(gt_list)
    if inst_list is None:
        # the substitution only yields a real instance path when the gt file
        # follows the gtFine naming scheme; otherwise skip iIoU for that image
        inst_list = [g.replace("labelIds", "instanceIds") if "labelIds" in g
                     else None for g in gt_list]
    assert len(inst_list) == len(gt_list)

    # single pass: each prediction PNG is decoded once and feeds both the
    # confusion matrix and the instance-weighted stats
    cm = np.zeros((MAX_ID, MAX_ID), dtype=np.int64)
    inst_stats = _empty_instance_stats()
    n_inst_images = 0
    for pred_path, gt_path, inst_path in zip(pred_list, gt_list, inst_list):
        pred = np.asarray(read_png(pred_path), dtype=np.uint8)
        gt = np.asarray(read_png(gt_path), dtype=np.uint8)
        if pred.shape != gt.shape:
            raise ValueError(
                f"shape mismatch {pred.shape} vs {gt.shape}: {pred_path} / {gt_path}")
        add_to_confusion_matrix(gt, pred, MAX_ID, cm)
        if inst_path and os.path.exists(inst_path):
            inst = read_png(inst_path).astype(np.int64)
            accumulate_instance_stats(pred.astype(np.int64), inst, inst_stats)
            n_inst_images += 1

    if 0 < n_inst_images < len(pred_list):
        # weighted TP/FN come from the instance subset while FP comes from the
        # confusion matrix over ALL images, biasing iIoU low; the official
        # scorer hard-errors on a missing instance file instead
        LOGGER.warning(
            "instanceIds files found for only %d/%d images — iIoU mixes "
            "partial instance stats with full-set FP counts and is biased; "
            "provide instance files for all images for an official score",
            n_inst_images, len(pred_list))

    eval_ids = [l.id for l in EVAL_LABELS]
    class_scores = {l.name: _iou_for_ids(cm, [l.id], eval_ids) for l in EVAL_LABELS}
    category_scores = {
        cat: _iou_for_ids(cm, [l.id for l in EVAL_LABELS if l.category == cat], eval_ids)
        for cat in CATEGORIES
    }
    valid = [v for v in class_scores.values() if not np.isnan(v)]
    valid_cat = [v for v in category_scores.values() if not np.isnan(v)]

    eval_rows = cm[eval_ids, :]
    tp_total = float(cm[eval_ids, eval_ids].sum())
    px_total = float(eval_rows.sum())

    # Instance-weighted iIoU: weighted tp/fn from inst_stats, unweighted fp
    # from the confusion matrix (`getInstanceIouScoreForLabel`,
    # `cs_eval.py:377-396`; category: `:451-468`).
    if n_inst_images:
        class_inst_scores = {}
        for l in EVAL_LABELS:
            if l.name not in inst_stats["classes"]:
                class_inst_scores[l.name] = float("nan")
                continue
            other_rows = [e for e in eval_ids if e != l.id]
            fp = float(cm[other_rows, l.id].sum())
            s = inst_stats["classes"][l.name]
            class_inst_scores[l.name] = _inst_iou(s["tpWeighted"], s["fnWeighted"], fp)
        category_inst_scores = {}
        for cat in CATEGORIES:
            if cat not in INSTANCE_CATEGORIES:
                category_inst_scores[cat] = float("nan")
                continue
            ids = INSTANCE_CATEGORIES[cat]
            other_rows = [l.id for l in EVAL_LABELS if l.category != cat]
            fp = float(cm[np.ix_(other_rows, ids)].sum())
            s = inst_stats["categories"][cat]
            category_inst_scores[cat] = _inst_iou(s["tpWeighted"], s["fnWeighted"], fp)
        valid_inst = [v for v in class_inst_scores.values() if not np.isnan(v)]
        valid_inst_cat = [v for v in category_inst_scores.values() if not np.isnan(v)]
        avg_inst = float(np.mean(valid_inst)) if valid_inst else float("nan")
        avg_inst_cat = float(np.mean(valid_inst_cat)) if valid_inst_cat else float("nan")
    else:
        class_inst_scores = category_inst_scores = None
        avg_inst = avg_inst_cat = None

    cm_total = float(cm.sum())
    results = {
        # class priors (gt row mass / total), exported like `createResultDict`
        # (`cs_eval.py:478-481`, `getPrior` `:398-400`)
        "priors": {l.name: (float(cm[l.id, :].sum()) / cm_total if cm_total
                            else float("nan")) for l in EVAL_LABELS},
        "classScores": class_scores,
        "averageScoreClasses": float(np.mean(valid)) if valid else float("nan"),
        "categoryScores": category_scores,
        "averageScoreCategories": float(np.mean(valid_cat)) if valid_cat else float("nan"),
        "pixelAccuracy": tp_total / px_total if px_total else float("nan"),
        "classInstScores": class_inst_scores,
        "categoryInstScores": category_inst_scores,
        "averageScoreInstClasses": avg_inst,
        "averageScoreInstCategories": avg_inst_cat,
        "nbInstanceImages": n_inst_images,
        "nbImages": len(pred_list),
    }
    if export_file:
        os.makedirs(os.path.dirname(export_file) or ".", exist_ok=True)
        with open(export_file, "w") as f:
            json.dump(results, f, indent=2)
        LOGGER.info("wrote results to %s", export_file)
    return results
