"""Distributional segmentation metrics: GED, HM-IoU and a confusion matrix
(port of `ccdm_tpu/eval/metrics.py`).

- one-hot IoU per class, NaN -> 1 for an empty union;
- pairwise distance `1 - mean_{c>=1} IoU_c`, background (class 0) excluded;
- `GED^2 = 2 E[d(S,Y)] - E[d(S,S')] - E[d(Y,Y')]`, per image, with both
  diversities;
- HM-IoU: both sample sets repeated to the lcm of their sizes, the
  Hungarian assignment of the pairwise distances (scipy, on the host), the
  mean matched `1 - d`;
- `ConfusionMatrix`: a streaming matrix with IoU, mIoU, Dice and accuracy.

The pairwise intersections run as one einsum over one-hot fp32 maps on the
device that holds the samples; counts are exact in fp32 up to 2^24 pixels.
"""

from __future__ import annotations

from math import lcm
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _one_hot_flat(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[B,S,H,W] int -> [B,S,HW,C] float32 one-hot."""
    b, s = labels.shape[:2]
    return F.one_hot(labels.reshape(b, s, -1).long(), num_classes).float()


def pairwise_class_distance(x: torch.Tensor, y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """`1 - mean_{c>=1} IoU_c` for every pair: x [B,Sx,H,W], y [B,Sy,H,W]
    int class maps -> [B,Sx,Sy] float32. Empty-union classes count as IoU 1."""
    xh = _one_hot_flat(x, num_classes)
    yh = _one_hot_flat(y, num_classes)
    inter = torch.einsum("bspc,btpc->bstc", xh, yh)
    union = xh.sum(dim=2)[:, :, None, :] + yh.sum(dim=2)[:, None, :, :] - inter
    iou = torch.where(union > 0, inter / union.clamp_min(1.0), torch.ones_like(inter))
    return 1.0 - iou[..., 1:].mean(dim=-1)


def generalised_energy_distance(samples: torch.Tensor, references: torch.Tensor,
                                num_classes: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-image (GED, sample diversity, reference diversity) as numpy:
    samples [B,S,H,W] int, references [B,A,H,W] int."""
    cross = pairwise_class_distance(samples, references, num_classes).mean(dim=(1, 2))
    div_s = pairwise_class_distance(samples, samples, num_classes).mean(dim=(1, 2))
    div_r = pairwise_class_distance(references, references, num_classes).mean(dim=(1, 2))
    ged = 2 * cross - div_s - div_r
    return tuple(t.double().cpu().numpy() for t in (ged, div_s, div_r))


def hungarian_matched_iou(samples: torch.Tensor, references: torch.Tensor,
                          num_classes: int) -> np.ndarray:
    """Per-image HM-IoU: both sets repeated to lcm(S, A) so the assignment
    is square; scipy's `linear_sum_assignment` on the host."""
    from scipy.optimize import linear_sum_assignment

    s, a = samples.shape[1], references.shape[1]
    m = lcm(s, a)
    cost = pairwise_class_distance(samples.repeat_interleave(m // s, dim=1),
                                   references.repeat_interleave(m // a, dim=1),
                                   num_classes).cpu().numpy()
    scores = np.empty((cost.shape[0],), dtype=np.float64)
    for i in range(cost.shape[0]):
        rows, cols = linear_sum_assignment(cost[i])
        scores[i] = (1.0 - cost[i])[rows, cols].mean()
    return scores


class ConfusionMatrix:
    """Streaming confusion matrix (rows: truth, columns: prediction) with
    IoU/mIoU/Dice/accuracy readouts; `ignore_class` is dropped from the
    per-class vectors. Updates count on the tensors' device; the matrix
    accumulates on the host."""

    def __init__(self, num_classes: int, ignore_class: Optional[int] = None):
        self.num_classes = num_classes
        self.ignore_class = ignore_class
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update(self, pred, true) -> None:
        """pred/true: integer class maps of identical shape (tensors or arrays)."""
        pred, true = torch.as_tensor(pred), torch.as_tensor(true)
        idx = true.reshape(-1).long() * self.num_classes + pred.reshape(-1).long().to(true.device)
        counts = torch.bincount(idx, minlength=self.num_classes ** 2)
        self.matrix += counts.cpu().numpy().reshape(self.num_classes, self.num_classes)

    def _select(self, values: np.ndarray) -> np.ndarray:
        if self.ignore_class is None:
            return values
        return np.delete(values, self.ignore_class)

    def iou(self) -> np.ndarray:
        diag = np.diag(self.matrix).astype(np.float64)
        rows = self.matrix.sum(1).astype(np.float64)
        cols = self.matrix.sum(0).astype(np.float64)
        denom = rows + cols - diag
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = np.where(denom > 0, diag / denom, np.nan)
        return self._select(iou)

    def miou(self) -> float:
        return float(np.nanmean(self.iou()))

    def dice(self) -> np.ndarray:
        diag = np.diag(self.matrix).astype(np.float64)
        denom = self.matrix.sum(1) + self.matrix.sum(0)
        with np.errstate(invalid="ignore", divide="ignore"):
            dice = np.where(denom > 0, 2 * diag / denom, np.nan)
        return self._select(dice)

    def accuracy(self) -> float:
        return float(np.diag(self.matrix).sum() / max(self.matrix.sum(), 1))

    def reset(self) -> None:
        self.matrix[:] = 0
