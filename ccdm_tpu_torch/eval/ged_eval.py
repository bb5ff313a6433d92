"""GED and HM-IoU validation over a multi-annotator set (port of
`ccdm_tpu/eval/ged_eval.py`).

For every validation image, `num_samples` segmentations in one batched
sampler pass (the image repeated along the batch), then GED, sample
diversity and HM-IoU against the expert masks. Each image draws from the
noise streams of its global index. Single process: the JAX version's host
slicing and allgather have no counterpart yet, nor its DINO-conditioned
sampling (no LIDC config conditions on DINO).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
from ccdm_tpu_torch.eval.metrics import generalised_energy_distance, hungarian_matched_iou
from ccdm_tpu_torch.models.builder import DenoisingModel

LOGGER = logging.getLogger(__name__)


def make_batched_sampler(model: DenoisingModel, num_samples: int,
                         num_steps: Optional[int] = None):
    """`(net, images [B,H,W,Ci], key=0, indices=None) -> [B,S,H,W]` int64
    class maps: the argmax of `make_prob_sampler`'s maps."""
    prob_sampler = make_prob_sampler(model, num_samples, num_steps)

    def run(net, images, key: int = 0, indices=None):
        return prob_sampler(net, images, key, indices).argmax(dim=-1)

    return run


def compute_ged(model: DenoisingModel, net, dataset, num_samples: int, batch_size: int,
                key: int = 0, num_steps: Optional[int] = None,
                max_batches: Optional[int] = None, sampler=None):
    """Mean (GED, sample diversity, HM-IoU) over `dataset` (eval-protocol
    samples `{"image", "labels" [A,H,W,C], ...}`), at most `max_batches`
    batches of `batch_size` images, sampled with `net` on its device. Image
    i's samples draw from the streams of `key` and global index i, so the
    scores do not depend on `batch_size`."""
    num_classes = model.diffusion.num_classes
    if sampler is None:
        sampler = make_batched_sampler(model, num_samples, num_steps)
    device = next(net.parameters()).device
    n = len(dataset)
    bs = max(1, min(batch_size, n))
    if max_batches is not None:
        n = min(n, max_batches * bs)
    total_ged = total_div = total_hm = 0.0
    count = 0
    for start in range(0, n, bs):
        idx = list(range(start, min(start + bs, n)))
        samples = [dataset.get(i) for i in idx]
        images = torch.from_numpy(np.stack([s["image"] for s in samples])).to(device)
        refs = torch.from_numpy(
            np.argmax(np.stack([s["labels"] for s in samples]), axis=-1)).to(device)
        preds = sampler(net, images, key, idx)
        ged, div_s, _ = generalised_energy_distance(preds, refs, num_classes)
        hm = hungarian_matched_iou(preds, refs, num_classes)
        total_ged += float(np.sum(ged))
        total_div += float(np.sum(div_s))
        total_hm += float(np.sum(hm))
        count += len(samples)
    if count == 0:
        raise ValueError("empty validation dataset")
    return total_ged / count, total_div / count, total_hm / count
