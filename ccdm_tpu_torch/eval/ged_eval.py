"""GED and HM-IoU validation over a multi-annotator set (port of
`ccdm_tpu/eval/ged_eval.py`).

For every validation image, `num_samples` segmentations in one batched
sampler pass (the image repeated along the batch), then GED, sample
diversity and HM-IoU against the expert masks. Each image draws from the
noise streams of its global index. The samplers take the DINO encoder of
a conditioned run (`feature_fn`, its weights passed to each call as
`feature_net`), as the trainer's mIoU validation and grids use them. In a
process group each rank scores its strided share of the images and one
float64 allgather combines the sums (`parallel/mesh.py`), so every rank
returns the same means for any number of ranks.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
from ccdm_tpu_torch.eval.metrics import generalised_energy_distance, hungarian_matched_iou
from ccdm_tpu_torch.models.builder import DenoisingModel
from ccdm_tpu_torch.parallel import mesh

LOGGER = logging.getLogger(__name__)


def make_batched_sampler(model: DenoisingModel, num_samples: int,
                         num_steps: Optional[int] = None, feature_fn=None):
    """`(net, images [B,H,W,Ci], key=0, indices=None, feature_net=None) ->
    [B,S,H,W]` int64 class maps: the argmax of `make_prob_sampler`'s maps
    (CUDA graphs on the card), conditioned on `feature_fn(feature_net,
    images)` where it is given. Its `graphed` attribute is the prob
    sampler's."""
    prob_sampler = make_prob_sampler(model, num_samples, num_steps, feature_fn=feature_fn)

    def run(net, images, key: int = 0, indices=None, feature_net=None):
        return prob_sampler(net, images, key, indices,
                            feature_net=feature_net).argmax(dim=-1)

    run.graphed = prob_sampler.graphed
    return run


def compute_ged(model: DenoisingModel, net, dataset, num_samples: int, batch_size: int,
                key: int = 0, num_steps: Optional[int] = None,
                max_batches: Optional[int] = None, sampler=None, feature_net=None,
                process_index: Optional[int] = None, process_count: Optional[int] = None):
    """Mean (GED, sample diversity, HM-IoU) over `dataset` (eval-protocol
    samples `{"image", "labels" [A,H,W,C], ...}`), at most `max_batches`
    batches of `batch_size` images, sampled with `net` on its device (and
    `feature_net`, the encoder's weights, where the sampler conditions on
    one). Image i's samples draw from the streams of `key` and global index
    i, so the scores do not depend on `batch_size`. Rank `process_index` of
    `process_count` (default: the process group's) scores the images
    `process_index::process_count` of that global budget, its tail padded
    to the batch and the padding left out; with more than one rank the
    sums are gathered over the group, whose size `process_count` must be."""
    if process_index is None:
        process_index = mesh.process_index()
    if process_count is None:
        process_count = mesh.process_count()
    if process_count != mesh.process_count():
        raise ValueError(f"compute_ged: process_count {process_count} but the process group "
                         f"holds {mesh.process_count()} ranks; the slices would not be gathered")
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
    mine = mesh.host_slice(n, process_index, process_count)
    for start in range(0, len(mine), bs):
        idx, real = mesh.pad_chunk(mine[start:start + bs], bs)
        samples = [dataset.get(i) for i in idx]
        images = torch.from_numpy(np.stack([s["image"] for s in samples])).to(device)
        refs = torch.from_numpy(
            np.argmax(np.stack([s["labels"] for s in samples[:real]]), axis=-1)).to(device)
        preds = sampler(net, images, key, idx, feature_net=feature_net)[:real]
        ged, div_s, _ = generalised_energy_distance(preds, refs, num_classes)
        hm = hungarian_matched_iou(preds, refs, num_classes)
        total_ged += float(np.sum(ged))
        total_div += float(np.sum(div_s))
        total_hm += float(np.sum(hm))
        count += real
    if process_count > 1:
        total_ged, total_div, total_hm, count = mesh.allgather_f64(
            [total_ged, total_div, total_hm, count]).sum(axis=0).tolist()
    if count == 0:
        raise ValueError("empty validation dataset")
    return total_ged / count, total_div / count, total_hm / count
