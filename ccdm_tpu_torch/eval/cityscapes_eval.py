"""Cityscapes inference and scoring (port of `ccdm_tpu/eval/cityscapes_eval.py`).

- `CityscapesEvaluator.build`: the model, the DINO encoder and the sampler
  of an eval config;
- `predict_batch`: the confidence vote, the mean of the votes' probability
  maps, each image's votes drawn from the noise streams of its global
  index;
- `predict_labels`: on the device, the bilinear upsample to the original
  resolution, the ignore channel dropped, the argmax;
- `run`: the loop over the validation set, the 19-class confusion matrix
  over `valid` pixels, the submission label-id, colour and ground-truth
  PNGs named by global index, and the official re-scoring of those PNGs
  (`eval/cs_scoring.py`) with its JSON;
- `run_inference(params)`: the entry point.

`quantized_inference: static` calibrates the int8 activation scales on the
first two validation images (each drawn with `np.random.default_rng(i)`, as
the JAX evaluator draws them) after the weights load.

In a process group (`parallel/mesh.py`) each rank predicts its strided
share of the images and dumps their PNGs, named by global index; one
float64 allgather sums the confusion matrices (and is the barrier after
which every PNG is written), and rank 0 runs the official scoring over all
of them. The output path must be one that every rank writes.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ccdm_tpu_torch.config import expanduservars, with_defaults
from ccdm_tpu_torch.data import cityscapes as cs_data
from ccdm_tpu_torch.data.cityscapes_labels import decode_target_to_color, map_train_id_to_id
from ccdm_tpu_torch.eval.cs_scoring import score_img_lists
from ccdm_tpu_torch.eval.lidc_uncertainty import (
    build_eval_feature_fn,
    load_eval_params,
    make_prob_sampler,
)
from ccdm_tpu_torch.eval.metrics import ConfusionMatrix
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.dino import resize_bilinear
from ccdm_tpu_torch.parallel import mesh
from ccdm_tpu_torch.utils.png import write_png

LOGGER = logging.getLogger(__name__)


class CityscapesEvaluator:
    def __init__(self, params: Dict[str, Any]):
        params = with_defaults(params)
        self.params = params
        self.num_classes = cs_data.get_num_classes()
        self.ignore = cs_data.get_ignore_class()
        eval_cfg = params.get("evaluation") or {}
        self.eval_resolution = eval_cfg.get("resolution", "dataloader")
        self.vote_strategy = eval_cfg.get("evaluation_vote_strategy", "confidence")
        self.num_evaluations = int(eval_cfg.get("evaluations", 1))
        if self.eval_resolution not in ("original", "dataloader"):
            raise ValueError(f"unknown evaluation resolution {self.eval_resolution!r}")
        if self.num_evaluations > 1 and self.vote_strategy != "confidence":
            raise NotImplementedError("a majority vote over several evaluations")
        self.output_path = expanduservars(params.get("output_path", "./logs/eval"))
        self.cm = ConfusionMatrix(self.num_classes - 1)  # the evaluated classes
        self.pred_files: list = []
        self.gt_files: list = []

    def build(self, image_shape: Tuple[int, int, int], batch_size: int, *, device=None,
              calibration_images=None):
        """The model (image_size = min(H, W) picks the channel multipliers),
        the DINO encoder and the sampler for `[B,H,W,Ci]` batches of at most
        `batch_size` images, on `device` (default: the CUDA card). The UNet
        evaluates the EMA weights of the `load_from` checkpoint; without one
        its weights are random, drawn from the config's seed. With
        `quantized_inference: static`, `calibration_images` `[n,H,W,Ci]`
        (numpy or a tensor) calibrate the int8 scales; `calibration_seconds`
        says how long that took."""
        p = dict(self.params)
        p["step_T_sample"] = self.vote_strategy
        self.batch_size = int(batch_size)
        self.model = build_model(
            p, self.num_classes, image_channels=image_shape[-1],
            image_size=min(image_shape[:2]), device=device,
            generator=torch.Generator().manual_seed(int(self.params.get("seed", 0))))
        load_eval_params(self.params, self.model.unet)
        self.feature_fn, self.feature_shape, self.feature_net = build_eval_feature_fn(
            self.params, image_shape, device=device)
        self.calibration_seconds = 0.0
        if str(self.params.get("quantized_inference", "")).lower() == "static":
            if calibration_images is None:
                raise ValueError("quantized_inference: static needs calibration_images")
            from ccdm_tpu_torch.ops import quant

            dev = next(self.model.unet.parameters()).device
            t0 = time.perf_counter()
            self.model = quant.calibrate_static_scales(
                self.model, self.model.unet, torch.as_tensor(calibration_images).to(dev),
                feature_fn=self.feature_fn, feature_net=self.feature_net)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.calibration_seconds = time.perf_counter() - t0
        self.sampler = make_prob_sampler(
            self.model, self.num_evaluations, feature_fn=self.feature_fn,
            encoder_reuse=int(self.params.get("encoder_reuse", 1)))

    def predict_batch(self, images: torch.Tensor, key: int = 0, indices=None,
                      **noise) -> torch.Tensor:
        """`[B,H,W,3]` -> the mean over votes of the probability maps,
        `[B,H,W,C]`. Image b's votes draw from the streams of `key` and its
        global index `indices[b]` (default `arange(B)`); `noise` (`prior`,
        `uniforms`, `gumbel`) injects the draws instead, as
        `make_prob_sampler`'s run takes them."""
        if images.shape[0] > self.batch_size:
            raise ValueError(f"a batch of {images.shape[0]} images; built for "
                             f"{self.batch_size}")
        probs = self.sampler(self.model.unet, images, key, indices,
                             feature_net=self.feature_net, **noise)
        return probs.mean(dim=1)

    def predict_labels(self, probs: torch.Tensor,
                       original_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Train-id label maps `[B,h,w]` from `[B,H,W,C]` probabilities:
        bilinear upsampling to `original_hw` (when the evaluation resolution
        is "original"), the ignore channel dropped, argmax."""
        if self.eval_resolution == "original" and original_hw is not None:
            probs = resize_bilinear(probs, original_hw)
        return torch.argmax(probs[..., : self.num_classes - 1], dim=-1)

    def _dump_pngs(self, idx: int, pred_train_id: np.ndarray, label_train_id: np.ndarray):
        pred_path = os.path.join(self.output_path, "submit", f"{idx:06d}_pred_labelIds.png")
        gt_path = os.path.join(self.output_path, "gt", f"{idx:06d}_gt_labelIds.png")
        write_png(pred_path, map_train_id_to_id(pred_train_id).astype(np.uint8))
        write_png(gt_path, map_train_id_to_id(label_train_id).astype(np.uint8))
        write_png(os.path.join(self.output_path, "color", f"{idx:06d}_pred_color.png"),
                  decode_target_to_color(pred_train_id).astype(np.uint8))
        self.pred_files.append(pred_path)
        self.gt_files.append(gt_path)

    def run(self, dataset, batch_size: int, key: int = 0,
            max_images: Optional[int] = None) -> Dict[str, Any]:
        """Predict, score and dump the first `max_images` images of
        `dataset` (all by default) in batches of `batch_size`, the tail
        padded with repeats of its last image. Returns `mIoU` and `IoU` of
        the train-id confusion matrix, the image count, the official scores
        of the dumped PNGs (None on ranks other than 0), and this rank's
        host seconds of each stage."""
        n = len(dataset)
        if max_images:
            n = min(n, max_images)
        batch_size = min(batch_size, max(n, 1))
        rng = np.random.default_rng(0)
        device = next(self.model.unet.parameters()).device
        seconds = dict.fromkeys(("data", "sampling", "labels", "confusion", "dumps",
                                 "scoring"), 0.0)
        img_cnt = 0
        # iIoU needs the gtFine instanceIds PNGs, and is only geometrically
        # valid when predictions are scored at the original resolution
        inst_files: Optional[list] = None
        if self.eval_resolution == "original" and hasattr(dataset, "label_files"):
            # dataset.get(k) reads label_files[indices[k]] (the seeded
            # subset): the instance paths follow the same mapping
            files = list(dataset.label_files)
            order = getattr(dataset, "indices", None)
            picked = [files[int(order[k]) if order is not None else k] for k in range(n)]
            inst_files = [p.replace("labelIds", "instanceIds") if "labelIds" in p else None
                          for p in picked]

        def tick(stage, t0):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds[stage] += time.perf_counter() - t0
            return time.perf_counter()

        mine = mesh.host_slice(n)
        for start in range(0, len(mine), batch_size):
            idx, real = mesh.pad_chunk(mine[start:start + batch_size], batch_size)
            t0 = time.perf_counter()
            samples = [dataset.get(i, rng) for i in idx]
            images = torch.from_numpy(np.stack([s["image"] for s in samples])).to(device)
            labels = np.stack([s["label"] for s in samples])  # train ids [B,H,W]
            t0 = tick("data", t0)
            probs = self.predict_batch(images, key, idx)  # [B,H,W,C]
            t0 = tick("sampling", t0)
            probs, labels, samples = probs[:real], labels[:real], samples[:real]
            original_hw = None
            if self.eval_resolution == "original" and "original_labels" in samples[0]:
                labels = np.stack([s["original_labels"] for s in samples])
                original_hw = labels.shape[1:3]
            # the upsample and the argmax run on the device
            pred = self.predict_labels(probs, original_hw).cpu().numpy()
            t0 = tick("labels", t0)
            valid = labels != self.ignore
            for b in range(pred.shape[0]):
                if valid[b].any():
                    self.cm.update(pred[b][valid[b]][None], labels[b][valid[b]][None])
                t0 = tick("confusion", t0)
                self._dump_pngs(idx[b], pred[b].astype(np.int64), labels[b].astype(np.int64))
                t0 = tick("dumps", t0)
                img_cnt += 1
            LOGGER.info("evaluated %d/%d images, running mIoU=%.4f", img_cnt, len(mine),
                        self.cm.miou())

        if mesh.process_count() > 1:
            # the gather is also the barrier: every rank's PNGs are written
            # before rank 0 scores them; their names follow the global index
            self.cm.matrix = mesh.allgather_f64(self.cm.matrix).sum(axis=0).reshape(
                self.cm.matrix.shape).astype(self.cm.matrix.dtype)
            img_cnt = n
            self.pred_files = [os.path.join(self.output_path, "submit",
                                            f"{i:06d}_pred_labelIds.png") for i in range(n)]
            self.gt_files = [os.path.join(self.output_path, "gt", f"{i:06d}_gt_labelIds.png")
                             for i in range(n)]
        results = {"mIoU": self.cm.miou(), "IoU": self.cm.iou().tolist(), "images": img_cnt,
                   "official": None, "seconds": seconds}
        if mesh.process_index() == 0:
            # the official re-scoring of the saved label-id PNGs
            t0 = time.perf_counter()
            results["official"] = score_img_lists(
                self.pred_files, self.gt_files,
                export_file=os.path.join(self.output_path,
                                         "resultPixelLevelSemanticLabeling.json"),
                inst_list=inst_files)
            tick("scoring", t0)
            LOGGER.info("mIoU (train-id CM): %.4f | official class mIoU: %.4f",
                        results["mIoU"], results["official"]["averageScoreClasses"])
        return results


def run_inference(params: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """Cityscapes inference over the config's validation set, on `device`
    (default: the CUDA card); see `CityscapesEvaluator.run`."""
    params = with_defaults(params)
    dataset = cs_data.validation_dataset(
        max_size=params.get("dataset_val_max_size"),
        params=params,
        return_metadata=(params.get("evaluation") or {}).get("resolution") == "original",
    )
    LOGGER.info("%d images in cityscapes validation set", len(dataset))
    ev = CityscapesEvaluator(params)
    max_images = params.get("max_images")
    n = min(len(dataset), max_images) if max_images else len(dataset)
    batch_size = min(int(params.get("batch_size", 2)), max(n, 1))
    first = dataset.get(0, np.random.default_rng(0))
    calibration_images = None
    if str(params.get("quantized_inference", "")).lower() == "static":
        calibration_images = np.stack([dataset.get(i, np.random.default_rng(i))["image"]
                                       for i in range(min(2, len(dataset)))])
    ev.build(first["image"].shape, batch_size, device=device,
             calibration_images=calibration_images)
    return ev.run(dataset, batch_size=batch_size, key=int(params.get("seed", 0)),
                  max_images=max_images)
