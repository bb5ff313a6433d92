"""Cityscapes inference (port of `ccdm_tpu/eval/cityscapes_eval.py`).

Ported: the evaluator's settings, `build` (the model, the DINO encoder and
the sampler of an eval config), `predict_batch` (the confidence vote: the
mean of the votes' probability maps) and `predict_labels` (the upsample to
the original resolution, the ignore channel dropped, the argmax). Not
ported yet: the dataset loop, the confusion matrix, the PNG dumps and the
official scoring, int8 and meshes.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import torch

from ccdm_tpu_torch.config import with_defaults
from ccdm_tpu_torch.eval.lidc_uncertainty import (
    build_eval_feature_fn,
    load_eval_params,
    make_prob_sampler,
)
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.models.dino import resize_bilinear

LOGGER = logging.getLogger(__name__)

# `ccdm_tpu/data/cityscapes.py`: 19 evaluated train ids and the ignore class
NUM_CLASSES = 20
BACKGROUND_CLASS = 19


class CityscapesEvaluator:
    def __init__(self, params: Dict[str, Any]):
        params = with_defaults(params)
        self.params = params
        self.num_classes = NUM_CLASSES
        self.ignore = BACKGROUND_CLASS
        eval_cfg = params.get("evaluation") or {}
        self.eval_resolution = eval_cfg.get("resolution", "dataloader")
        self.vote_strategy = eval_cfg.get("evaluation_vote_strategy", "confidence")
        self.num_evaluations = int(eval_cfg.get("evaluations", 1))
        if self.eval_resolution not in ("original", "dataloader"):
            raise ValueError(f"unknown evaluation resolution {self.eval_resolution!r}")
        if self.num_evaluations > 1 and self.vote_strategy != "confidence":
            raise NotImplementedError("a majority vote over several evaluations")

    def build(self, image_shape: Tuple[int, int, int], batch_size: int, *, device=None):
        """The model (image_size = min(H, W) picks the channel multipliers),
        the DINO encoder and the sampler for `[B,H,W,Ci]` batches of at most
        `batch_size` images, on `device` (default: the CUDA card). The UNet
        evaluates the EMA weights of the `load_from` checkpoint; without one
        its weights are random, drawn from the config's seed."""
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
        self.sampler = make_prob_sampler(
            self.model, self.num_evaluations, feature_fn=self.feature_fn,
            encoder_reuse=int(self.params.get("encoder_reuse", 1)))

    def predict_batch(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                      **noise) -> torch.Tensor:
        """`[B,H,W,3]` -> the mean over votes of the probability maps,
        `[B,H,W,C]`. `noise` (`prior`, `uniforms`, `gumbel`) injects the
        draws, as `make_prob_sampler`'s run takes them."""
        if images.shape[0] > self.batch_size:
            raise ValueError(f"a batch of {images.shape[0]} images; built for "
                             f"{self.batch_size}")
        probs = self.sampler(self.model.unet, images, generator,
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
