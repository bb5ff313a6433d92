"""The Cityscapes evaluator's sampling: `eval.cityscapes_eval.
CityscapesEvaluator.predict_batch`, the DINO ViT-S/8 key facet of each
image and the index-state sampler on its default route (CUDA graphs of the
reverse step), returning the mean over the votes of the probability maps,
`[images, H, W, C]` a call."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.drivers.sampling import SamplerCell
from benchmark.reference.diffusion import Diffusion
from benchmark.reference.dino import key_features
from benchmark.reference.sampler import run_chains
from benchmark.reference.unet import UNet


class Cell(SamplerCell):
    unit = "images"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device):
        super().__init__(cfg, traffic, seed, device)
        from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator

        params = self.params()
        params["evaluation"] = dict(params.get("evaluation") or {},
                                    evaluations=self.s,
                                    evaluation_vote_strategy=self.traffic["vote"])
        self.evaluator = CityscapesEvaluator(params)
        if self.evaluator.num_classes != self.c:
            raise ValueError(f"the evaluator has {self.evaluator.num_classes} classes, the "
                             f"configuration {self.c}")
        self.evaluator.build((self.h, self.w, self.ci), self.b, device=self.device)
        self.weights = self.draw_weights(self.evaluator.model.unet, "unet", xt=True)
        self.dino = self.draw_weights(self.evaluator.feature_net, "dino")

    def run_call(self, images, indices):
        return self.evaluator.predict_batch(images, self.seed, indices)

    def chain_output(self, call, row, sample):
        if self.s != 1:
            raise ValueError("a chain of the evaluator's output is its only vote")
        return self.outputs[call][row].float()

    def dino_cost(self):
        fce = self.cfg["feature_cond_encoder"]
        return {"images": self.b, "dim": int(fce["channels"]), "patch": 8,
                "stride": int(fce["output_stride"]), "source_layer": int(fce["source_layer"])}

    def free(self) -> None:
        del self.evaluator
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self):
        """`(images, ids) -> maps` of the plain reference, fp32 with TF32 off:
        DINO's keys, then the chain."""
        unet = UNet(self.cfg, self.weights)
        diff = Diffusion(int(self.cfg["time_steps"]), self.c, self.device)
        fce = self.cfg["feature_cond_encoder"]

        def run(images, ids):
            with torch.no_grad():
                feats = key_features(self.dino, images, heads=int((fce.get("vit_config") or {}).get("num_heads", 6)), patch=8,
                                     stride=int(fce["output_stride"]),
                                     source_layer=int(fce["source_layer"]))
                return run_chains(unet, diff, self.seed, ids, images, feats,
                                  vote=self.traffic["vote"],
                                  encoder_reuse=int(self.traffic.get("encoder_reuse", 1)))
        return run
