"""The LIDC sampler: `eval.lidc_uncertainty.make_prob_sampler`, the batched
multi-sample generation of the LIDC evaluation, on its default route (CUDA
graphs of the reverse step, replayed T times a call). Returns
`[images, samples, H, W, C]` maps a call."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.drivers.sampling import SamplerCell
from benchmark.reference.diffusion import Diffusion
from benchmark.reference.sampler import run_chains
from benchmark.reference.unet import UNet


class Cell(SamplerCell):
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device):
        super().__init__(cfg, traffic, seed, device)
        from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
        from ccdm_tpu_torch.models.builder import build_model

        self.model = build_model(self.params(), num_classes=self.c, image_channels=self.ci,
                                 image_size=self.h, device=self.device)
        self.weights = self.draw_weights(self.model.unet, "unet", xt=True)
        self.sampler = make_prob_sampler(self.model, self.s,
                                         encoder_reuse=int(traffic.get("encoder_reuse", 1)))

    def run_call(self, images, indices):
        return self.sampler(self.model.unet, images, self.seed, indices)

    def free(self) -> None:
        del self.model, self.sampler
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self):
        """`(images, ids) -> maps` of the plain reference, fp32 with TF32 off."""
        unet = UNet(self.cfg, self.weights)
        diff = Diffusion(int(self.cfg["time_steps"]), self.c, self.device)

        def run(images, ids):
            with torch.no_grad():
                return run_chains(unet, diff, self.seed, ids, images, None,
                                  vote=self.traffic["vote"],
                                  encoder_reuse=int(self.traffic.get("encoder_reuse", 1)))
        return run
