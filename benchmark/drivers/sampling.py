"""Sampler cells: whole calls of one of the program's sampler entry points,
back to back (a closed loop of one client), each on new images.

A traffic file names its driver and gives:

- `images`, `samples`: a call's images, and chains (votes) an image;
- `vote`: how the last step resolves ("confidence": probability maps);
- `image_std`: the images are N(0, image_std^2) pixels, made on the card;
- `quantized_inference`, `encoder_reuse`: the program's fast-evaluation
  switches;
- `trace_calls`: the whole calls a traced run records;
- `check_chains`: chains, drawn from the seed among every call of the
  window, that the reference follows again: spread evenly over a call's
  batch rows (`check_picks`), so that a fault confined to some rows of
  the batch shows in the picks.

Every chain's noise is the stream of its element id `image * samples +
sample`, with `image` the image's global index over the run
(`call * images + b`), so any chain of any call can be followed alone.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import weights
from benchmark.common import busy_s, family_s, sub_seed
from benchmark.cost import model as cost
from benchmark.cost.peaks import PEAK_OPS_PER_S

# the weights of the UNet's input conv that read the one-hot state x_t are
# scaled by this: a random UNet whose output leans on x_t as hard as on the
# image is chaotic along the chain (two fp32 implementations' maps part
# after a few hundred steps), where a trained denoiser contracts
XT_GAIN = 0.05
FAMILIES = {"k2": ("gn_small", "gn_cluster", "gn_partial_stats", "gn_apply"),
            "k1": ("attn_fwd",), "k3": ("quant_conv",)}


def check_picks(seed: int, calls: int, rows: int, n: int) -> List[int]:
    """`n` chains of `calls` calls of `rows` chains each, as sorted indices
    `call * rows + row`: pick i takes a row of stratum i (of `min(n, rows)`
    equal strata of the rows, in turn) and a call, both drawn from `seed`,
    and no chain twice."""
    rng = np.random.default_rng(seed)
    n = min(n, calls * rows)
    strata = min(n, rows)
    picks: set = set()
    for i in range(n):
        k = i % strata
        lo, hi = k * rows // strata, (k + 1) * rows // strata
        p = int(rng.integers(calls)) * rows + int(rng.integers(lo, hi))
        while p in picks:
            p = int(rng.integers(calls)) * rows + int(rng.integers(lo, hi))
        picks.add(p)
    return sorted(picks)


# what the per-layer readers (`metrics/*.sample.py`, `*.eval.py`) take from
# a sampler cell's traced calls; None where the run traced none
def _traced(run):
    t = run.trace
    return t if t is not None and t.work["kind"] == "sample" and t.device_ops else None


def step_device_ms(run):
    """Device-busy milliseconds a reverse step: the union of the device's
    operations over the traced window, over the steps replayed in it."""
    t = _traced(run)
    return None if t is None else busy_s(t) / t.work["steps"] * 1e3


def idle_share(run):
    """The share of the traced window in which no operation ran on the device."""
    t = _traced(run)
    return None if t is None else 100.0 * (1.0 - busy_s(t) / t.window_s)


def roofline(run, family: str):
    """Kernel family `family` ("k1", "k2"): the summed least time of its
    sites in the traced calls (`benchmark/cost/`), over its kernel time."""
    t = _traced(run)
    spent = family_s(t, FAMILIES[family]) if t is not None else None
    return 100.0 * t.work["cost"][f"{family}_bound_s"] * t.work["calls"] / spent if spent else None


def mfu(run):
    """The model FLOPs of the UNet calls (and of DINO's keys) that the traced
    calls completed, over the traced window, over the bf16 dense peak."""
    t = _traced(run)
    if t is None:
        return None
    return 100.0 * t.work["cost"]["flops"] * t.work["calls"] / t.window_s / PEAK_OPS_PER_S[
        "bfloat16"]


class SamplerCell:
    unit = "samples"  # what a call completes: its chains, or ("images") its images
    kind = "sample"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        self.b, self.s = int(traffic["images"]), int(traffic["samples"])
        self.h, self.w = cfg["image_shape"]
        self.ci, self.c = int(cfg["image_channels"]), int(cfg["num_classes"])
        self.outputs: List[torch.Tensor] = []

    # inputs ------------------------------------------------------------
    def params(self) -> Dict:
        """The program's params: the configuration with the cell's switches."""
        p = {k: v for k, v in self.cfg.items()
             if k not in ("source", "reduced", "assumed", "image_shape")}
        p["step_T_sample"] = self.traffic["vote"]
        for key in ("quantized_inference", "encoder_reuse"):
            if key in self.traffic:
                p[key] = self.traffic[key]
        return p

    def images(self, call: int) -> torch.Tensor:
        """Call `call`'s images `[B,H,W,Ci]` (call -1: the warm-up's)."""
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "images", call))
        return torch.randn((self.b, self.h, self.w, self.ci), generator=gen,
                           device=self.device) * float(self.traffic.get("image_std", 1.0))

    def indices(self, call: int) -> torch.Tensor:
        return call * self.b + torch.arange(self.b, device=self.device)

    def draw_weights(self, module: torch.nn.Module, role: str, xt: bool = False):
        w = weights.draw(module, sub_seed(self.seed, role), self.device)
        if xt:
            w["input_blocks.0.0.weight"][:, :self.c] *= XT_GAIN
        weights.load(module, w)
        return w

    # the window ----------------------------------------------------------
    def call(self, i: int) -> int:
        """Run call `i`, keep its maps on the host, return its units."""
        out = self.run_call(self.images(i), self.indices(i))
        self.outputs.append(out.to("cpu"))
        return self.b * self.s if self.unit == "samples" else self.b

    def warm(self) -> None:
        """One whole call on the warm-up's images: it captures the graphs."""
        self.run_call(self.images(-1), self.indices(0)).to("cpu")

    @property
    def steps_per_call(self) -> int:
        return int(self.cfg["time_steps"])

    def cost(self) -> Dict[str, float]:
        return cost.sampler_call(self.cfg, self.b * self.s, self.h, self.w, self.steps_per_call,
                                 int(self.traffic.get("encoder_reuse", 1)), self.dino_cost())

    def dino_cost(self):
        return None

    # the check -----------------------------------------------------------
    def check(self, reference) -> Dict[str, float]:
        """Follow `check_chains` chains drawn from the seed among every call
        of the window (`check_picks`) with `reference(images, ids) -> maps`,
        and compare them with the program's maps: the mean over their pixels
        of the total variation distance between the two probability maps,
        and the widest chain's mean."""
        picks = check_picks(sub_seed(self.seed, "check"), len(self.outputs), self.b * self.s,
                            int(self.traffic["check_chains"]))
        gaps = []
        batch = int(self.traffic.get("check_batch", len(picks)))
        for start in range(0, len(picks), batch):
            group = picks[start:start + batch]
            calls = [p // (self.b * self.s) for p in group]
            rows = [(p // self.s) % self.b for p in group]
            ids = torch.tensor([(c * self.b + r) * self.s + p % self.s
                                for c, r, p in zip(calls, rows, group)], device=self.device)
            imgs = torch.stack([self.images(c)[r] for c, r in zip(calls, rows)])
            want = reference(imgs, ids).float()
            got = torch.stack([self.chain_output(c, r, p % self.s)
                               for c, r, p in zip(calls, rows, group)]).to(self.device)
            gaps.append(0.5 * (got - want).abs().sum(dim=-1).mean(dim=(1, 2)))
        gaps = torch.cat(gaps)
        return {"mean_tv": float(gaps.mean()), "worst_chain_tv": float(gaps.max())}

    def chain_output(self, call: int, row: int, sample: int) -> torch.Tensor:
        return self.outputs[call][row, sample].float()
