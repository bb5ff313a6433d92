"""Each cell of `BENCHMARK.json` cut to a size that the CPU runs in seconds:
the same configuration file, traffic file and limits, with narrower and
shallower shapes (`cut(workload)`)."""

from __future__ import annotations

import copy
from typing import Dict, Tuple

from benchmark import common

UNET = {"base_channels": 16, "image_size": 32, "channel_mult": [1, 2, 2],
        "attention_resolutions": [2, 4], "num_heads": 1, "num_head_channels": 8,
        "softmax_output": True}
# input block 10 runs at ds 8 in four levels, as DINO's concat needs
UNET_DINO = dict(UNET, image_size=64, channel_mult=[1, 1, 1, 2], attention_resolutions=[8])
VIT = {"embed_dim": 48, "depth": 3, "num_heads": 6, "patch_size": 8}


def cut(workload: str, seed_images: int = 2, time_steps: int = 20) -> Tuple[Dict, Dict, Dict]:
    """`(workload entry, configuration, traffic)` of `workload` at the CPU's
    size: T = `time_steps`, images of 32 (64x128 with DINO), base 16, and
    at most 2 chains of `seed_images` images a call (the check follows as
    many of them as the traffic's `check_chains` asks for)."""
    work, cfg, traffic = common.cell(workload)
    cfg, traffic = copy.deepcopy(cfg), dict(traffic)
    cfg["time_steps"] = time_steps
    if cfg.get("feature_cond_encoder", {}).get("type") == "dino":
        cfg["image_shape"], cfg["unet_openai"] = [64, 128], dict(UNET_DINO)
        cfg["feature_cond_encoder"].update(vit_config=VIT, source_layer=2,
                                           channels=VIT["embed_dim"])
    else:
        cfg["image_shape"], cfg["unet_openai"] = [32, 32], dict(UNET)
    traffic.update(images=seed_images, samples=min(int(traffic["samples"]), 2))
    return work, cfg, traffic
