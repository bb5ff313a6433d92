#!/usr/bin/env python3
"""Time the GroupNorm backward kernel at every GroupNorm site of the port's
train steps, in the checkout given, on one CUDA card.

    python3 ccdm_tpu_torch/tools/time_group_norm_backward.py [--root DIR]

`--root` (default: this repo) is the checkout whose `ccdm_tpu_torch` is
imported and whose kernels are built there, so that two commits' kernels
can be timed on one card in one call: run this once per checkout, in the
order A, B, B, A. The sites are those of the flagship, the Cityscapes and
the DINO-conditioned Cityscapes train steps at batch 16
(`training_sites`). Each distinct site (shape, dtype, SiLU, add) is timed
once (`chip_smoke.time_ms`, seeded random inputs) beside its bound
(`chip_smoke.group_norm_bound`); then, per config, the sum over the step's
sites. One JSON object per line; the last says `{"done": true}`.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BATCH = 16
# config -> (the package's params name, classes, image channels, (H, W), DINO channels)
CONFIGS = {
    "flagship": ("DEMO_TRAIN_PARAMS", 2, 1, (128, 128), 0),
    "cityscapes": ("CITYSCAPES_TRAIN_PARAMS", 20, 3, (128, 256), 0),
    "cityscapes_dino": ("CITYSCAPES_DINO_TRAIN_PARAMS", 20, 3, (128, 256), 384),
}


def training_sites(config: str, batch: int = BATCH) -> collections.Counter:
    """(shape at `batch`, dtype, groups, SiLU, has the add) -> GroupNorm
    calls per UNet call of the config's train step, from hooks on a
    batch-1 forward of its UNet on the CPU."""
    import torch

    import ccdm_tpu_torch
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.models.layers import GroupNorm32

    name, classes, channels, hw, features = CONFIGS[config]
    model = build_model(getattr(ccdm_tpu_torch, name), classes, channels, min(hw),
                        device="cpu")
    calls = collections.Counter()

    def on_norm(mod, args, kwargs):
        add = kwargs.get("add", args[2] if len(args) > 2 else None)
        silu = kwargs.get("silu", args[1] if len(args) > 1 else False)
        calls[((batch, *args[0].shape[1:]), args[0].dtype, mod.groups, bool(silu),
               add is not None)] += 1

    hooks = [m.register_forward_pre_hook(on_norm, with_kwargs=True)
             for m in model.unet.modules() if isinstance(m, GroupNorm32)]
    feats = torch.zeros(1, hw[0] // 8, hw[1] // 8, features) if features else None
    with torch.no_grad():
        model.unet(torch.zeros(1, *hw, classes), torch.zeros(1, *hw, channels),
                   torch.tensor([5]), feats)
    for h in hooks:
        h.remove()
    return calls


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose ccdm_tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_tools", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_group_norm_backward: needs a CUDA card")
    from ccdm_tpu_torch.ops import _build
    from ccdm_tpu_torch.ops import group_norm as gn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    emit("device", card=card, root=str(args.root), package=gn.__file__,
         build_s=_build.build())
    steps = {config: training_sites(config) for config in CONFIGS}
    gen = torch.Generator(device="cuda").manual_seed(4)
    times = {}
    for site in sorted(set().union(*steps.values()), key=str):
        shape, dtype, groups, silu, add = site
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        b = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        e = torch.randn(shape[:2], generator=gen, device="cuda").to(dtype) if add else None
        ms = smoke.time_ms(lambda: gn.group_norm_backward(dy, x, w, b, groups, silu=silu,
                                                          add=e))
        bound, _ = smoke.group_norm_bound(shape, dtype.itemsize, silu, add, backward=True)
        plan = getattr(gn, "_plan_backward", None)  # absent from checkouts before it
        times[site] = (ms, bound)
        emit("site", shape=list(shape), dtype=str(dtype)[6:], silu=silu, add=add,
             path=plan(shape, dtype, groups).path if plan else None, ms=ms, bound_ms=bound,
             share_of_bound=bound / ms)
        del x, dy, e
    for config, sites in steps.items():
        ms = sum(count * times[site][0] for site, count in sites.items())
        bound = sum(count * times[site][1] for site, count in sites.items())
        emit("step", config=config, sites=sum(sites.values()), ms=ms, bound_ms=bound,
             share_of_bound=bound / ms)
    print(json.dumps({"done": True}), flush=True)


if __name__ == "__main__":
    main()
