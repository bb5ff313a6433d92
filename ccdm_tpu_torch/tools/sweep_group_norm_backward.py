#!/usr/bin/env python3
"""Time the GroupNorm backward kernel under other plans than the one
`ops/group_norm._plan_backward` picks, on one CUDA card.

    python3 ccdm_tpu_torch/tools/sweep_group_norm_backward.py

For each training site below (batch 16, bf16 or fp32, SiLU, with or without
the ResBlock's add) it times the kernel (`chip_smoke.time_ms`) at the
planned path and at:

- path M with every cluster size from the least that holds the slab to 8
  (`_MB_CHUNK_BYTES` bounds a block's chunk, so larger clusters mean
  smaller chunks);
- path S with every team of 1-8 warps that holds the slab, and path M with
  the least cluster, for the slabs that either can take.

Each plan's dx is held against the plain version (max |diff| over the
largest |plain dx|, 1e-2 bf16 and 1e-4 fp32) before it is timed. This is
the measurement behind the plan's limits (S up to 512 vectors, the least
cluster for M). One JSON object per line; the last says `{"done": true}`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# (shape at batch 16, dtype name, with the add)
SITES = [
    ((16, 32, 128, 128), "bfloat16", False), ((16, 32, 128, 128), "bfloat16", True),
    ((16, 64, 128, 128), "bfloat16", False), ((16, 32, 128, 128), "float32", False),
    ((16, 32, 128, 256), "bfloat16", True), ((16, 64, 128, 256), "bfloat16", False),
    ((16, 96, 64, 128), "bfloat16", False), ((16, 64, 64, 128), "bfloat16", True),
    ((16, 32, 64, 128), "bfloat16", True), ((16, 64, 64, 64), "bfloat16", False),
    ((16, 448, 16, 32), "bfloat16", False), ((16, 64, 32, 64), "bfloat16", True),
    ((16, 64, 32, 32), "bfloat16", True), ((16, 128, 4, 8), "bfloat16", True),
]


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


def alternatives(gn, shape, dtype, planned):
    """The plans to time beside `planned` (see the docstring)."""
    hw = math.prod(shape[2:])
    slab = shape[1] // 32 * hw
    vec = planned.vec
    plans = [planned]
    # the least cluster whose blocks hold at most `_MB_CHUNK_BYTES` and `_MAX_TILES` tiles
    least = max(math.ceil(slab * dtype.itemsize / gn._MB_CHUNK_BYTES),
                math.ceil(slab / gn._longest_chunk(hw, vec)))
    for cluster in range(least, gn._M_MAX_CLUSTER + 1):
        plans.append(gn.Plan("M", vec, cluster,
                             math.ceil(math.ceil(slab / cluster) / vec) * vec))
    vectors = math.ceil(slab / vec)
    if shape[1] // 32 <= gn._SB_MAX_CHANNELS:
        for warps in (1, 2, 4, 8):
            packs = gn._pow2(math.ceil(vectors / (32 * warps)))
            if packs <= 2:
                plans.append(gn.Plan("S", vec, packs, warps))
    return list(dict.fromkeys(plans))


def main() -> None:
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke_tools", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_group_norm_backward: needs a CUDA card")
    from ccdm_tpu_torch.ops import _build
    from ccdm_tpu_torch.ops import group_norm as gn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    emit("device", card=card, torch=torch.__version__, build_s=_build.build())
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, dtype_name, with_add in SITES:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        b = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        e = torch.randn(shape[:2], generator=gen, device="cuda").to(dtype) if with_add else None
        ref = gn.torch_group_norm_backward(dy, x, w, b, 32, silu=True, add=e)[0].float()
        limit = 1e-2 if dtype == torch.bfloat16 else 1e-4
        planned = gn._plan_backward(shape, dtype, 32)
        times = []
        for plan in alternatives(gn, shape, dtype, planned):
            err = float((gn._launch_backward(plan, dy, x, w, b, 32, 1e-5, True, e)[0].float()
                         - ref).abs().max()) / float(ref.abs().max())
            if not err <= limit:
                raise AssertionError(f"{shape} {dtype_name} {plan}: dx err/max {err}")
            ms = smoke.time_ms(lambda: gn._launch_backward(plan, dy, x, w, b, 32, 1e-5, True, e))
            times.append({"path": plan.path, "param": plan.param, "chunk": plan.chunk,
                          "planned": plan == planned, "ms": ms, "err_over_max": err})
        emit("site", shape=list(shape), dtype=dtype_name, add=with_add, plans=times)
    print(json.dumps({"done": True}), flush=True)


if __name__ == "__main__":
    main()
