#!/usr/bin/env python3
"""Time the int8 conv kernel at every int8 site of the port's UNet calls, in
the checkout given, on one CUDA card.

    python3 ccdm_tpu_torch/tools/time_quant_conv.py [--root DIR]

`--root` (default: this repo) is the checkout whose `ccdm_tpu_torch` is
imported and whose kernels are built there, so that two commits' kernels
can be timed on one card in one call: run this once per checkout, in the
order A, B, B, A. The sites are those chip_smoke's phase 21 times: the int8
convs of a flagship UNet call at batch 32 (the harness's 2 x 16) and 128
and of a Cityscapes call at batch 2, bf16 on a static scale. Each distinct
site is run through the checkout's own `quant_conv` on inputs seeded by
the site (the same in every checkout), checked bit for bit against its
plain version, and timed (`chip_smoke.time_ms`) beside its bound
(`chip_smoke.quant_bound`); `digest` sums the output, so two checkouts'
lines show that they computed the same. Then, per call, the sum over its
sites. One JSON object per line; the last says `{"done": true}`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import zlib
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# call -> (the package's params name, classes, image channels, (H, W), DINO channels, batches)
CALLS = {
    "flagship": ("FLAGSHIP_PARAMS", 2, 1, (128, 128), 0, (32, 128)),
    "cityscapes": ("CITYSCAPES_EVAL_PARAMS", 20, 3, (256, 512), 384, (2,)),
}


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
        raise SystemExit("time_quant_conv: needs a CUDA card")
    import ccdm_tpu_torch
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.ops import _build
    from ccdm_tpu_torch.ops import quant

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    emit("device", card=card, root=str(args.root), package=quant.__file__,
         build_s=_build.build())
    for call, (name, classes, channels, hw, features, batches) in CALLS.items():
        model = build_model(dict(getattr(ccdm_tpu_torch, name), quantized_inference=True),
                            classes, channels, min(hw))
        inputs = [torch.zeros(1, *hw, classes, device="cuda"),
                  torch.zeros(1, *hw, channels, device="cuda"), torch.full((1,), 5, device="cuda")]
        if features:
            inputs.append(torch.zeros(1, hw[0] // 8, hw[1] // 8, features, device="cuda"))
        sites = smoke.quant_site_shapes(model.unet, *inputs)
        del model
        for batch in batches:
            ms_sum = bound_sum = 0.0
            for (chw, k, stride, cout), count in sorted(sites.items()):
                shape = (batch, *chw)
                gen = torch.Generator(device="cuda").manual_seed(
                    zlib.crc32(repr((shape, k, stride, cout)).encode()))
                x = (torch.randn(shape, generator=gen, device="cuda") * 2).to(torch.bfloat16)
                weight = torch.randn(cout, chw[0], k, k, generator=gen,
                                     device="cuda") / math.sqrt(chw[0] * k * k)
                bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
                w_q, s_w = quant.weight_codes(weight)
                s_x = quant.static_act_scale(x.abs().amax() * 0.7)
                pad = (k - 1) // 2
                out = quant.quant_conv(x, w_q, s_w, bias, s_x, k, stride, pad)
                if not torch.equal(out, quant.quant_conv_plain(x, w_q, s_w, bias, s_x, k,
                                                               stride, pad)):
                    raise AssertionError(f"time_quant_conv {shape} k{k} s{stride} -> {cout}: "
                                         f"kernel != plain")
                ms = smoke.time_ms(lambda: quant.quant_conv(x, w_q, s_w, bias, s_x, k, stride,
                                                            pad))
                bound, by = smoke.quant_bound(x, w_q, out, k, cout)
                ms_sum += count * ms
                bound_sum += count * bound
                emit("site", call=call, shape=list(shape), kernel=k, stride=stride, cout=cout,
                     sites=count, ms=ms, bound_ms=bound, bound_by=by,
                     digest=float(out.double().sum()))
                del x, out
                torch.cuda.empty_cache()
            emit("call", call=call, batch=batch, sites=sum(sites.values()), ms=ms_sum,
                 bound_ms=bound_sum, share_of_bound=bound_sum / ms_sum)
    print(json.dumps({"done": True}), flush=True)


if __name__ == "__main__":
    main()
