#!/usr/bin/env python3
"""Measure a sampler of the port on one CUDA card.

    python3 ccdm_tpu_torch/tools/profile_sampler.py [--config flagship|cityscapes]
                                                    [--encoder-reuse R] [--root DIR]
                                                    [--quant off|dynamic|static]

`--config flagship` (the default): the model `chip_smoke.py` runs (flagship
LIDC config, bf16, seeded random weights with the zero-initialised leaves
redrawn) through `make_prob_sampler`, 8 images x 16 samples.
`--config cityscapes`: `CityscapesEvaluator` on `CITYSCAPES_EVAL_PARAMS`
(256x512, C=20, base 128, DINO ViT-S/8, bf16; seeded random weights, the
UNet's zero leaves redrawn), the protocol batch of 2 images x 1 vote,
with encoder reuse R (default 1).
`--quant dynamic|static` builds either with `quantized_inference` (int8
convs, `ops/quant.py`): dynamic scales, or static scales calibrated on the
run's first two images; the profile's `quant_conv` family is the int8
kernel, beside `conv_compute` (cuDNN) of `--quant off`, the default.

- `sites`: the GroupNorm and attention calls of one UNet call, by shape,
  each timed alone through its wrapper (`chip_smoke.time_ms`: device time of
  back-to-back calls), with the per-step sum over all sites; for
  Cityscapes also the DINO encoder's time per run;
- `cold`, `warm`: wall time of 250-step runs (the process's first, then
  `WARM_RUNS` more), samples or images per second, and the SM clock after
  each;
- `profile`: one 10-step run under `torch.profiler`: device time by kernel
  family per step, the device's busy share of the wall, and the
  `aten::add` calls per step.

`--root DIR` imports `ccdm_tpu_torch` from another checkout (an earlier
commit unpacked with `git archive`, say), so two versions are measured by
the same code, in turns, on one card. The wrappers are called only through
the arguments both versions take (the Cityscapes config needs a checkout
that has it). One JSON object per line; the last line says
`{"done": true}`.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

REPO = Path(__file__).resolve().parents[2]
WARM_RUNS = 2
PROFILE_STEPS = 10

# kernel families of the profile, by a substring of the device kernel's name
FAMILIES = [
    ("quant_conv", ("quant_conv_ring", "quant_conv_tile", "quant_conv_epilogue")),
    ("group_norm", ("gn_small", "gn_cluster", "gn_partial_stats", "gn_apply")),
    ("attention", ("attn_fwd",)),
    ("conv_layout", ("nchwToNhwc", "nhwcToNchw", "transpose")),
    ("conv_compute", ("xmma_fprop", "implicit_gemm", "fprop", "conv", "dgrad", "winograd")),
    ("gemm", ("gemm", "cublas", "cutlass")),
    ("add", ("CUDAFunctor_add", "AddFunctor")),
]


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


class Workload(NamedTuple):
    unet: object          # the UNet module, for the site hooks
    unit: str             # what a run yields: "samples" or "images"
    count: int            # how many of them a run yields
    make_run: Callable    # steps -> a callable that runs the sampler once
    forward: Callable     # one UNet call at the run's shapes


def quant_params(quant: str) -> dict:
    """The config keys of a `--quant` mode (none for "off")."""
    return {} if quant == "off" else {"quantized_inference": quant if quant == "static" else True}


def flagship(smoke, reuse: int, quant: str = "off") -> Workload:
    import torch

    from ccdm_tpu_torch import FLAGSHIP_PARAMS
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model

    params = dict(FLAGSHIP_PARAMS, step_T_sample="confidence", **quant_params(quant))
    model = build_model(params, num_classes=2, image_channels=1, image_size=128,
                        device="cuda", generator=torch.Generator().manual_seed(0))
    smoke.unzero_(model.unet, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randn(smoke.IMAGES, 128, 128, 1, generator=gen, device="cuda")
    if quant == "static":
        from ccdm_tpu_torch.ops import quant as q

        model = q.calibrate_static_scales(model, model.unet, images[:2])
    n = smoke.IMAGES * smoke.SAMPLES

    def make_run(steps):
        kw = {"encoder_reuse": reuse} if reuse > 1 else {}
        run = make_prob_sampler(model, num_samples=smoke.SAMPLES, num_steps=steps, **kw)
        return lambda: run(model.unet, images, 2)

    def forward():
        return model.apply(model.unet, torch.zeros(n, 128, 128, 2, device="cuda"),
                           images.repeat_interleave(smoke.SAMPLES, 0),
                           torch.full((n,), 5, device="cuda"))

    return Workload(model.unet, "samples", n, make_run, forward)


def cityscapes(smoke, reuse: int, quant: str = "off") -> Workload:
    import torch

    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler

    ev = CityscapesEvaluator(dict(CITYSCAPES_EVAL_PARAMS, encoder_reuse=reuse,
                                  **quant_params(quant if quant != "static" else "dynamic")))
    ev.build((*smoke.CS_HW, 3), smoke.CS_IMAGES, device="cuda")
    smoke.unzero_(ev.model.unet, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.randn(smoke.CS_IMAGES, *smoke.CS_HW, 3, generator=gen, device="cuda")
    if quant == "static":  # calibrated after the zero leaves are redrawn
        from ccdm_tpu_torch.ops import quant as q

        ev.model = q.calibrate_static_scales(ev.model, ev.model.unet, images,
                                             feature_fn=ev.feature_fn, feature_net=ev.feature_net)
        ev.sampler = make_prob_sampler(ev.model, ev.num_evaluations, feature_fn=ev.feature_fn,
                                       encoder_reuse=reuse)
    with torch.inference_mode():
        emit("dino", ms=smoke.time_ms(lambda: ev.feature_fn(ev.feature_net, images),
                                      reps=3, calls=5), shape=[smoke.CS_IMAGES, *smoke.CS_HW, 3])

    def make_run(steps):
        if steps == ev.model.time_steps:
            return lambda: ev.predict_batch(images, 6)
        run = make_prob_sampler(ev.model, ev.num_evaluations, steps, feature_fn=ev.feature_fn,
                                encoder_reuse=reuse)
        return lambda: run(ev.model.unet, images, 6, feature_net=ev.feature_net).mean(1)

    def forward():
        feats = ev.feature_fn(ev.feature_net, images)
        return ev.model.apply(ev.model.unet,
                              torch.zeros(smoke.CS_IMAGES, *smoke.CS_HW, 20, device="cuda"),
                              images, torch.full((smoke.CS_IMAGES,), 5, device="cuda"), feats)

    return Workload(ev.model.unet, "images", smoke.CS_IMAGES, make_run, forward)


def sites(work: Workload, smoke) -> None:
    """Time each GroupNorm and attention site of one UNet call alone."""
    import torch

    from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn

    calls = collections.Counter()
    hooks = []

    def on_norm(mod, args, kwargs):
        calls[("gn", tuple(args[0].shape), args[0].dtype, mod.groups,
               bool(kwargs.get("silu", args[1] if len(args) > 1 else False)),
               kwargs.get("add") is not None)] += 1

    def on_attn(mod, args):
        b, c, h, w = args[0].shape
        heads = mod.num_heads
        calls[("attn", b * heads, c // heads, h * w, args[0].dtype)] += 1

    for m in work.unet.modules():
        if isinstance(m, GroupNorm32):
            hooks.append(m.register_forward_pre_hook(on_norm, with_kwargs=True))
        elif isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_pre_hook(on_attn))
    with torch.inference_mode():
        work.forward()
    for h in hooks:
        h.remove()

    gen = torch.Generator(device="cuda").manual_seed(3)
    totals = collections.Counter()
    for key, count in sorted(calls.items(), key=lambda kv: str(kv[0])):
        if key[0] == "gn":
            _, shape, dtype, groups, silu, with_add = key
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.ones(shape[1], device="cuda")
            b = torch.zeros(shape[1], device="cuda")
            # without the add: the one form both versions' wrappers take
            ms = smoke.time_ms(lambda: gn.group_norm(x, w, b, groups, silu=silu))
            nbytes = 2 * x.numel() * x.element_size() + 8 * shape[1]
            bound, _ = smoke.bound_ms(nbytes, x.numel() * (6 + 3 * silu), "float32")
            emit("site", kernel="group_norm", shape=list(shape), dtype=str(dtype)[6:],
                 silu=silu, add_site=with_add, count=count, ms=ms, bound_ms=bound,
                 path=gn._plan(shape, dtype, groups).path)
            totals["group_norm"] += count * ms
            totals["group_norm_bound"] += count * bound
        else:
            _, bh, dh, t, dtype = key
            qkv = torch.randn(bh, 3 * dh, t, generator=gen, device="cuda").to(dtype)
            q, k, v = qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]
            ms = smoke.time_ms(lambda: fa.flash_attention(q, k, v))
            bound, _ = smoke.bound_ms(4 * bh * dh * t * qkv.element_size(),
                                      4 * bh * t * t * dh, str(dtype)[6:])
            emit("site", kernel="flash_attention", bh=bh, t=t, dh=dh, dtype=str(dtype)[6:],
                 count=count, ms=ms, bound_ms=bound)
            totals["flash_attention"] += count * ms
            totals["flash_attention_bound"] += count * bound
    emit("sites_per_step", **{k: v for k, v in totals.items()},
         group_norm_sites=sum(c for k, c in calls.items() if k[0] == "gn"),
         attention_sites=sum(c for k, c in calls.items() if k[0] == "attn"))


def runs(work: Workload, smoke, warm: int) -> None:
    import torch

    run = work.make_run(smoke.STEPS)
    for i in range(warm + 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        emit("cold" if i == 0 else "warm", wall_s=wall, unit=work.unit,
             per_s=work.count / wall, ms_per_step=wall / smoke.STEPS * 1e3,
             clock_temp=smi("clocks.sm,temperature.gpu"))


def profile(work: Workload, steps: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity

    run = work.make_run(steps)
    run()  # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    # device time: the kernels', memcpys' and memsets' own time; the CPU-side
    # rows (cudaLaunchKernel and the like) are not device time
    by_family = collections.Counter()
    by_kernel = collections.Counter()
    device_ms = 0.0
    adds = {}
    for evt in prof.key_averages():
        self_dev = getattr(evt, "self_device_time_total", None)
        if self_dev is None:
            self_dev = evt.self_cuda_time_total
        if evt.key in ("aten::add", "aten::add_"):
            adds[evt.key] = {"calls_per_step": evt.count / steps}
        if evt.device_type == torch.autograd.DeviceType.CUDA and self_dev > 0:
            ms = self_dev / 1e3
            device_ms += ms
            by_family[family(evt.key)] += ms / steps
            by_kernel[evt.key] += ms / steps
    emit("profile", steps=steps, wall_ms=wall * 1e3, device_ms=device_ms,
         busy_share=device_ms / (wall * 1e3), ms_per_step_by_family=dict(by_family),
         adds=adds)
    for name, ms in by_kernel.most_common(25):
        emit("profile_kernel", name=name[:160], ms_per_step=ms, family=family(name))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("flagship", "cityscapes"), default="flagship")
    ap.add_argument("--encoder-reuse", type=int, default=1,
                    help="R: the UNet encoder runs on every R-th step (default 1)")
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose ccdm_tpu_torch to measure (default: this one)")
    ap.add_argument("--quant", choices=("off", "dynamic", "static"), default="off",
                    help="int8 convs: dynamic or calibrated static scales (default off)")
    args = ap.parse_args()

    root = args.root.resolve()
    sys.path.insert(0, str(root))
    # this checkout's chip_smoke.py: its timing and bounds, whichever root is measured
    spec = importlib.util.spec_from_file_location("chip_smoke_tools", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_sampler: needs a CUDA card")
    import ccdm_tpu_torch

    if Path(ccdm_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {ccdm_tpu_torch.__file__}, not the one under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", root=str(root), card=smi("name,power.limit"), torch=torch.__version__,
         config=args.config, encoder_reuse=args.encoder_reuse, quant=args.quant)
    from ccdm_tpu_torch.ops import _build

    emit("build", seconds=_build.build())
    workload = {"flagship": flagship, "cityscapes": cityscapes}[args.config]
    work = workload(smoke, args.encoder_reuse, args.quant)
    runs(work, smoke, WARM_RUNS)
    profile(work, PROFILE_STEPS)
    sites(work, smoke)
    print(json.dumps({"done": True}), flush=True)


if __name__ == "__main__":
    main()
