#!/usr/bin/env python3
"""Measure a sampler of the port on one CUDA card.

    python3 ccdm_tpu_torch/tools/profile_sampler.py [--config flagship|cityscapes]
                                                    [--encoder-reuse R] [--root DIR]
                                                    [--quant off|dynamic|static]
                                                    [--sampler both|graphs|eager]
                                                    [--split]

`--config flagship` (the default): the model `chip_smoke.py` runs (flagship
LIDC config, bf16, seeded random weights with the zero-initialised leaves
redrawn) through `make_prob_sampler`, 8 images x 16 samples.
`--config cityscapes`: `CityscapesEvaluator` on `CITYSCAPES_EVAL_PARAMS`
(256x512, C=20, base 128, DINO ViT-S/8, bf16; seeded random weights, the
UNet's zero leaves redrawn), the protocol batch of 2 images x 1 vote,
with encoder reuse R (default 1).
`--quant dynamic|static` builds either with `quantized_inference` (int8
convs, `ops/quant.py`): dynamic scales, or static scales calibrated on the
run's first two images; `--quant off` is the default.

- `sites`: the GroupNorm and attention calls of one UNet call, by shape,
  each timed alone through its wrapper (`chip_smoke.time_ms`: device time of
  back-to-back calls), with the per-step sum over all sites; for
  Cityscapes also the DINO encoder's time per run;
- `cold`, `warm`: wall time of 250-step runs (the process's first, then
  `WARM_RUNS` more), samples or images per second, K2's launches a step by
  the input's layout (`ops/group_norm.layout_launches`: NCHW, or
  channels-last on the inference torso), and the SM clock after each.

`--split` runs the `split` phase instead: the program's own spans and
marks (`utils/trace.py`), read back, with tracing on from before the
kernels' load. `setup`: the set-up's stages (`setup_stages`); `call`:
`SPLIT_CALLS` traced calls, each split by `call_split` into its host ms
outside the reverse steps, its spans, DINO's device ms and each step
graph's unet / posterior / noise / draw device ms; `host_ms`: their
median and range; `cost`: `SPLIT_CALLS` calls with tracing off and as
many on, in turns; `profiled`: one traced call under `torch.profiler`,
its host ms, and the marked steps plus the call's other device time over
K beside the device's busy ms a step (`profiled_check`).

Device time by kernel and the device's idle share come from the
benchmark's traced runs (`python3 benchmark/run.py ... --trace 1`: its
breakdown and per-layer metrics).

`--sampler` picks how the sampler runs: `graphs`, the default of
`make_prob_sampler` on the card (CUDA graphs of the step, replayed; the
cold run captures them), `eager` (`graphs=False`, the loop that launches
every op from the host), or `both` (the default here: eager, then graphs,
each on its own sampler); every line says which in `sampler`.

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
from typing import Callable, Dict, List, NamedTuple, Optional

REPO = Path(__file__).resolve().parents[2]
WARM_RUNS = 2
SPLIT_CALLS = 6
STEP_SPANS = ("sampler.steps", "sampler.capture")  # a call's reverse steps
SETUP_SPANS = ("setup.kernels", "setup.model", "setup.dino")


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


class Workload(NamedTuple):
    unet: object          # the UNet module, for the site hooks
    unit: str             # what a run yields: "samples" or "images"
    count: int            # how many of them a run yields
    make_run: Callable    # (steps, graphs) -> a callable that runs the sampler once
    forward: Callable     # one UNet call at the run's shapes
    dino: Optional[Callable] = None  # the DINO encoder on the run's images


def sampler_kwargs(graphs: bool) -> dict:
    """`make_prob_sampler`'s keywords for the mode: none for the graphs (the
    default, and the only form an earlier checkout under `--root` takes)."""
    return {} if graphs else {"graphs": False}


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

    def make_run(steps, graphs):
        kw = ({"encoder_reuse": reuse} if reuse > 1 else {}) | sampler_kwargs(graphs)
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

    def make_run(steps, graphs):
        # predict_batch's sampler, built here so that eager can be asked for
        run = make_prob_sampler(ev.model, ev.num_evaluations, steps, feature_fn=ev.feature_fn,
                                encoder_reuse=reuse, **sampler_kwargs(graphs))
        return lambda: run(ev.model.unet, images, 6, feature_net=ev.feature_net).mean(1)

    def forward():
        feats = ev.feature_fn(ev.feature_net, images)
        return ev.model.apply(ev.model.unet,
                              torch.zeros(smoke.CS_IMAGES, *smoke.CS_HW, 20, device="cuda"),
                              images, torch.full((smoke.CS_IMAGES,), 5, device="cuda"), feats)

    return Workload(ev.model.unet, "images", smoke.CS_IMAGES, make_run, forward,
                    lambda: ev.feature_fn(ev.feature_net, images))


def sites(work: Workload, smoke) -> None:
    """Time each GroupNorm and attention site of one UNet call alone."""
    import torch

    from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn

    if hasattr(work.unet, "lay_out_weights"):  # a checkout without it: as built
        work.unet.lay_out_weights(True)  # the layout the sampler gives the forward
    calls = collections.Counter()
    hooks = []

    def on_norm(mod, args, kwargs):
        x = args[0]
        nhwc = not x.is_contiguous() and x.movedim(1, -1).is_contiguous()
        calls[("gn", tuple(x.shape), x.dtype, mod.groups,
               bool(kwargs.get("silu", args[1] if len(args) > 1 else False)),
               kwargs.get("add") is not None, nhwc)] += 1

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
            _, shape, dtype, groups, silu, with_add, nhwc = key
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            if nhwc:  # the site's layout: channels innermost
                x = x.movedim(1, -1).contiguous().movedim(-1, 1)
            w = torch.ones(shape[1], device="cuda")
            b = torch.zeros(shape[1], device="cuda")
            # without the add: the one form both versions' wrappers take
            ms = smoke.time_ms(lambda: gn.group_norm(x, w, b, groups, silu=silu))
            nbytes = 2 * x.numel() * x.element_size() + 8 * shape[1]
            bound, _ = smoke.bound_ms(nbytes, x.numel() * (6 + 3 * silu), "float32")
            plan = gn._plan(shape, dtype, groups, **({"nhwc": True} if nhwc else {}))
            emit("site", kernel="group_norm", shape=list(shape), dtype=str(dtype)[6:],
                 silu=silu, add_site=with_add, layout="nhwc" if nhwc else "nchw", count=count,
                 ms=ms, bound_ms=bound, path=plan.path)
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
    if work.dino is not None:
        with torch.inference_mode():
            emit("dino", ms=smoke.time_ms(work.dino, reps=3, calls=5))


def runs(work: Workload, smoke, warm: int, graphs: bool) -> None:
    import torch

    from ccdm_tpu_torch.ops import group_norm as gn

    run = work.make_run(smoke.STEPS, graphs)
    for i in range(warm + 1):
        layouts = dict(getattr(gn, "layout_launches", {}))  # a checkout without it: none
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        # K2's launches a step by the input's layout (NCHW or channels-last)
        per_step = {k: (v - layouts[k]) / smoke.STEPS
                    for k, v in getattr(gn, "layout_launches", {}).items()}
        emit("cold" if i == 0 else "warm", sampler=mode_name(graphs), wall_s=wall,
             unit=work.unit, per_s=work.count / wall, ms_per_step=wall / smoke.STEPS * 1e3,
             group_norm_layouts_per_step=per_step,
             clock_temp=smi("clocks.sm,temperature.gpu"))


def mode_name(graphs: bool) -> str:
    return "graphs" if graphs else "eager"


def setup_stages(records) -> Dict[str, float]:
    """The set-up's stages in seconds from a traced process's spans:
    `kernels` (`setup.kernels`: the kernels' build or load), `model`
    (`setup.model` and `setup.dino`) and `first_call` (the first
    `sampler.call`: its eager steps and captures), each less the stages
    nested in it, so that they do not overlap."""
    from ccdm_tpu_torch.utils import trace

    first = next((r for r in records if r.name == "sampler.call"), None)
    stages = {"kernels": 0.0, "model": 0.0, "first_call": 0.0}
    for r in records:
        stage = ("kernels" if r.name == "setup.kernels" else
                 "model" if r.name in ("setup.model", "setup.dino") else
                 "first_call" if r is first else None)
        if stage is not None:
            stages[stage] += trace.self_ms(r, records, SETUP_SPANS) * 1e-3
    return stages


def call_split(call, records, replays: Dict[str, int]) -> Dict:
    """One traced sampler call (its `sampler.call` span), read after the
    device has finished it: `host_ms`, its host time outside the reverse
    steps; `spans_ms`, each span inside it; `dino_ms`, DINO's device ms
    between its marks (None without DINO); `parts_ms`, each step graph's
    parts (its last replay), or under "eager" the eager loop's, summed over
    the steps; `marked_steps_ms`, the parts of every step of the call, by
    `replays`: how often each graph label (or "eager", once) runs a call.
    The eager loop's `step` gaps (between one step's end and the next
    one's start) are no part of a step."""
    from ccdm_tpu_torch.utils import trace

    inner = []
    for r in records:
        p = r.parent
        while p is not None and p is not call:
            p = p.parent
        if p is call:
            inner.append(r)
    by_name = {r.name: r for r in inner}
    steps = by_name.get("sampler.steps")
    if steps is None:
        parts = {}
    elif steps.attached:
        parts = {label: marks.ms() for label, marks in steps.attached.items()}
    else:
        parts = {"eager": steps.marks.ms()}
    dino = by_name.get("dino.features")
    return {"host_ms": trace.self_ms(call, records, STEP_SPANS),
            "spans_ms": {r.name: r.ms for r in inner},
            "dino_ms": dino.marks.ms().get("dino") if dino is not None else None,
            "parts_ms": parts,
            "marked_steps_ms": sum(replays.get(label, 0) * sum(
                v for k, v in ms.items() if k != "step") for label, ms in parts.items())}


def graph_replays(steps: int, reuse: int, graphs: bool) -> Dict[str, int]:
    """How often each step graph replays in a warm call (`call_split`)."""
    if not graphs:
        return {"eager": 1}
    from ccdm_tpu_torch.diffusion.sampling import graph_label, step_plan

    return dict(collections.Counter(graph_label(*kind) for kind in step_plan(steps, reuse)))


def union_ms(intervals: List) -> float:
    """The length of the union of `(start_ns, end_ns)` intervals, in ms."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        a = a if reach is None else max(a, reach)
        if b > a:
            total += b - a
            reach = b
    return total * 1e-6


def profiled_check(events, split: Dict, steps: int) -> Dict:
    """One traced call under `torch.profiler`: its host ms outside the steps
    (the spans', which the profiler's events of the same names match: what
    the benchmark's `call_host_ms.*` read), and the device's busy ms a step
    (the union of the call's device operations over K, as
    `step_device_ms.*`) beside the marked steps plus the call's other device
    ms over K, where `other` is the busy time of the device operations that
    no graph replay launched."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != cuda]
    dev = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()]
    launches = {e.correlation_id() for e in host if e.name() == "cudaGraphLaunch"}
    replayed = [e for e in dev if launches & {e.correlation_id(), e.linked_correlation_id()}]
    busy = union_ms([(e.start_ns(), e.end_ns()) for e in dev])
    other = busy - union_ms([(e.start_ns(), e.end_ns()) for e in replayed]) if replayed else None
    return {"host_ms": split["host_ms"],
            "step_device_ms": busy / steps,
            "replay_kernels": len(replayed), "other_device_ms": other,
            "predicted_step_device_ms": (None if other is None else
                                         (split["marked_steps_ms"] + other) / steps)}


def split(work: Workload, smoke, graphs: bool, reuse: int, since: float, stages: bool) -> None:
    """The `split` phase (see the module's docstring) on one sampler mode;
    tracing is on. `stages`: the first call is the process's, so the
    set-up's stages end with it (`since`: `perf_counter` at `main`'s start)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity

    from ccdm_tpu_torch.utils import trace

    calls = SPLIT_CALLS
    mode = mode_name(graphs)
    replays = graph_replays(smoke.STEPS, reuse, graphs)

    def traced_call():
        trace.clear()  # each call's records are read, then dropped
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        records = trace.records()
        call = next(r for r in records if r.name == "sampler.call")
        return wall, call_split(call, records, replays)

    run = work.make_run(smoke.STEPS, graphs)
    run()  # the first call: the eager steps and captures
    torch.cuda.synchronize()
    if stages:
        emit("setup", seconds_since_main=time.perf_counter() - since,
             **{f"{k}_s": v for k, v in setup_stages(trace.records()).items()})
    host = []
    for i in range(calls):
        wall, parts = traced_call()
        host.append(parts["host_ms"])
        emit("call", sampler=mode, call=i, wall_s=wall, **parts)
    emit("host_ms", sampler=mode, calls=calls, median=statistics.median(host),
         low=min(host), high=max(host))

    walls: Dict[bool, list] = {False: [], True: []}
    for i in range(calls + 1):  # the first untraced call captures its own graphs
        for on in (False, True):
            (trace.enable if on else trace.disable)()
            trace.clear()
            torch.cuda.synchronize()
            start = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if i:
                walls[on].append(time.perf_counter() - start)
    trace.enable()
    off, on = statistics.median(walls[False]), statistics.median(walls[True])
    emit("cost", sampler=mode, off_s=walls[False], on_s=walls[True],
         on_over_off_pct=100.0 * (on / off - 1.0))

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, parts = traced_call()
    emit("profiled", sampler=mode, steps=smoke.STEPS,
         **profiled_check(list(prof.profiler.kineto_results.events()), parts, smoke.STEPS))
    trace.clear()


def main() -> None:
    since = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("flagship", "cityscapes"), default="flagship")
    ap.add_argument("--encoder-reuse", type=int, default=1,
                    help="R: the UNet encoder runs on every R-th step (default 1)")
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose ccdm_tpu_torch to measure (default: this one)")
    ap.add_argument("--quant", choices=("off", "dynamic", "static"), default="off",
                    help="int8 convs: dynamic or calibrated static scales (default off)")
    ap.add_argument("--sampler", choices=("both", "graphs", "eager"), default="both",
                    help="the sampler's CUDA graphs, its eager loop, or both in turn "
                         "(default both)")
    ap.add_argument("--split", action="store_true",
                    help="the split phase alone: the program's spans and marks, read back")
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
         config=args.config, encoder_reuse=args.encoder_reuse, quant=args.quant,
         sampler=args.sampler)
    from ccdm_tpu_torch.ops import _build

    if args.split:
        from ccdm_tpu_torch.utils import trace

        trace.enable()
        _build.library()  # the build or the load: the span `setup.kernels`
    else:
        emit("build", seconds=_build.build())
    workload = {"flagship": flagship, "cityscapes": cityscapes}[args.config]
    work = workload(smoke, args.encoder_reuse, args.quant)
    modes = {"both": (False, True), "graphs": (True,), "eager": (False,)}[args.sampler]
    for i, graphs in enumerate(modes):
        if args.split:
            split(work, smoke, graphs, args.encoder_reuse, since, stages=i == 0)
        else:
            runs(work, smoke, WARM_RUNS, graphs)
    if not args.split:
        sites(work, smoke)
    print(json.dumps({"done": True}), flush=True)


if __name__ == "__main__":
    main()
