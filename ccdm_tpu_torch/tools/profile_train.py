#!/usr/bin/env python3
"""Measure a training step of the port on one CUDA card.

    python3 ccdm_tpu_torch/tools/profile_train.py [--config flagship|cityscapes|cityscapes_dino]
                                                  [--steps N]

`--config flagship` (the default): `TrainingRun(DEMO_TRAIN_PARAMS)`, the
flagship LIDC model (128x128, C=2, base 32) on synthetic LIDC. `cityscapes`:
`TrainingRun(CITYSCAPES_TRAIN_PARAMS)` (128x256, C=20, base 32, class
weights zeroing the ignore class) on a synthetic tree of 32 train images at
256x512 (`chip_smoke.write_cityscapes_tree`, the release's 1024x2048 cut by
4 a side), through the config's host pipeline (flip, resize, colour
jitter, normalisation). `cityscapes_dino`: the same with the frozen DINO
ViT-S/8 (random weights). All at batch 16, bf16 torso, fp32 masters, Adam
and the Polyak EMA, with PyTorch's default TF32 settings (what `run_train`
runs).

- `loop`: the trainer's own loop (`TrainingRun.run`: the step replayed as
  a CUDA graph, data loading, the pinned-memory prefetch and the metric
  reads two launches behind included, no validation or save inside the
  window): the cold launches up to the graph's capture (its eager warm-up
  steps), then the mean ms/step and images/s over `--steps` warm steps
  (rounded up to whole launches), replays of the graph;
- `phases`: per eager step (the step's parts driven one by one, no
  graph), the device-stream span of the DINO map (0 without
  DINO), the forward (with the loss), the backward and the update
  (optimizer, EMA, the masters written into the bf16 module), from CUDA
  events around each, and the host's time per step, over 20 steps driven
  back to back on one batch;
- `profile`: 10 such steps under `torch.profiler`: device time per step by
  kernel family, the device's busy share of the wall, the 25 largest
  kernels, and the 25 host operators with the most CPU time of their own;
- `group_norm_sites`: the step's GroupNorm sites (hooks on one step), the
  bound of all of them for the forward and for the backward
  (`chip_smoke.group_norm_bound`), the profile's family time beside it and
  its share of the bound, and the backward's sites by `_plan_backward` path
  (`tools/time_group_norm_backward.py` times each site's backward alone);
- `loader` (Cityscapes configs): the ms of one batch of 16 from a tree at
  the release's 1024x2048 (PNG decode and the config's pipeline on the
  host, `mp_loaders: 0` as the config runs), the decode and pipeline ms of
  one image, and the ms a batch over 4 batches with a pool of 8 loader
  threads (`mp_loaders: 8`).

One JSON object per line; the last line says `{"done": true}`.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PHASE_STEPS = 20
PROFILE_STEPS = 10

# kernel families of the profile, by a substring of the device kernel's name
FAMILIES = [
    ("group_norm_backward", ("gn_backward",)),
    ("group_norm", ("gn_small", "gn_cluster", "gn_partial_stats", "gn_apply")),
    ("attention_forward", ("attn_fwd",)),
    ("optimizer_ema", ("multi_tensor_apply", "foreach")),
    ("conv_layout", ("nchwToNhwc", "nhwcToNchw", "transpose")),
    ("conv_wgrad", ("wgrad",)),
    ("conv_dgrad", ("dgrad",)),
    ("conv_fprop", ("xmma_fprop", "implicit_gemm", "fprop", "conv", "winograd")),
    ("gemm", ("gemm", "cublas", "cutlass")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
]


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise_other"


def cityscapes_tree(smoke, root: Path, n: int, hw) -> None:
    """A synthetic Cityscapes train tree of `n` images at `hw`, and 4 val."""
    shutil.rmtree(root, ignore_errors=True)
    smoke.write_cityscapes_tree(root, n, "train", hw, seed=smoke.EVAL_SEED + 1)
    smoke.write_cityscapes_tree(root, 4, "val", hw, seed=smoke.EVAL_SEED + 2)


def measure_loader(smoke, params) -> None:
    """The host data path at the release's 1024x2048 (see the docstring)."""
    import numpy as np

    from ccdm_tpu_torch.data import cityscapes
    from ccdm_tpu_torch.data.loader import EpochLoader
    from ccdm_tpu_torch.utils.png import read_png

    root = REPO / "build/profile_train/tree_1024x2048"
    start = time.perf_counter()
    cityscapes_tree(smoke, root, 16, smoke.CS_LABEL_HW)
    written = time.perf_counter() - start
    ds = cityscapes.training_dataset(params, base_path=str(root))
    start = time.perf_counter()
    batch = next(EpochLoader(ds, 16, seed=0).epoch(0))
    serial = time.perf_counter() - start
    start = time.perf_counter()
    img = read_png(ds.image_files[0], mode="RGB")
    lbl = cityscapes.labels_to_categories(read_png(ds.label_files[0]))
    decode = time.perf_counter() - start
    start = time.perf_counter()
    ds.pipeline(img, lbl, np.random.default_rng(0), None)
    pipeline = time.perf_counter() - start
    # four batches through a pool of 8 threads: the 16 files indexed 4 times
    pooled = cityscapes.CityscapesDataset(ds.image_files * 4, ds.label_files * 4, ds.pipeline)
    start = time.perf_counter()
    n = sum(1 for _ in EpochLoader(pooled, 16, seed=0, num_workers=8).epoch(0))
    threads = (time.perf_counter() - start) / n
    emit("loader", tree=f"{smoke.CS_LABEL_HW[0]}x{smoke.CS_LABEL_HW[1]}", written_s=written,
         batch_shape=list(batch["image"].shape), ms_per_batch_of_16=serial * 1e3,
         ms_per_image={"decode": decode * 1e3, "pipeline": pipeline * 1e3},
         ms_per_batch_with_8_threads=threads * 1e3, cores=os.cpu_count())


def emit_site_bounds(smoke, sites, by_family) -> None:
    """The bound of the step's GroupNorm sites, forward and backward, beside
    the profile's family times (see the docstring)."""
    from ccdm_tpu_torch.ops import group_norm as gn

    bound = collections.Counter()
    paths = collections.Counter()
    for (shape, dtype, groups, silu, add), count in sites.items():
        fwd, _ = smoke.group_norm_bound(shape, dtype.itemsize, silu, add)
        bwd, _ = smoke.group_norm_bound(shape, dtype.itemsize, silu, add, backward=True)
        bound["group_norm"] += count * fwd
        bound["group_norm_backward"] += count * bwd
        paths[gn._plan_backward(shape, dtype, groups).path] += count
    emit("group_norm_sites", sites=sum(sites.values()), backward_sites_by_path=dict(paths),
         **{fam: {"ms_per_step": by_family[fam], "bound_ms": bound[fam],
                  "share_of_bound": bound[fam] / by_family[fam] if by_family[fam] else None}
            for fam in ("group_norm", "group_norm_backward")})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("flagship", "cityscapes", "cityscapes_dino"),
                    default="flagship")
    ap.add_argument("--steps", type=int, default=60, help="warm steps of the loop")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke_tools", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    import ccdm_tpu_torch
    from ccdm_tpu_torch.data.loader import device_prefetch
    from ccdm_tpu_torch.models.layers import GroupNorm32
    from ccdm_tpu_torch.ops import _build
    from ccdm_tpu_torch.train.step import WARMUP_STEPS, step_seed, train_loss
    from ccdm_tpu_torch.train.trainer import STEP_KEYS, TrainingRun, _class_weights

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    emit("device", card=card, torch=torch.__version__, config=args.config,
         build_s=_build.build())
    out = REPO / "build/profile_train"
    params = {"flagship": ccdm_tpu_torch.DEMO_TRAIN_PARAMS,
              "cityscapes": ccdm_tpu_torch.CITYSCAPES_TRAIN_PARAMS,
              "cityscapes_dino": ccdm_tpu_torch.CITYSCAPES_DINO_TRAIN_PARAMS}[args.config]
    if args.config != "flagship":
        cityscapes_tree(smoke, out / "tree", 32, smoke.CS_TREE_HW)
        os.environ["CCDM_CITYSCAPES_PATH"] = str(out / "tree")
    never = 10 ** 9
    run = TrainingRun(dict(params, output_path=str(out / "run"), save_freq=never,
                           validation_freq=never, display_freq=never, progress_bar=False))
    run.checkpoints.save_periodic = lambda state: None  # no save inside the windows

    torch.cuda.synchronize()
    start = time.perf_counter()
    # the graph's eager warm-up steps and its capture
    run.run(max_steps=WARMUP_STEPS + 1)
    torch.cuda.synchronize()
    cold = time.perf_counter() - start
    start, step0 = time.perf_counter(), run.state.step
    run.run(max_steps=args.steps)  # to the first launch boundary at or past it
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    warm = run.state.step - step0
    emit("loop", cold_steps=step0, cold_s=cold, warm_steps=warm,
         steps_per_launch=run.steps_per_launch, ms_per_step=wall / warm * 1e3,
         images_per_s=run.batch_size * warm / wall,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    # the step's phases, as make_train_step runs them (a frozen encoder or none)
    batch = next(device_prefetch(({k: b[k] for k in STEP_KEYS}
                                  for b in run.loader.epoch(0)), run.device))
    state, net, model = run.state, run.net, run.model
    weights = _class_weights(run.module, run.num_classes, run.device)

    def step(events=None):
        gen = torch.Generator(device=run.device).manual_seed(step_seed(1, state.step))
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        net.zero_grad(set_to_none=True)
        mark(0)
        fc = None
        if run.encoder is not None:
            with torch.no_grad():
                fc = run.encoder(run.encoder_net, batch["image"])
        mark(1)
        loss, _ = train_loss(model, net, batch, gen, weights, fc)
        mark(2)
        loss.backward()
        mark(3)
        grads = {n: p.grad.float() for n, p in net.named_parameters()}
        torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values()))))
        state.apply_gradients(grads)
        state.write_to(net)
        mark(4)

    sites = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, kwargs: sites.update([(tuple(args[0].shape), args[0].dtype, mod.groups,
                                                 bool(kwargs.get("silu", False)),
                                                 kwargs.get("add") is not None)]),
        with_kwargs=True) for m in net.modules() if isinstance(m, GroupNorm32)]
    step()
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    spans = collections.Counter()
    start = time.perf_counter()
    for _ in range(PHASE_STEPS):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        step(events)
        events[4].synchronize()
        for name, (a, b) in (("dino", (0, 1)), ("forward", (1, 2)), ("backward", (2, 3)),
                             ("update", (3, 4))):
            spans[name] += events[a].elapsed_time(events[b]) / PHASE_STEPS
    host = (time.perf_counter() - start) / PHASE_STEPS * 1e3
    emit("phases", device_span_ms=dict(spans), host_ms_per_step=host,
         note="each step waits for its last event: spans hold no overlap across steps")

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_family, by_kernel = collections.Counter(), collections.Counter()
    device_ms = 0.0
    for evt in prof.key_averages():
        self_dev = getattr(evt, "self_device_time_total", None)
        if self_dev is None:
            self_dev = evt.self_cuda_time_total
        if evt.device_type == torch.autograd.DeviceType.CUDA and self_dev > 0:
            ms = self_dev / 1e3
            device_ms += ms
            by_family[family(evt.key)] += ms / PROFILE_STEPS
            by_kernel[evt.key] += ms / PROFILE_STEPS
    emit("profile", steps=PROFILE_STEPS, wall_ms_per_step=wall * 1e3 / PROFILE_STEPS,
         device_ms_per_step=device_ms / PROFILE_STEPS, busy_share=device_ms / (wall * 1e3),
         ms_per_step_by_family=dict(by_family.most_common()))
    for name, ms in by_kernel.most_common(25):
        emit("profile_kernel", name=name[:160], ms_per_step=ms, family=family(name))
    emit_site_bounds(smoke, sites, by_family)
    # the host: operators by their own CPU time (the launches included)
    host = [(evt.self_cpu_time_total / 1e3 / PROFILE_STEPS, evt.count / PROFILE_STEPS, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CPU]
    emit("host", ms_per_step=sum(h[0] for h in host),
         ops_per_step=sum(h[1] for h in host))
    for ms, calls, name in sorted(host, reverse=True)[:25]:
        emit("host_op", name=name[:120], self_ms_per_step=ms, calls_per_step=calls)
    if args.config != "flagship":
        measure_loader(smoke, params)
    print(json.dumps({"done": True}), flush=True)


if __name__ == "__main__":
    main()
