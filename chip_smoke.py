#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ccdm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing its result:

1. device: requires CUDA (no CPU fallback); prints the card and its power
   limit; turns TF32 off so fp32 comparisons are fp32.
2. build: compiles `ccdm_tpu_torch/csrc/*.cu`, one nvcc per source started
   together, into `build/ccdm_tpu_torch/`; prints the seconds and any kernel
   that spills registers.
3. group_norm: the GroupNorm(+SiLU) kernel against its plain PyTorch version
   at the flagship sampler's shapes (B = 8 images x 16 samples = 128), with
   and without the fused time-embedding add, at shapes that force each of
   its paths (S, M with clusters of 1, 4 and 8 blocks, L in bf16 and fp32),
   at the Cityscapes sampler's sites (B = 2 images x 1 vote, 256x512,
   base 128: path L at 768 KB-2 MB slabs, the DINO concat's 640 channels),
   and at the Cityscapes train step's (batch 16 at 128x256, base 32, the
   DINO concat's 448 channels at ds 8).
4. attention: the attention kernel against its plain version at the
   flagship's attention shapes, at T = 70 (element loads), at T = 2048 (many
   K/V tiles), with 64-channel heads, at the Cityscapes sites (BH 16 x
   T 2048, 32 x 512, 32 x 128), at the flagship train step's (48 x 256,
   64 x 64) and at the Cityscapes train step's (32 x 512, 64 x 128, 64 x
   32).
   Phases 3 and 4 print, per case, the max-abs error, the device time of the
   kernel, of the plain version and of the one PyTorch call that computes
   the same function where there is one (`F.group_norm` without SiLU or add,
   `F.scaled_dot_product_attention`; timed here, never called by the port),
   and the bound: the larger of the bytes moved (each input read once, each
   output written once) over 3.35 TB/s and the operations over the peak
   rate of their type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s fp32).
5. slice: the flagship LIDC model (128x128, C=2, base 32, bf16, seeded
   random weights with the zero-initialised leaves redrawn) samples 8 images
   x 16 samples x 250 steps through `make_prob_sampler`; the output must be
   finite probabilities of shape [8,16,128,128,2], and each kernel's launch
   count must equal its sites per UNet call x 250 (split by kernel path).
6. reference: on a small input, the fp32 sampler on the card (kernels, the
   model built on the default device) against the same sampler on the CPU
   (plain versions), same noise.
7. cityscapes: `CityscapesEvaluator` at the full width of
   `CITYSCAPES_EVAL_PARAMS` (256x512, C=20, base 128, DINO ViT-S/8, bf16
   torso; seeded random UNet and DINO weights, the UNet's zero leaves
   redrawn) predicts 2 images x 1 vote x 250 steps, then labels at
   1024x2048; once with encoder reuse R = 1 and once with R = 3. Each run
   checks the votes' shape and sums, the labels' range, the DINO map's
   shape, and that the launches are exactly GroupNorm 81 x full UNet calls
   + 51 x replays and attention 16 x full + 10 x replays.
8. cityscapes_reference: the fp32 Cityscapes evaluator on the card against
   the CPU, 1 image of 64x128, 2 votes, T = 3, DINO on, same noise.
9. group_norm_backward: the GroupNorm backward kernel against its plain
   version at the flagship's and the Cityscapes train step's sites (batch
   16), at shapes that force each of its paths (S; M with clusters of 1, 2,
   4 and 8 blocks and chunk boundaries inside channels; L in bf16 and fp32;
   element loads at H*W = 169 and 1521; H*W of 65, 81 and 96, past one
   tile and not a multiple of it, on M and L, the last on views 2 bytes
   off their storage), with and without SiLU and the add:
   each case's path as `_plan_backward` plans it and as the launch counts
   show, errors of dx, dweight, dbias and dadd, two calls bit for bit equal;
   kernel, plain, library (autograd's backward of `F.group_norm`, where it
   computes the same function) and bound times (read x and dy, write dx).
10. attention_backward: the attention's autograd Function (the kernel's
   forward, the JAX package's backward math in PyTorch) against autograd
   through the plain `dense_attention`, at the training sites [48,32,256]
   and [64,32,64] in bf16 and fp32, at [16,32,2048] (the streaming
   branch) and at the Cityscapes train step's [32,32,512], [64,32,128] and
   [64,32,32]; backward, plain, library (SDPA's backward) and bound times.
11. train: `TrainingRun(DEMO_TRAIN_PARAMS)` at full width and depth on the
   card (128x128, C=2, base 32, batch 16, bf16, synthetic LIDC), 30 steps
   with a periodic save and a GED/HM-IoU validation at step 20, into
   `build/chip_smoke_train/`. Checks a finite loss and no invalid flag at
   every step, launches of exactly 66 GroupNorm forward + 66 backward + 11
   attention a step plus the validation sampler's sites x UNet calls, the
   backward's launches by path equal to `_plan_backward`'s path of every
   GroupNorm call that autograd recorded (as in 18 and 19), GED
   in [0, 2] and HM-IoU in [0, 1], and that a new `TrainingRun` loading the
   checkpoint holds the same params, EMA, Adam state and step, bit for bit,
   and that the validation wrote its qualitative grid. Prints the cold
   first step, the warm s/step and images/s of steps 11-30 (validation,
   grid and saves taken out), peak memory and the validation's seconds.
12. train_reference: one train step on the card (kernels, TF32 off) against
   the CPU (plain versions), injected t and x_t. First fp32 at flagship
   widths, 32x32 input, batch 2: loss within 1e-5 relative, every gradient
   within 1e-4 of its tensor's largest magnitude. Then at the LIDC gate's
   training geometry: `DEMO_TRAIN_PARAMS` at 128x128, batch 2 of synthetic
   lesions, from the masters phase 11 trained, so attention runs at T 256
   and 64 and the GroupNorm backward takes its path-M sites (15 in bf16,
   24 in fp32): fp32 under
   the same rule, and the same step with TF32 left on (the step's
   `fp32_precision` taken out), which must break it; then bf16 (the
   gate's torso) against the CPU's bf16 run, the same rule per tensor
   with bf16's limits: loss within 1e-4 relative, every gradient within
   0.1 of its tensor's largest (bf16 roundings after sums in two orders
   move a tensor's gradient by a few percent of its largest), the
   analytically zero ones within 1e-5 of the tree's largest; the card's
   fp32 step against the CPU's bf16 step is printed beside it (bf16's own
   rounding). The steps go through `make_train_step` under PyTorch's
   default TF32 setting, as the trainer runs: the step keeps its fp32
   convolutions in fp32 itself.
13. eval_lidc: `eval_lidc_uncertainty` at the flagship's full width (bf16,
   T = 250, evaluations 1/4/8/16, batch 2) with the weights phase 11
   saved, on 8 synthetic lesions that the phase writes as a PNG tree in the
   LIDC crop release's layout (`datasets.lidc_orig`, 180x180, 4 masks).
   Checks the count, GED in [0, 2], HM-IoU, Dice and IoU in [0, 1], the
   results JSON, and launches of exactly 66 and 11 x 250 x 4 batches.
   Prints the harness's samples/s against the bare sampler's of phase 5,
   the host seconds of PNG decode and of the metrics, and peak memory.
14. eval_invariance: fp32 (TF32 off), T = 10, each of 4 images' 16 samples
   from one batch of 4 against batches of 1 with the global indices: maps
   agree on >= 99.9% of pixels, probabilities within 1e-4 where they
   agree. Then the noise stream's device time in a bf16 flagship step at
   8 x 16 (Gumbel of [128,128,128,2]) against the whole step's.
15. sampling_speed: the default step sweep (250 ... 10) of the harness on
   2 images x 16 samples; samples/s per step count; launches exactly the
   sites x 785 steps.
16. cityscapes_eval: `run_inference` on `CITYSCAPES_EVAL_PARAMS` over a
   2-image val tree of 1024x2048 RGB, 8-bit labelIds and 16-bit
   instanceIds PNGs that the phase writes, with seeded random UNet weights
   handed in as a `load_from` checkpoint: 1 vote x 250 steps at 256x512,
   labels at the original resolution. Checks 2 images, mIoU in [0, 1] or
   NaN, the official JSON with class and instance scores, 2 submission
   PNGs that read back at 1024x2048, launches of 81 and 16 x 250. Prints
   wall, images/s and the ms per image of decode, resize, sampling, dumps
   and scoring.
17. eval_cli: `python -m ccdm_tpu_torch.cli.eval` in a subprocess on a
   `.json` params file (the LIDC branch, 2 images, T = 10, the card by
   default): exit 0 and its results JSON.
18. cityscapes_train: `TrainingRun(CITYSCAPES_TRAIN_PARAMS)` at full width
   on the card (128x256, C=20, base 32, mult (1,1,2,2,4,4), attention at ds
   {8,16,32}, batch 16, bf16, the class weights), reading a synthetic tree
   of 32 train and 4 val scenes at 256x512 (the release's 1024x2048 cut by
   4 a side) written under `build/chip_smoke_cs_train/`, through the
   config's host pipeline; 30 steps with a save and an mIoU validation at
   step 20 (`dataset_val_max_size` 4). Checks a finite loss and no invalid
   flag, launches of exactly 81 GroupNorm forward + 81 backward + 16
   attention a step plus the validation's sites x UNet calls, val and
   train-split mIoU in [0, 1] or NaN, a `best_miou/20` checkpoint, the
   grid, and a bit-exact reload (params, EMA, Adam, step). Prints the cold
   step, warm ms/step and images/s of steps 11-30 (validation, grid and
   saves out), peak memory and the validation's seconds.
19. cityscapes_train_dino: `CITYSCAPES_DINO_TRAIN_PARAMS` (ViT-S/8, random
   weights) on the same tree, 10 steps with a validation at step 10, once
   frozen and once trainable: the frozen encoder bit-identical after the
   run and absent from the checkpoint, the trainable one's masters and EMA
   moved and stored under `feature_cond_encoder` /
   `average_feature_cond_encoder`, launches exact as in 18; ms/step of
   each and the DINO forward's share. Then `CityscapesEvaluator` with
   `load_from` on the trainable run holds its EMA encoder bit for bit and
   predicts 1 image x 1 vote x 250 steps (launches 81 and 16 x 250).
20. cityscapes_train_reference: one fp32 train step (Cityscapes widths,
   32x64, batch 2, C=20 with the class weights, a trainable tiny DINO,
   injected t and x_t) on the card (kernels, TF32 off) against the CPU
   (plain versions): loss within 1e-5 relative, every UNet and encoder
   gradient within 1e-4 of its tensor's largest magnitude (analytic zeros
   as in 12).

21. quant_conv: the int8 conv kernel (`csrc/quant_conv.cu`) against its
   plain version, bit for bit (the products are exact), and two calls bit
   for bit equal, at every int8 site shape of a flagship UNet call at
   batch 32 (the harness's 2 x 16) and 128 and of a Cityscapes call at
   batch 2 (the in_convs' K = 27 and 207, the stride-2 Downsamples, the 1x1
   skips, the DINO concat's 640 channels), bf16 with a static scale; fp32
   and dynamic variants on the ragged and strided sites and on each path's
   edge cases (the ring on ragged rows and stride 2, K split over blocks).
   Per site shape: its path and plan, kernel, bf16 cuDNN conv
   (`float_conv_ms`: what the float path runs there) and bound times (x,
   the codes and the output moved once; 2 M N K int8 operations at 1,979
   TOP/s), summed over a UNet call; the plain version's time at six of
   them. Then the host's side of an int8 flagship UNet call at batch 32
   (static scales): its host ms with the kernel's plans cached, as in a
   run, and with the cache emptied first, the 81 sites' plans alone
   uncached and cached, and the call's device ms. Rows in
   `build/chip_smoke_quant_conv.json`; the kernel's time against an earlier
   commit's is `tools/time_quant_conv.py`'s.
22. quant_eval: `eval_lidc_uncertainty(EVAL_LIDC_FAST_PARAMS)` (int8 on
   calibrated static scales, encoder reuse 2, T = 250, batch 2) on phase
   13's 8 PNG images with phase 11's weights; `quantized_inference: True`
   (dynamic) at R = 1 on 2 of them; `CityscapesEvaluator` at full width
   with static scales on phase 16's checkpoint, 2 images x 1 vote x 250
   steps at R = 1; between them `python -m ccdm_tpu_torch.cli.eval` on
   `.json` params in a subprocess, on the card by default: the step sweep
   (10 and 5 steps) with static scales and reuse 2, and the dynamic mode
   at T = 10, 2 images each (exit 0, results with calibration seconds
   exactly where static). Each in-process run checks the metrics' ranges
   and launches exactly:
   the int8 kernel 81 (Cityscapes 96) a whole UNet call and 53 a replay,
   GroupNorm and attention as in phases 7 and 13, plus the calibration's 8
   float UNet calls; prints the calibration's seconds and samples/s
   against phase 13's float harness.
23. quant_reference: the fp32 int8 sampler on the card (kernels, TF32 off)
   against the CPU (plain versions), flagship widths at 64x64, 1 image x 2
   samples x 3 steps, the same noise, dynamic and on one calibrated
   table, and the calibration itself card against CPU (within 1e-3
   relative). Moved int8 codes compound (see the phase): maps agree on
   >= 97% of pixels, and the mean probability difference is at most twice
   the CPU int8 run's mean distance from the float run.
24. data_parallel: two ranks as spawned processes on cuda:0 (this script
   with `--data-parallel-rank R`) in a gloo group the phase initializes
   (NCCL refuses two ranks on one card), each failure failing the phase.
   The one-process references are computed first, then the ranks run:
   one fp32 `make_train_step` step of `DEMO_TRAIN_PARAMS` at 128x128 from
   phase 11's masters, global batch 16 (8 a rank): a rank's own gradients
   within 1e-5 of each tensor's largest against one process's on its rows
   and draws (as is one process's repeat on a model built anew: cuDNN's
   default algorithms do not repeat their bits), and bit-equal to them
   with cuDNN held to its deterministic algorithms in both; the reduced loss and gradients against the
   one-process step at batch 16 within 1e-5 of each tensor's largest or
   twice one process's own error from splitting the batch in two
   (analytic zeros within 1e-6 of the tree's largest), the masters after 3 Adam
   steps within 3 x 2 lr and all but 1e-4 of them within 1e-5, the ranks
   bit-equal; a bf16 `TrainingRun` of 20 steps with a save and a
   validation at step 20: launches per rank exactly 66 GroupNorm forward +
   66 backward + 11 attention a step plus the rank's validation UNet calls,
   the checkpoint written by rank 0 alone and reloaded by one process bit
   for bit against rank 1's state; the LIDC harness (phase 13's tree,
   phase 11's weights, T = 50) equal to one process within 1e-6 relative,
   launches exact. Prints the all-reduce's ms and fp32 bytes a step and the
   bf16 step's wall at one rank (phase 11) and at two, all labelled gloo
   through the host. Then `python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m ccdm_tpu_torch.cli.train <json> --multihost
   --max-steps 4` through nccl: exit 0 and its step-4 checkpoint.

25. serving: the sampler exported as a serving artifact
   (`ccdm_tpu_torch/utils/serving.py`: start, step and final programs, the
   three kernels as the registered ops `ccdm::*`) into
   `build/chip_smoke_serving/`, then loaded and served in one fresh process
   (`serving_child`) that imports only `torch` and the
   loader (no other port module, no jax), cuDNN deterministic in both
   processes, TF32 at PyTorch's default: (a) the flagship 8 x 16 x 250 bf16,
   (b) the same weights on calibrated static int8 scales, (c)
   `CITYSCAPES_EVAL_PARAMS` 2 x 1 x 250 with DINO ViT-S/8 (index state), (d)
   the flagship in fp32, 1 x 2 x 3. Each served run's maps bit-equal to the
   eager `make_prob_sampler` on the same seed, and its launches by kernel and
   path equal the eager run's and (a-c) the sites x 250; (d) served without
   the loader's `fp32_precision` must differ; a batch of 9 raises. First,
   the repair's check: the Cityscapes-DINO evaluator under PyTorch's default
   settings computes the DINO map `fp32_precision` gives. Prints per case
   the export seconds, artifact MB, load seconds and served against eager
   rates (beside phases 5, 7 and 22's), and the host µs a call of each
   kernel's registered op against its eager wrapper.
26. remaining: the modules the port added last, each on the card, into
   `build/chip_smoke_remaining/`. (a) The native confusion counts
   (`ccdm_tpu_torch/native.py`, built at first use by the host's C++
   compiler) of two 1024x2048 uint8 label maps of 34 ids equal to
   `np.bincount`'s, and `pairwise_intersection_union` of 16 x 16 samples of
   128x128 equal to NumPy's, exact; host ms an image of both. (b) DINO
   ViT-S/8 at a 224x224 image, stride 4 (random weights): the key facets of
   blocks 5 and 11, log-binned, and the saliency map on the card against
   the same calls on the CPU in fp32 (a map within 1e-4 of its largest
   magnitude, the saliency map within 1e-3), with their device ms; then
   `tools/extract_dino_descriptors.py --bin` and `--saliency` on a PNG that
   `utils/png.write_png` wrote, with those weights converted by
   `tools/convert_dino_checkpoint.convert`: exit 0, the `.npy`'s shape, and
   within 1e-4 of the in-process call. (c) A synthesised LIDC pickle (48
   crops of 128x128, 4 masks, 12 series uids) through
   `tools/lidc_pickle_to_npz.py` into a `.npy` directory; `DEMO_TRAIN_PARAMS`
   with `dataset_file: datasets.lidc` and `$CCDM_LIDC_PATH` at it trains 10 steps at
   batch 16 (launches exact as in 11). (d) `tools/export_torch_checkpoint.py`
   writes the run's checkpoint in the reference schema (the run's fp32 EMA,
   bit for bit); with cuDNN held to its deterministic algorithms, the LIDC
   harness on the `.npy` test split (4 crops, 2 x 16, T = 50) gives the same
   results, and the sampler the same maps bit for bit, from `load_from:` the
   `.pt` as from the run directory, launches exact. (e)
   `tools/encoder_reuse_ab.py`'s rows over phase 11's masters:
   `DEMO_EVAL_PARAMS` (the flagship width) with R in {1, 2, 3}, float and
   int8-static, 4 of its 16 test images at batch 2 x 16 and T = 50 (cut from
   250, as phase 24's harness): one whole UNet call, one replay and (int8)
   the calibration, each run alone, launch K1, K2 and K3 exactly at the
   model's sites (`unet_sites`: 66, 11 and 81 a whole call) and the
   calibration's 8 float calls; each row's launches equal its whole calls'
   and replays' sites plus the calibration's (`expected_launches`, as in
   22), and by path those measured calls times their numbers, exactly; the
   table with its gate column and samples/s.

The last lines are the card's `nvidia-smi` name and power limit, one JSON
line of per-kernel results, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

IMAGES, SAMPLES, STEPS = 8, 16, 250

# NVIDIA H100 SXM peaks (data sheet, dense): device memory, bf16 tensor
# cores, fp32 outside the tensor cores, int8 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int = 5, calls: int = 20) -> float:
    """Device milliseconds per call: `calls` back-to-back calls between two
    CUDA events, queued behind a sleep kernel that outlasts their enqueueing,
    so the host's launch overhead does not show; median over `reps`."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - start
    # 2x the enqueue time at ~2 GHz; at most ~1 s
    cycles = int(min(2e9, 2 * host_s * 2e9))
    times = []
    for _ in range(reps):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        begin.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end) / calls)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, dtype: str):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def group_norm_bound(shape, itemsize: int, silu: bool, add: bool, backward: bool = False):
    """`bound_ms` of one GroupNorm call on `[B, C, *spatial]` of `itemsize`
    bytes, fp32 weight and bias, with or without SiLU and the `[B, C]` add.
    The forward reads x, the weight, the bias and the add and writes y; the
    backward reads x, dy, the weight, the bias and the add and writes dx,
    both parameters' gradients and the add's. Operations: the fp32 work an
    element, as the kernels do it."""
    n, c = math.prod(shape), shape[1]
    add_bytes = shape[0] * c * itemsize if add else 0
    if backward:
        return bound_ms(3 * n * itemsize + 4 * 4 * c + 2 * add_bytes,
                        n * (14 + 8 * silu + add), "float32")
    return bound_ms(2 * n * itemsize + 2 * 4 * c + add_bytes, n * (6 + 3 * silu + add),
                    "float32")


def bf16_excess(out, ref, atol: float = 3e-2) -> float:
    """Largest |out - ref| beyond max(atol, one bf16 ulp of ref). Both sides
    round an fp32 result to bf16; where the two fp32 values straddle a
    rounding boundary they land one ulp apart, which at |y| in [4, 8) is
    2^-5 = 0.031, above the 3e-2 bound."""
    import torch

    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    limit = torch.maximum(torch.full_like(ref, atol), ulp)
    return float(((out - ref).abs() - limit).max())


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    from ccdm_tpu_torch.ops import _build

    seconds = _build.build(force=True)
    _build.library()
    spills, kernel = [], ""
    for line in _build.build_log.splitlines():  # ptxas -v: a kernel's name, then its spills
        if "Function properties for" in line:
            kernel = line.split("for", 1)[1].strip()
        elif "spill" in line and " 0 bytes spill stores" not in line:
            spills.append(f"{kernel}: {line.strip()}")
    log("build", f"nvcc built {_build.LIB_PATH} in {seconds:.1f} s (one nvcc per source, "
        f"in parallel); kernels that spill: {spills or 'none'}")


def phase_group_norm(gen):
    import torch
    import torch.nn.functional as F

    from ccdm_tpu_torch.ops import group_norm as gn

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (shape, dtype, groups, silu, add)
        ((128, 32, 128, 128), bf16, 32, True, False),
        ((128, 64, 128, 128), bf16, 32, True, False),   # first decoder level
        ((128, 64, 128, 128), bf16, 32, False, False),  # the same, F.group_norm's function
        ((128, 64, 128, 128), bf16, 32, True, True),    # fused time-embedding add
        ((128, 32, 64, 64), bf16, 32, True, True),      # 4096-element slabs: past S, on M
        ((128, 256, 8, 8), bf16, 32, False, False),
        ((128, 32, 128, 128), fp32, 32, True, False),   # the fp32 head
        ((128, 32, 128, 128), fp32, 32, True, True),
        ((128, 96, 13, 13), fp32, 32, True, False),     # H*W = 169: ragged, element loads
        ((128, 32, 13, 13), fp32, 32, True, False),     # the same on path S
        ((16, 64, 256, 256), bf16, 32, True, False),    # 256 KB slabs: a cluster of 4
        ((16, 64, 256, 512), bf16, 32, True, False),    # 512 KB slabs: a cluster of 8
        ((16, 128, 256, 512), bf16, 32, True, False),   # Cityscapes torso, 1 MB slabs: path L
        ((16, 128, 256, 512), fp32, 32, True, False),   # Cityscapes head, 2 MB slabs: path L
        # the Cityscapes sampler's sites: 2 images x 1 vote at 256x512, base 128
        ((2, 128, 256, 512), bf16, 32, True, True),     # level-0 out-norms, 1 MB slabs: L
        ((2, 128, 256, 512), bf16, 32, True, False),    # level-0 in-norms
        ((2, 256, 256, 512), bf16, 32, True, False),    # level-0 skip concats, 2 MB: L
        ((2, 128, 256, 512), fp32, 32, True, False),    # the fp32 head, 2 MB: L
        ((2, 384, 128, 256), bf16, 32, True, False),    # level-1 skip concat, 768 KB: L
        ((2, 128, 128, 256), bf16, 32, True, True),     # level 1: a cluster of 4
        ((2, 640, 32, 64), bf16, 32, True, False),      # the DINO concat, 20 channels a group
        ((2, 256, 32, 64), bf16, 32, True, True),       # ds 8
        ((2, 256, 2048), bf16, 32, False, False),       # attention pre-norm at ds 8
        ((2, 512, 8, 16), bf16, 32, True, True),        # ds 32: path S
        # the Cityscapes train step's sites: batch 16 at 128x256, base 32
        ((16, 32, 128, 256), bf16, 32, True, False),    # level-0 in-norms
        ((16, 32, 128, 256), bf16, 32, True, True),     # level-0 out-norms
        ((16, 64, 128, 256), bf16, 32, True, False),    # level-0 decoder concats
        ((16, 32, 128, 256), fp32, 32, True, False),    # the fp32 head
        ((16, 448, 16, 32), bf16, 32, True, False),     # the DINO concat at ds 8
        ((16, 64, 512), bf16, 32, False, False),        # attention pre-norm at ds 8
        ((16, 128, 4, 8), bf16, 32, True, True),        # ds 32
    ]
    worst, rows = 0.0, {}
    for shape, dtype, groups, silu, with_add in cases:
        # unit scale: x ~ N(0,1), gamma ~ 1 + N(0, 0.1^2), beta ~ N(0, 0.1^2)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        b = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        e = torch.randn(shape[:2], generator=gen, device="cuda").to(dtype) if with_add else None
        plan = gn._plan(shape, dtype, groups)
        out = gn.group_norm(x, w, b, groups, silu=silu, add=e)
        ref = gn.torch_group_norm(x, w, b, groups, silu=silu, add=e)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        name = f"{list(shape)} {str(dtype)[6:]} silu={silu} add={with_add}"
        if dtype == fp32 and not err <= 2e-5:
            raise AssertionError(f"group_norm {name}: max err {err} > 2e-5")
        if dtype == bf16 and bf16_excess(out.float(), ref.float()) > 0:
            raise AssertionError(f"group_norm {name}: max err {err} beyond max(3e-2, 1 ulp)")
        del out, ref
        ms = time_ms(lambda: gn.group_norm(x, w, b, groups, silu=silu, add=e))
        plain_ms = time_ms(lambda: gn.torch_group_norm(x, w, b, groups, silu=silu, add=e))
        library_ms, lib_note = None, ""
        if not silu and e is None:
            try:
                F.group_norm(x, groups, w, b, 1e-5)
                lw, lb = w, b
            except RuntimeError:
                lw, lb = w.to(dtype), b.to(dtype)
                lib_note = f" (weights cast to {str(dtype)[6:]})"
            library_ms = time_ms(lambda: F.group_norm(x, groups, lw, lb, 1e-5))
        bound, bound_by = group_norm_bound(shape, x.element_size(), silu, e is not None)
        worst = max(worst, err)
        if (shape, dtype, silu, with_add) in (((128, 64, 128, 128), bf16, True, False),
                                              ((2, 128, 256, 512), bf16, True, True),
                                              ((16, 32, 128, 256), bf16, True, False)):
            rows[shape[0]] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "bound_by": bound_by,
                              "library_ms": library_ms}
        library = "none" if library_ms is None else f"{library_ms:.4f} ms{lib_note}"
        log("group_norm", f"{name} path {plan.path} (vec {plan.vec}, param {plan.param}): "
            f"max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library}, bound {bound:.4f} ms ({bound_by}), {bound / ms:.1%} of bound")
        del x, e
    torch.cuda.empty_cache()
    return worst, rows[128], rows[2], rows[16]


def phase_attention(gen):
    import torch
    import torch.nn.functional as F

    from ccdm_tpu_torch.ops import flash_attention as fa

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (BH, T, dh, dtype)
        (384, 256, 32, fp32),    # ds=8: 128 x 3 heads, 16x16 tokens
        (384, 256, 32, bf16),
        (512, 64, 32, fp32),     # ds=16 and the middle: 128 x 4 heads
        (512, 64, 32, bf16),
        (512, 70, 32, bf16),     # T % 8 != 0: element loads
        (64, 2048, 32, fp32),    # Cityscapes-size T: 32 K/V tiles
        (64, 2048, 32, bf16),
        (192, 256, 64, bf16),    # 64-channel heads
        (32, 2048, 64, bf16),
        (16, 2048, 32, bf16),    # Cityscapes ds=8: 2 x 8 heads, 32x64 tokens
        (32, 512, 32, bf16),     # ds=16: 2 x 16 heads
        (32, 128, 32, bf16),     # ds=32 and the middle
        (48, 256, 32, bf16),     # the flagship train step at batch 16: ds=8
        (64, 64, 32, bf16),      # ds=16 and the middle
        # the Cityscapes train step at batch 16: ds 8 is (32, 512) above
        (64, 128, 32, bf16),     # ds 16
        (64, 32, 32, bf16),      # ds 32 and the middle
    ]
    worst, rows = 0.0, {}
    for bh, t, dh, dtype in cases:
        # the model's layout: q, k, v are views of one packed [BH, 3*dh, T]
        qkv = torch.randn(bh, 3 * dh, t, generator=gen, device="cuda").to(dtype)
        q, k, v = qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]
        path = fa._path(q, k, v)
        out = fa.flash_attention(q, k, v)
        ref = fa.dense_attention(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        name = f"BH={bh} T={t} dh={dh} {str(dtype)[6:]}"
        if dtype == fp32:
            if not err <= 2e-5:
                raise AssertionError(f"attention {name}: max err {err} > 2e-5")
            detail = ""
        else:
            # bf16: no worse than the plain bf16 path against fp32 truth
            truth = fa.dense_attention(q.float(), k.float(), v.float())
            err_kernel = float((out.float() - truth).abs().max())
            err_plain = float((ref.float() - truth).abs().max())
            if not err_kernel <= err_plain + 1e-3:
                raise AssertionError(f"attention {name}: kernel err {err_kernel} > plain err "
                                     f"{err_plain} + 1e-3")
            detail = f" (vs fp32 truth: kernel {err_kernel:.3g}, plain {err_plain:.3g})"
            del truth
        del out, ref
        ms = time_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: fa.dense_attention(q, k, v))
        # SDPA on contiguous [BH, 1, T, dh] copies made outside the timed region;
        # its default scale 1/sqrt(dh) is the kernel's
        q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous() for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
        nbytes = 4 * bh * dh * t * q.element_size()
        bound, bound_by = bound_ms(nbytes, 4 * bh * t * t * dh, str(dtype)[6:])
        worst = max(worst, err)
        if (bh, t, dh, dtype) in ((384, 256, 32, bf16), (16, 2048, 32, bf16),
                                  (32, 512, 32, bf16)):
            rows[bh] = {"shape": [bh, dh, t], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}
        log("attention", f"{name} path {path}: max_abs_err {err:.3g}{detail}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by}), {bound / ms:.1%} of bound")
        del qkv, q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    return worst, rows[384], rows[16], rows[32]


def unzero_(net, seed: int) -> None:
    """Redraw every all-zero parameter (zero-initialised output projections
    and heads, biases) as N(0, 0.05^2): left at zero, the UNet's softmax is
    uniform whatever its torso computes."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)


def reset_counts() -> None:
    """Every kernel's launch counts to 0, just before a main-path run."""
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn
    from ccdm_tpu_torch.ops import quant

    gn.launches = 0
    gn.launches_bwd = 0
    fa.launches = 0
    quant.launches = 0
    for counts in (gn.path_launches, gn.path_launches_bwd, fa.path_launches,
                   quant.path_launches):
        counts.update(dict.fromkeys(counts, 0))


def read_counts():
    """(launches per kernel, launches per kernel and path) since the reset."""
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn
    from ccdm_tpu_torch.ops import quant

    return ({"group_norm": gn.launches, "flash_attention": fa.launches,
             "group_norm_backward": gn.launches_bwd, "quant_conv": quant.launches},
            {"group_norm": dict(gn.path_launches), "flash_attention": dict(fa.path_launches),
             "group_norm_backward": dict(gn.path_launches_bwd),
             "quant_conv": dict(quant.path_launches)})


def phase_slice(smi):
    import torch

    from ccdm_tpu_torch import FLAGSHIP_PARAMS
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn

    params = dict(FLAGSHIP_PARAMS, step_T_sample="confidence")
    model = build_model(params, num_classes=2, image_channels=1, image_size=128,
                        device="cuda", generator=torch.Generator().manual_seed(0))
    unzero_(model.unet, seed=1)
    gn_sites = sum(isinstance(m, GroupNorm32) for m in model.unet.modules())
    attn_sites = sum(isinstance(m, AttentionBlock) for m in model.unet.modules())
    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randn(IMAGES, 128, 128, 1, generator=gen, device="cuda")
    run = make_prob_sampler(model, num_samples=SAMPLES, num_steps=STEPS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    probs = run(model.unet, images, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, paths = read_counts()

    expected = (IMAGES, SAMPLES, 128, 128, 2)
    if tuple(probs.shape) != expected:
        raise AssertionError(f"slice output shape {tuple(probs.shape)} != {expected}")
    if not bool(torch.isfinite(probs).all()):
        raise AssertionError("slice output is not finite")
    sum_err = float((probs.sum(-1) - 1).abs().max())
    if not sum_err <= 1e-3:
        raise AssertionError(f"slice probabilities sum to 1 only within {sum_err}")
    want = {"group_norm": gn_sites * STEPS, "flash_attention": attn_sites * STEPS,
            "group_norm_backward": 0, "quant_conv": 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != sites x steps {want}")
    n = IMAGES * SAMPLES
    log("slice", f"flagship bf16 {IMAGES} images x {SAMPLES} samples x {STEPS} steps: "
        f"wall {wall:.2f} s, {n / wall:.2f} samples/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi}); launches "
        f"{launches} = sites ({gn_sites} GN, {attn_sites} attention) x {STEPS}, by path "
        f"{paths}; sum err {sum_err:.2g}, foreground share "
        f"{float((probs.argmax(-1) == 1).float().mean()):.3f}")
    return {"launches": launches, "path_launches": paths}, n / wall


def phase_reference():
    """The fp32 sampler on the card (kernels) against the CPU (plain
    versions), flagship widths, one image x 2 samples x 3 steps, the same
    injected prior and Gumbel noise."""
    import torch

    from ccdm_tpu_torch import FLAGSHIP_PARAMS
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model

    params = dict(FLAGSHIP_PARAMS, step_T_sample="confidence", compute_dtype="float32")
    cpu = build_model(params, 2, 1, 128, device="cpu")
    unzero_(cpu.unet, seed=3)
    card = build_model(params, 2, 1, 128)  # the default device is the card
    if next(card.unet.parameters()).device.type != "cuda":
        raise AssertionError("build_model without a device did not build on the card")
    card.unet.load_state_dict(cpu.unet.state_dict())
    gen = torch.Generator().manual_seed(4)
    s, k = 2, 3
    images = torch.randn(1, 128, 128, 1, generator=gen)
    prior = torch.nn.functional.one_hot(torch.randint(0, 2, (s, 128, 128), generator=gen), 2).float()
    gumbel = -torch.log(-torch.log(torch.rand(k, s, 128, 128, 2, generator=gen).clamp_min(1e-38)))
    ref = make_prob_sampler(cpu, s, k)(cpu.unet, images, prior=prior, gumbel=gumbel)
    out = make_prob_sampler(card, s, k)(card.unet, images.cuda(), prior=prior.cuda(),
                                        gumbel=gumbel.cuda()).cpu()
    # convolutions sum in another order on each device, so a draw at a
    # near-tie may flip: maps agree on >= 99.9% of pixels and, where they
    # agree, probabilities to 1e-4
    agree = out.argmax(-1) == ref.argmax(-1)
    share = float(agree.float().mean())
    err = float((out - ref).abs()[agree].max())
    if not (share >= 0.999 and err <= 1e-4):
        raise AssertionError(f"card vs CPU sampler: map agreement {share}, prob err {err}")
    log("reference", f"fp32 sampler, 1 image x {s} samples x {k} steps, card vs CPU: "
        f"maps agree on {share:.5f} of pixels, max prob err {err:.3g} where they agree")


CS_IMAGES, CS_HW, CS_LABEL_HW = 2, (256, 512), (1024, 2048)


def phase_cityscapes(smi, reuse: int):
    """The Cityscapes evaluator at full width: 2 images x 1 vote x 250 steps
    with encoder reuse R, then labels at the original 1024x2048."""
    import torch

    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator
    from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32

    name = f"cityscapes_r{reuse}"
    ev = CityscapesEvaluator(dict(CITYSCAPES_EVAL_PARAMS, encoder_reuse=reuse))
    ev.build((*CS_HW, 3), CS_IMAGES)  # the default device is the card
    unet = ev.model.unet
    if next(unet.parameters()).device.type != "cuda" or \
            next(ev.feature_net.parameters()).device.type != "cuda":
        raise AssertionError("CityscapesEvaluator.build did not build on the card")
    unzero_(unet, seed=5)

    def sites(kind, modules):
        return sum(isinstance(m, kind) for mod in modules for m in mod.modules())

    replayed = [unet.middle_block, *unet.output_blocks, unet.out]
    full_gn, full_attn = sites(GroupNorm32, [unet]), sites(AttentionBlock, [unet])
    replay_gn, replay_attn = sites(GroupNorm32, replayed), sites(AttentionBlock, replayed)
    if (full_gn, full_attn, replay_gn, replay_attn) != (81, 16, 51, 10):
        raise AssertionError(f"sites per UNet call {(full_gn, full_attn)}, per replay "
                             f"{(replay_gn, replay_attn)} != (81, 16), (51, 10)")
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.randn(CS_IMAGES, *CS_HW, 3, generator=gen, device="cuda")

    with torch.inference_mode():
        feats = ev.feature_fn(ev.feature_net, images)
        dino_ms = time_ms(lambda: ev.feature_fn(ev.feature_net, images), reps=3, calls=5)
    want_feats = (CS_IMAGES, CS_HW[0] // 8, CS_HW[1] // 8, 384)
    if tuple(feats.shape) != want_feats or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"DINO map {tuple(feats.shape)} (finite: "
                             f"{bool(torch.isfinite(feats).all())}) != {want_feats}")
    del feats

    votes = []
    sampler = ev.sampler

    def keep_votes(*args, **kwargs):  # the [B, votes, H, W, C] maps before the mean
        out = sampler(*args, **kwargs)
        votes.append(out)
        return out

    ev.sampler = keep_votes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    mean = ev.predict_batch(images, 6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, paths = read_counts()
    labels = ev.predict_labels(mean, CS_LABEL_HW)

    probs = votes[0]
    expected = (CS_IMAGES, 1, *CS_HW, 20)
    if tuple(probs.shape) != expected or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f"votes {tuple(probs.shape)} (finite: "
                             f"{bool(torch.isfinite(probs).all())}) != {expected}")
    sum_err = float((probs.sum(-1) - 1).abs().max())
    if not sum_err <= 1e-3:
        raise AssertionError(f"Cityscapes probabilities sum to 1 only within {sum_err}")
    if tuple(labels.shape) != (CS_IMAGES, *CS_LABEL_HW) or not (
            0 <= int(labels.min()) and int(labels.max()) <= 18):
        raise AssertionError(f"labels {tuple(labels.shape)} in [{int(labels.min())}, "
                             f"{int(labels.max())}], not [0, 18] at {CS_LABEL_HW}")
    full = len(range(0, STEPS, reuse))  # steps with step % R == 0 run the whole UNet
    want = {"group_norm": full * full_gn + (STEPS - full) * replay_gn,
            "flash_attention": full * full_attn + (STEPS - full) * replay_attn,
            "group_norm_backward": 0, "quant_conv": 0}
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != {want} "
                             f"({full} full UNet calls, {STEPS - full} replays)")
    if paths["group_norm"]["L"] == 0 or paths["flash_attention"]["mma"] != want["flash_attention"]:
        raise AssertionError(f"{name}: launches by path {paths}: want GroupNorm path L and "
                             f"attention all mma")
    log("cityscapes", f"R={reuse} bf16 {CS_IMAGES} images x 1 vote x {STEPS} steps at "
        f"{CS_HW[0]}x{CS_HW[1]} ({full} full UNet calls, {STEPS - full} replays): wall "
        f"{wall:.2f} s, {CS_IMAGES / wall:.3f} images/s, {wall / STEPS * 1e3:.2f} ms per step, "
        f"DINO {dino_ms:.2f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({smi}); launches {launches}, by path {paths}; sum err {sum_err:.2g}; labels at "
        f"{CS_LABEL_HW[0]}x{CS_LABEL_HW[1]} in [{int(labels.min())}, {int(labels.max())}]")
    return {"launches": launches, "path_launches": paths, "images_per_s": CS_IMAGES / wall}


def phase_cityscapes_reference():
    """The fp32 Cityscapes evaluator on the card (kernels) against the CPU
    (plain versions): full width, image_size 256, 1 image of 64x128, 2
    votes, T = 3, DINO on, the same injected prior and uniforms."""
    import torch

    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator

    params = dict(CITYSCAPES_EVAL_PARAMS, compute_dtype="float32", time_steps=3,
                  evaluation=dict(CITYSCAPES_EVAL_PARAMS["evaluation"], evaluations=2))
    cpu, card = CityscapesEvaluator(params), CityscapesEvaluator(params)
    cpu.build((*CS_HW, 3), 1, device="cpu")
    card.build((*CS_HW, 3), 1)
    unzero_(cpu.model.unet, seed=7)
    card.model.unet.load_state_dict(cpu.model.unet.state_dict())
    card.feature_net.load_state_dict(cpu.feature_net.state_dict())
    gen = torch.Generator().manual_seed(8)
    s, k, h, w = 2, 3, 64, 128
    images = torch.randn(1, h, w, 3, generator=gen)
    prior = torch.nn.functional.one_hot(torch.randint(0, 20, (s, h, w), generator=gen), 20).float()
    uniforms = torch.rand(k, s, h, w, generator=gen)
    ref = cpu.predict_batch(images, prior=prior, uniforms=uniforms)
    out = card.predict_batch(images.cuda(), prior=prior.cuda(), uniforms=uniforms.cuda()).cpu()
    # convolutions sum in another order on each device, so a draw near a
    # cdf boundary may move: maps agree on >= 99.9% of pixels and, where
    # they agree, probabilities to 1e-4
    agree = out.argmax(-1) == ref.argmax(-1)
    share = float(agree.float().mean())
    err = float((out - ref).abs()[agree].max())
    if not (share >= 0.999 and err <= 1e-4):
        raise AssertionError(f"Cityscapes card vs CPU: map agreement {share}, prob err {err}")
    log("cityscapes_reference", f"fp32 evaluator, 1 image {h}x{w} x {s} votes x {k} steps, "
        f"DINO on, card vs CPU: maps agree on {share:.5f} of pixels, max prob err {err:.3g} "
        f"where they agree")


def _err_to_max(out, ref) -> float:
    """max |out - ref| over the largest |ref| of the tensor."""
    ref = ref.float()
    return float((out.float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def phase_group_norm_backward(gen):
    import torch
    import torch.nn.functional as F

    from ccdm_tpu_torch.ops import group_norm as gn

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (shape, dtype, silu, add, path): the training step's sites at batch 16
        ((16, 32, 128, 128), bf16, True, False, "M"),   # level-0 in-norms: a cluster of 2
        ((16, 32, 128, 128), bf16, True, True, "M"),    # level-0 out-norms, the fused add
        ((16, 64, 128, 128), bf16, True, False, "M"),   # level-0 decoder concat: a cluster of 4
        ((16, 64, 128, 128), bf16, False, False, "M"),  # the same, F.group_norm's function
        ((16, 32, 128, 128), fp32, True, False, "M"),   # the fp32 head: a cluster of 4
        ((16, 96, 16, 16), bf16, True, True, "S"),      # ds 8
        ((16, 256, 8, 8), bf16, True, False, "S"),      # the ds-16 decoder concat
        ((16, 96, 256), bf16, False, False, "S"),       # attention pre-norm at ds 8
        ((16, 128, 64), bf16, False, False, "S"),       # attention pre-norm at ds 16
        ((16, 64, 32, 32), bf16, True, True, "S"),      # ds 4, a team of 4 warps
        ((16, 96, 64, 64), bf16, True, False, "M"),     # ds 2 decoder concat
        ((2, 128, 256, 512), bf16, True, True, "L"),    # path-L shapes: 1 MB slabs
        ((2, 128, 256, 512), fp32, False, False, "L"),  # 2 MB slabs
        ((2, 128, 256, 512), fp32, True, False, "L"),
        ((2, 64, 256, 256), bf16, True, True, "L"),     # 512 KB slabs
        # M at clusters of 1, 2, 4 and 8 blocks; chunk boundaries inside channels
        ((16, 768, 4, 8), bf16, True, True, "M"),       # 24 channels a group: a cluster of 1
        ((4, 96, 96, 96), bf16, True, True, "M"),       # a cluster of 4, boundaries in channels
        ((2, 640, 32, 64), bf16, True, False, "M"),     # the sampler's DINO concat: 5 blocks
        # H*W = 169 and 1521: element loads, in registers and into shared memory
        ((3, 32, 13, 13), fp32, True, True, "S"),
        ((16, 96, 13, 13), bf16, True, False, "S"),
        ((2, 96, 39, 39), fp32, True, True, "M"),
        # H*W past a tile (64 elements), not a multiple of it: two tiles a channel
        ((16, 3840, 5, 13), bf16, True, True, "M"),     # H*W = 65, 120 channels a group
        ((16, 6368, 9, 9), bf16, True, False, "M"),     # H*W = 81, 199 channels a group
        ((16, 2688, 96), bf16, True, True, "M"),        # x and dy views 2 bytes off: H*W = 96
        ((2, 64000, 5, 13), bf16, True, True, "L"),
        # the Cityscapes train step's sites: batch 16 at 128x256, base 32
        ((16, 32, 128, 256), bf16, True, False, "M"),   # level-0 in-norms: a cluster of 4
        ((16, 32, 128, 256), bf16, True, True, "M"),    # level-0 out-norms
        ((16, 64, 128, 256), bf16, True, False, "M"),   # level-0 decoder concats: cluster 8
        ((16, 32, 128, 256), fp32, True, False, "M"),   # the fp32 head: cluster 8
        ((16, 32, 64, 128), bf16, True, True, "M"),     # level 1
        ((16, 96, 64, 128), bf16, True, False, "M"),    # level-1 decoder concat
        ((16, 64, 32, 64), bf16, True, True, "S"),      # level 2: a team of 8 warps
        ((16, 448, 16, 32), bf16, True, False, "M"),    # the DINO concat at ds 8: 14 channels
        ((16, 64, 16, 32), bf16, True, True, "S"),      # ds 8
        ((16, 64, 512), bf16, False, False, "S"),       # attention pre-norm at ds 8
        ((16, 128, 8, 16), bf16, True, True, "S"),      # ds 16
        ((16, 128, 4, 8), bf16, True, True, "S"),       # ds 32
    ]
    misaligned = {(16, 2688, 96)}  # x and dy start one element into their storage
    worst, rows = 0.0, {}  # worst: the largest |dx - plain dx| over all cases
    for shape, dtype, silu, with_add, path in cases:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        aligned = shape not in misaligned
        if not aligned:
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(shape)
            dy = torch.cat([dy.new_zeros(1), dy.flatten()])[1:].view(shape)
        w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        b = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        e = torch.randn(shape[:2], generator=gen, device="cuda").to(dtype) if with_add else None
        plan = gn._plan_backward(shape, dtype, 32, aligned=aligned)
        name = (f"{list(shape)} {str(dtype)[6:]} silu={silu} add={with_add}"
                + ("" if aligned else " views 2 bytes off"))
        if plan.path != path:
            raise AssertionError(f"group_norm_backward {name}: path {plan.path}, not {path}")
        before = dict(gn.path_launches_bwd)
        out = gn.group_norm_backward(dy, x, w, b, 32, silu=silu, add=e)
        again = gn.group_norm_backward(dy, x, w, b, 32, silu=silu, add=e)
        ref = gn.torch_group_norm_backward(dy, x, w, b, 32, silu=silu, add=e)
        torch.cuda.synchronize()
        if gn.path_launches_bwd[path] != before[path] + 2:
            raise AssertionError(f"group_norm_backward {name}: launches by path "
                                 f"{gn.path_launches_bwd}, before {before}")
        if not all(o is None or torch.equal(o, a) for o, a in zip(out, again)):
            raise AssertionError(f"group_norm_backward {name}: two calls differ")
        dx_err = float((out[0].float() - ref[0].float()).abs().max())
        errs = {"dx": _err_to_max(out[0], ref[0]), "dw": _err_to_max(out[1], ref[1]),
                "db": _err_to_max(out[2], ref[2])}
        if e is not None:  # a sum over positions: against the scale of its terms
            scale = float(ref[0].float().abs().reshape(*shape[:2], -1).sum(-1).max())
            errs["dadd"] = float((out[3].float() - ref[3].float()).abs().max()) / scale
        low = 1e-4 if dtype == fp32 else 1e-2  # bf16 dx, dadd: one rounding of fp32 sums
        limits = {"dx": low, "dw": 1e-4, "db": 1e-4, "dadd": low}
        bad = {k: v for k, v in errs.items() if not v <= limits[k]}
        if bad:
            raise AssertionError(f"group_norm_backward {name}: errors over the largest "
                                 f"magnitude {bad} beyond {limits}")
        del out, again, ref
        ms = time_ms(lambda: gn.group_norm_backward(dy, x, w, b, 32, silu=silu, add=e))
        plain_ms = time_ms(lambda: gn.torch_group_norm_backward(dy, x, w, b, 32, silu=silu,
                                                                 add=e))
        library_ms, lib_note = None, ""
        if not silu and e is None:
            xl = x.clone().requires_grad_()
            wl, bl = w.clone().requires_grad_(), b.clone().requires_grad_()
            try:
                y = F.group_norm(xl, 32, wl, bl, 1e-5)
            except RuntimeError:
                wl = w.to(dtype).requires_grad_()
                bl = b.to(dtype).requires_grad_()
                lib_note = f" (weights cast to {str(dtype)[6:]})"
                y = F.group_norm(xl, 32, wl, bl, 1e-5)
            library_ms = time_ms(lambda: torch.autograd.grad(y, (xl, wl, bl), dy,
                                                             retain_graph=True))
            del y, xl
        bound, bound_by = group_norm_bound(shape, x.element_size(), silu, e is not None,
                                           backward=True)
        worst = max(worst, dx_err)
        if (shape, dtype, silu, with_add) in (((16, 64, 128, 128), bf16, True, False),
                                              ((16, 32, 128, 256), bf16, True, False)):
            rows[shape[2:]] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound, "bound_by": bound_by,
                               "library_ms": library_ms}
        library = "none" if library_ms is None else f"{library_ms:.4f} ms{lib_note}"
        log("group_norm_backward", f"{name} path {plan.path} (vec {plan.vec}, param "
            f"{plan.param}, chunk {plan.chunk}): max_abs_err dx {dx_err:.3g}; err/max "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f"; two calls bit-equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library}, bound "
            f"{bound:.4f} ms ({bound_by}), {bound / ms:.1%} of bound")
        del x, dy, e
    torch.cuda.empty_cache()
    return worst, rows[(128, 128)], rows[(128, 256)]


def phase_attention_backward(gen):
    import torch
    import torch.nn.functional as F

    from ccdm_tpu_torch.ops import flash_attention as fa

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [(48, 256, bf16), (48, 256, fp32), (64, 64, bf16), (64, 64, fp32),
             (16, 2048, bf16), (16, 2048, fp32),
             # the Cityscapes train step at batch 16: ds 8, 16, 32
             (32, 512, bf16), (32, 512, fp32), (64, 128, bf16), (64, 32, bf16)]
    # (BH, T, dtype), dh 32
    dh = 32
    for bh, t, dtype in cases:
        qkv = torch.randn(bh, 3 * dh, t, generator=gen, device="cuda").to(dtype)
        g = torch.randn(bh, dh, t, generator=gen, device="cuda").to(dtype)

        def grads(fn, src):
            leaf = src.clone().requires_grad_()
            fn(leaf[:, :dh], leaf[:, dh:2 * dh], leaf[:, 2 * dh:]).backward(g.to(src.dtype))
            return leaf.grad

        ours = grads(fa.flash_attention, qkv)
        plain = grads(fa.dense_attention, qkv)
        name = f"BH={bh} T={t} dh={dh} {str(dtype)[6:]}"
        branch = "dense" if t * t <= fa.BWD_DENSE_MAX_ELEMENTS else "streaming"
        if dtype == fp32:
            err = _err_to_max(ours, plain)
            if not err <= 1e-4:
                raise AssertionError(f"attention_backward {name}: err/max {err} > 1e-4")
            detail = f"err/max vs autograd through dense_attention {err:.3g}"
        else:
            # bf16: no worse against the fp32 truth than autograd through the
            # plain bf16 path (which also rounds p to bf16 in its forward)
            truth = grads(fa.dense_attention, qkv.float())
            err, err_plain = _err_to_max(ours, truth), _err_to_max(plain, truth)
            if not err <= err_plain + 1e-3:
                raise AssertionError(f"attention_backward {name}: err/max {err} > plain "
                                     f"{err_plain} + 1e-3")
            detail = f"err/max vs fp32 truth {err:.3g} (plain bf16 {err_plain:.3g})"
        q, k, v = (qkv[:, i * dh:(i + 1) * dh] for i in range(3))
        ms = time_ms(lambda: fa.attention_backward(q, k, v, g), reps=3, calls=5)
        leaf = qkv.clone().requires_grad_()
        y = fa.dense_attention(leaf[:, :dh], leaf[:, dh:2 * dh], leaf[:, 2 * dh:])
        plain_ms = time_ms(lambda: torch.autograd.grad(y, leaf, g, retain_graph=True),
                           reps=3, calls=5)
        q4, k4, v4 = (x.transpose(1, 2).unsqueeze(1).contiguous().requires_grad_()
                      for x in (q, k, v))
        y4 = F.scaled_dot_product_attention(q4, k4, v4)
        g4 = g.transpose(1, 2).unsqueeze(1).contiguous()
        library_ms = time_ms(lambda: torch.autograd.grad(y4, (q4, k4, v4), g4,
                                                         retain_graph=True), reps=3, calls=5)
        nbytes = 7 * bh * dh * t * q.element_size()
        bound, bound_by = bound_ms(nbytes, 10 * bh * t * t * dh, "float32")
        log("attention_backward", f"{name} ({branch}): {detail}; backward {ms:.4f} ms, plain "
            f"(autograd through dense_attention) {plain_ms:.4f} ms, library (SDPA backward) "
            f"{library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}, fp32 math), "
            f"{bound / ms:.1%} of bound")
        del qkv, g, ours, plain, y, leaf, q4, k4, v4, y4, g4
    torch.cuda.empty_cache()


TRAIN_STEPS, TRAIN_EVENT = 30, 20  # steps; the step of the save and validation


def run_training(run, steps: int, marks_at):
    """Drive `run` for `steps` steps with the launch counts set to 0 just
    before; returns the step metrics, the host clock after each step in
    `marks_at` (after a sync), the (start, seconds) of every validation,
    grid and save, the validation's and the grid's results, the number of
    UNet calls of the EMA module (validation and grid), and the launches
    and launches by path. The GroupNorm backward's launches by path must
    equal `_plan_backward`'s path of every GroupNorm call that autograd
    records (hooks on the trained module's sites count them)."""
    import collections

    import torch

    from ccdm_tpu_torch.models.layers import GroupNorm32
    from ccdm_tpu_torch.ops import group_norm as gn

    metrics, marks, pauses, results, calls = [], {}, [], {}, []
    step_fn = run.step_fn
    want_bwd = collections.Counter()

    def on_norm(mod, args, kwargs):
        if torch.is_grad_enabled() and mod.weight.requires_grad:
            x = args[0]
            want_bwd[gn._plan_backward(x.shape, x.dtype, mod.groups,
                                       x.data_ptr() % 16 == 0).path] += 1

    def step(*args, **kwargs):
        m = step_fn(*args, **kwargs)
        metrics.append(m)
        if len(metrics) in marks_at:
            torch.cuda.synchronize()
            marks[len(metrics)] = time.perf_counter()
        return m

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            pauses.append((start, time.perf_counter() - start))
            if key:
                results[key] = (result, pauses[-1][1])
            return result
        return wrapped

    run.ema_net.register_forward_pre_hook(lambda *_: calls.append(1))
    hooks = [m.register_forward_pre_hook(on_norm, with_kwargs=True)
             for m in run.net.modules() if isinstance(m, GroupNorm32)]
    run.step_fn = step
    run.validate = timed(run.validate, "validate")
    run.save_qualitative = timed(run.save_qualitative, "grid")
    run.checkpoints.save_periodic = timed(run.checkpoints.save_periodic, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks[0] = time.perf_counter()
    state = run.run(max_steps=steps)
    torch.cuda.synchronize()
    launches, paths = read_counts()
    for h in hooks:
        h.remove()
    want = {path: want_bwd[path] for path in gn.path_launches_bwd}
    if paths["group_norm_backward"] != want:
        raise AssertionError(f"GroupNorm backward launches by path "
                             f"{paths['group_norm_backward']} != the plans' {want}")
    if state.step != steps or len(metrics) != steps:
        raise AssertionError(f"trained to step {state.step} in {len(metrics)} steps")
    losses = [float(m["loss"]) for m in metrics]
    if not all(np.isfinite(losses)) or any(bool(m["invalid"]) for m in metrics):
        raise AssertionError(f"a non-finite loss or an invalid step: {losses}")
    return metrics, marks, pauses, results, len(calls), launches, paths


def check_train_launches(name: str, launches, steps: int, calls: int, gn: int = 81,
                         attn: int = 16):
    want = {"group_norm": gn * (steps + calls), "group_norm_backward": gn * steps,
            "flash_attention": attn * (steps + calls), "quant_conv": 0}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want} ({steps} steps, {calls} "
                             f"validation UNet calls)")


def check_round_trip(name: str, state, restored) -> None:
    """A `TrainingRun` restored from `state`'s checkpoint holds the same
    params, EMA, Adam moments, count and step, bit for bit."""
    import torch

    for what, a, b in (("params", state.params, restored.params),
                       ("EMA", state.ema_params, restored.ema_params),
                       ("Adam mu", state.opt_state["mu"], restored.opt_state["mu"]),
                       ("Adam nu", state.opt_state["nu"], restored.opt_state["nu"])):
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"{name}: checkpoint round trip: {what} differ")
    if (restored.step, restored.opt_state["count"]) != (state.step, state.opt_state["count"]):
        raise AssertionError(f"{name}: checkpoint round trip: step {restored.step}, count "
                             f"{restored.opt_state['count']}")


def check_miou(name: str, results):
    scores, val_s = results["validate"]
    if not all(v != v or 0 <= v <= 1 for v in (scores["mIoU"], scores["mIoU_train"])):
        raise AssertionError(f"{name}: mIoU out of range: {scores}")
    grid, grid_s = results["grid"]
    if not Path(grid).is_file():
        raise AssertionError(f"{name}: no qualitative grid at {grid}")
    return scores, val_s, grid_s


def phase_train(smi):
    """The flagship trainer at full width on the card (see the docstring)."""
    import shutil

    import torch

    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32
    from ccdm_tpu_torch.train.trainer import TrainingRun

    out = Path("build/chip_smoke_train")
    shutil.rmtree(out, ignore_errors=True)
    params = dict(DEMO_TRAIN_PARAMS, output_path=str(out / "run"), save_freq=TRAIN_EVENT,
                  validation_freq=TRAIN_EVENT, display_freq=10, progress_bar=False)
    run = TrainingRun(params)  # the default device is the card
    if run.device.type != "cuda" or next(run.net.parameters()).dtype != torch.bfloat16:
        raise AssertionError("TrainingRun did not build a bf16 UNet on the card")
    gn_sites = sum(isinstance(m, GroupNorm32) for m in run.net.modules())
    attn_sites = sum(isinstance(m, AttentionBlock) for m in run.net.modules())
    if (gn_sites, attn_sites) != (66, 11):
        raise AssertionError(f"sites per UNet call ({gn_sites}, {attn_sites}) != (66, 11)")

    metrics, marks, pauses, val, calls, launches, paths = run_training(
        run, TRAIN_STEPS, (1, 10, TRAIN_STEPS))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    check_train_launches("train", launches, TRAIN_STEPS, calls, gn_sites, attn_sites)
    scores, val_s = val["validate"]
    if not (0 <= scores["GED"] <= 2 and 0 <= scores["HMIoU"] <= 1):
        raise AssertionError(f"validation scores out of range: {scores}")
    grid_path, grid_s = val["grid"]
    if not Path(grid_path).is_file():
        raise AssertionError(f"no qualitative grid at {grid_path}")
    # the save and the validation at TRAIN_EVENT fall inside steps 11-30:
    # their time comes off the window
    inside = sum(d for t0, d in pauses if marks[10] <= t0 <= marks[TRAIN_STEPS])
    warm = (marks[TRAIN_STEPS] - marks[10] - inside) / (TRAIN_STEPS - 10)
    cold = marks[1] - marks[0]
    check_round_trip("train", run.state, TrainingRun(dict(
        params, load_from=str(out / "run"), output_path=str(out / "restored"))).state)
    masters = {name: p.detach().cpu().clone() for name, p in run.state.params.items()}
    batch = run.batch_size
    log("train", f"DEMO_TRAIN_PARAMS bf16, batch {batch}, {TRAIN_STEPS} steps ({smi}): cold "
        f"first step {cold:.2f} s, warm {warm * 1e3:.2f} ms/step = {batch / warm:.1f} images/s "
        f"(steps 11-{TRAIN_STEPS}, the save, validation and grid taken out), peak {peak:.2f} GiB; "
        f"loss {losses[0]:.4g} -> {losses[-1]:.4g}; validation at step {TRAIN_EVENT}: GED "
        f"{scores['GED']:.4f}, HM-IoU {scores['HMIoU']:.4f}, {val_s:.2f} s; qualitative grid "
        f"{grid_s:.2f} s; {calls} UNet calls of validation and grid; launches {launches}, "
        f"backward by path {paths['group_norm_backward']}; checkpoint round trip exact "
        f"(params, EMA, Adam, step {TRAIN_STEPS})")
    return {"launches": launches, "path_launches": paths, "warm_ms": warm * 1e3}, masters


def grad_errors(ref, grads, zero=None, key_rows: bool = True):
    """Card gradients `grads` against the CPU's `ref` (name -> tensor): the
    worst max |diff| over the tensor's largest |ref|, as (err, name), and
    the worst max |diff| of the analytically zero gradients over the tree's
    largest |ref|.

    Gradients that are 0 in exact arithmetic are rounding noise on both
    devices, and a relative error means nothing there. They are what the
    model adds per channel in front of a GroupNorm of one channel a group,
    which the norm's mean removes (a ResBlock's first conv bias and
    time-embedding projection, the last ResBlock's output biases in front
    of the head's norm), and the key rows of an attention's qkv bias (the
    softmax removes q.b_k; with `key_rows`, the UNet's packing of 32-channel
    heads). Unless `zero` names them, a tensor whose largest CPU gradient is
    under 1e-5 of the tree's largest counts as one. Returns (worst, worst
    of the zeros, the zero tensors' names)."""
    import torch

    top = max(float(g.abs().max()) for g in ref.values())
    if zero is None:
        zero = {n for n, g in ref.items() if float(g.abs().max()) < 1e-5 * top}
    worst, worst_zero = (0.0, ""), 0.0
    for name, g in ref.items():
        diff = (grads[name] - g).abs()
        if name in zero:
            worst_zero = max(worst_zero, float(diff.max()) / top)
            continue
        if key_rows and name.endswith("qkv.bias"):
            keys = (torch.arange(g.numel()) // 32) % 3 == 1
            worst_zero = max(worst_zero, float(diff[keys].max()) / top)
            diff, g = diff[~keys], g[~keys]
        e = float(diff.max()) / max(float(g.abs().max()), 1e-30)
        worst = max(worst, (e, name))
    return worst, worst_zero, zero


def grad_agreement(ref, grads, phase: str, key_rows: bool = True):
    """`grad_errors` held to fp32's limits: every gradient within 1e-4 of
    its tensor's largest, the analytically zero ones within 1e-6 of the
    tree's largest gradient. Returns `grad_errors`' triple."""
    worst, worst_zero, zero = grad_errors(ref, grads, key_rows=key_rows)
    if not (worst[0] <= 1e-4 and worst_zero <= 1e-6):
        raise AssertionError(f"{phase}: gradient err/max {worst}, analytically zero "
                             f"gradients {worst_zero:.3g} of the largest ({sorted(zero)})")
    return worst, worst_zero, zero


def step_grads(model, batch, t, xt, device):
    """(loss, {name: fp32 CPU gradient}) of one `make_train_step` step of
    `model` on `device`, with the injected t and x_t and unit class weights;
    the state's update records the gradients instead of applying them."""
    import torch

    from ccdm_tpu_torch.train.optimizer import Optimizer
    from ccdm_tpu_torch.train.state import create_train_state, master_params
    from ccdm_tpu_torch.train.step import make_train_step

    state = create_train_state(master_params(model.unet), Optimizer("Adam", lambda s: 0.0))
    grads = {}

    def record(g):
        grads.update({k: v.detach().float().cpu() for k, v in g.items()})
        return 0.0

    state.apply_gradients = record
    metrics = make_train_step(model, torch.ones(2, device=device))(
        state, model.unet, {k: v.to(device) for k, v in batch.items()}, 0, t=t.to(device),
        xt=xt.to(device))
    return float(metrics["loss"]), grads


def lesion_batch(b: int, hw: int, seed: int):
    """`b` synthetic training lesions at hw x hw and x_t drawn on the CPU
    from q(x_t | x_0) at t spread over the schedule."""
    import torch

    from ccdm_tpu_torch.data.synthetic import synthetic_training_dataset

    ds = synthetic_training_dataset(n=b, resolution=hw, seed=seed)
    samples = [ds.get(i, np.random.default_rng((seed, i))) for i in range(b)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in ("image", "x0")}
    t = torch.linspace(20, 230, b).round().long()
    gen = torch.Generator().manual_seed(seed)
    keep = torch.rand(batch["x0"].shape[:3], generator=gen) < 0.6
    noise = torch.nn.functional.one_hot(
        torch.randint(0, 2, batch["x0"].shape[:3], generator=gen), 2).float()
    xt = torch.where(keep[..., None], batch["x0"], noise)
    return batch, t, xt


def phase_train_reference(masters):
    """One train step on the card (kernels) against the CPU (plain versions),
    the same injected t and x_t: fp32 at flagship widths on 32x32; then the
    gate's training geometry (128x128) from phase 11's trained `masters`,
    in fp32 and in bf16."""
    import torch

    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.models.builder import build_model

    params = dict(DEMO_TRAIN_PARAMS, compute_dtype="float32")
    cpu = build_model(params, 2, 1, 128, device="cpu")
    unzero_(cpu.unet, seed=9)
    card = build_model(params, 2, 1, 128)
    card.unet.load_state_dict(cpu.unet.state_dict())
    gen = torch.Generator().manual_seed(10)
    b, hw = 2, 32
    batch = {"image": torch.randn(b, hw, hw, 1, generator=gen),
             "x0": torch.nn.functional.one_hot(
                 torch.randint(0, 2, (b, hw, hw), generator=gen), 2).float()}
    t = torch.tensor([3, 170])
    xt = torch.nn.functional.one_hot(torch.randint(0, 2, (b, hw, hw), generator=gen), 2).float()
    ref_loss, ref = step_grads(cpu, batch, t, xt, "cpu")
    loss, grads = step_grads(card, batch, t, xt, "cuda")
    rel = abs(loss - ref_loss) / abs(ref_loss)
    if not rel <= 1e-5:
        raise AssertionError(f"train_reference: loss {loss} vs CPU {ref_loss} ({rel:.3g})")
    worst, worst_zero, zero = grad_agreement(ref, grads, "train_reference")
    log("train_reference", f"fp32 train step, flagship widths, batch {b} of {hw}x{hw}, card "
        f"vs CPU: loss {loss:.6g} vs {ref_loss:.6g} ({rel:.2g} relative), worst gradient "
        f"err/max {worst[0]:.3g} ({worst[1]}), analytically zero gradients within "
        f"{worst_zero:.2g} of the largest ({len(zero)} tensors and the key rows)")

    # the gate's training geometry, from a trained state, under PyTorch's
    # default TF32 setting (cuDNN's fp32 convolutions in TF32), as the
    # trainer runs: the step itself keeps its fp32 convolutions in fp32
    import contextlib

    from ccdm_tpu_torch.models.layers import GroupNorm32
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn
    from ccdm_tpu_torch.train import step as train_step

    b, hw = 2, 128
    batch, t, xt = lesion_batch(b, hw, seed=11)
    torch.backends.cudnn.allow_tf32 = True
    fp32 = {}
    for dtype in ("float32", "bfloat16"):
        p = dict(DEMO_TRAIN_PARAMS, compute_dtype=dtype)
        models = {dev: build_model(p, 2, 1, hw, device=dev) for dev in ("cpu", "cuda")}
        with torch.no_grad():
            for model in models.values():
                for name, prm in model.unet.named_parameters():
                    prm.copy_(masters[name])
        ref_loss, ref = step_grads(models["cpu"], batch, t, xt, "cpu")
        m_paths = {}

        def on_norm(mod, args, kwargs):
            x = args[0]
            path = gn._plan_backward(x.shape, x.dtype, mod.groups, x.data_ptr() % 16 == 0).path
            m_paths[path] = m_paths.get(path, 0) + 1

        hooks = [m.register_forward_pre_hook(on_norm, with_kwargs=True)
                 for m in models["cuda"].unet.modules() if isinstance(m, GroupNorm32)]
        before = (fa.launches, gn.launches_bwd)
        loss, grads = step_grads(models["cuda"], batch, t, xt, "cuda")
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        want_m = {"float32": 24, "bfloat16": 15}[dtype]  # slabs of 16 KB and up
        if (fa.launches - before[0], gn.launches_bwd - before[1]) != (11, 66) or \
                m_paths.get("M") != want_m:
            raise AssertionError(f"train_reference {dtype}: attention launches "
                                 f"{fa.launches - before[0]}, backward launches "
                                 f"{gn.launches_bwd - before[1]}, backward paths {m_paths}: "
                                 f"not 11, 66 and {want_m} on path M")
        rel = abs(loss - ref_loss) / abs(ref_loss)
        if dtype == "float32":
            if not rel <= 1e-5:
                raise AssertionError(f"train_reference 128x128 fp32: loss {loss} vs CPU "
                                     f"{ref_loss} ({rel:.3g})")
            worst, worst_zero, zero = grad_agreement(ref, grads, "train_reference 128x128 fp32")
            # the control: the same step with the process's TF32 left on (the
            # step's own fp32_precision taken out), which the rule must see
            saved = train_step.fp32_precision
            train_step.fp32_precision = contextlib.nullcontext
            try:
                tf32 = grad_errors(ref, step_grads(models["cuda"], batch, t, xt, "cuda")[1],
                                   zero)[0]
            finally:
                train_step.fp32_precision = saved
            if not tf32[0] > 1e-4:
                raise AssertionError(f"train_reference 128x128 fp32: the step with TF32 left on "
                                     f"reads {tf32}, inside the 1e-4 limit: the rule cannot see "
                                     f"TF32")
            fp32 = {"ref": ref, "grads": grads, "zero": zero}
            detail = (f"worst gradient err/max {worst[0]:.3g} ({worst[1]}), analytically zero "
                      f"gradients within {worst_zero:.2g} of the largest ({len(zero)} tensors "
                      f"and the key rows); control, the step with TF32 left on: {tf32[0]:.3g} "
                      f"({tf32[1]})")
        else:
            # bf16: the fp32 rule per tensor, with bf16's limits. The two
            # devices round activations to bf16 after sums in different
            # orders, and a tensor's gradient moves by a few percent of its
            # largest (PERF.md §6): every tensor within 0.1 of its largest
            # (a lost quarter of a fold reads 0.25), the analytically zero
            # ones (fp32's list) within 1e-5 of the tree's largest
            worst, worst_zero, _ = grad_errors(ref, grads, fp32["zero"])
            gap = grad_errors(ref, fp32["grads"], fp32["zero"])[0]
            if not (rel <= 1e-4 and worst[0] <= 0.1 and worst_zero <= 1e-5):
                raise AssertionError(f"train_reference 128x128 bf16: loss {loss} vs CPU "
                                     f"{ref_loss} ({rel:.3g}), worst gradient err/max {worst}, "
                                     f"analytically zero gradients {worst_zero:.3g} of the "
                                     f"largest")
            total = float(torch.linalg.vector_norm(torch.stack([
                torch.linalg.vector_norm(grads[n] - g) for n, g in ref.items()]))) / float(
                torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                      for g in ref.values()])))
            detail = (f"worst gradient err/max {worst[0]:.3g} ({worst[1]}), analytically zero "
                      f"gradients within {worst_zero:.2g} of the largest, the whole tree's err "
                      f"{total:.3g} of its norm; bf16's own rounding, the card's fp32 step "
                      f"against this CPU bf16 step: {gap[0]:.3g} ({gap[1]})")
        log("train_reference", f"{dtype} train step at the gate's geometry (DEMO_TRAIN_PARAMS, "
            f"batch {b} of {hw}x{hw}, phase 11's masters, attention at T 256 and 64, backward "
            f"paths {m_paths}, PyTorch's default TF32 setting), card vs CPU: loss {loss:.7g} vs "
            f"{ref_loss:.7g} ({rel:.2g} relative), {detail}")
    torch.backends.cudnn.allow_tf32 = False  # phase 1's setting again


EVAL_DIR = Path("build/chip_smoke_eval")
EVAL_SEED = 13


def write_lidc_tree(root: Path, n: int) -> None:
    """`n` synthetic lesions (`data/synthetic.py`) at the LIDC crop release's
    180x180, in its PNG layout: a gray image and 4 expert masks each."""
    from ccdm_tpu_torch.data.synthetic import make_synthetic_lidc_group
    from ccdm_tpu_torch.utils.png import write_png

    group = make_synthetic_lidc_group(n=n, resolution=180, seed=EVAL_SEED)
    split = root / "lidc_crops_test" / "test"
    for i in range(n):
        image = np.round((group["images"][i] + 0.5) * 255).astype(np.uint8)
        write_png(split / "images" / f"case{i // 4}" / f"s{i:02d}.png", image)
        for a in range(4):
            write_png(split / "gt" / f"case{i // 4}" / f"s{i:02d}_l{a}.png",
                      group["labels"][i, a] * np.uint8(255))


def lidc_eval_params(**overrides):
    """The flagship model under the LIDC protocol on the PNG release, with
    the weights phase 11 trained."""
    from ccdm_tpu_torch import FLAGSHIP_PARAMS

    params = dict(FLAGSHIP_PARAMS, dataset_file="datasets.lidc_orig", dataset_val_max_size=None,
                  batch_size=2, evaluations=[1, 4, 8, 16], evaluation_vote_strategy="confidence",
                  load_from="build/chip_smoke_train/run", seed=EVAL_SEED)
    params.update(overrides)
    return params


def phase_eval_lidc(smi, bare_rate: float):
    """The LIDC uncertainty harness at full width on 8 PNG images."""
    import os
    import shutil

    import torch

    from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    write_lidc_tree(EVAL_DIR / "lidc", 8)
    os.environ["CCDM_LIDC_ORIG_PATH"] = str(EVAL_DIR / "lidc")
    params = lidc_eval_params(evaluation_path=str(EVAL_DIR / "lidc_out"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    res = eval_lidc_uncertainty(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, _ = read_counts()
    batches = 4
    want = {"group_norm": 66 * STEPS * batches, "flash_attention": 11 * STEPS * batches,
            "group_norm_backward": 0, "quant_conv": 0}
    if launches != want:
        raise AssertionError(f"eval_lidc: launches {launches} != {want} (sites x {STEPS} steps "
                             f"x {batches} batches)")
    bad = [k for k in ("GED_1", "GED_4", "GED_8", "GED_16") if not 0 <= res[k] <= 2]
    bad += [k for k in ("HMIoU_1", "HMIoU_4", "HMIoU_8", "HMIoU_16") if not 0 <= res[k] <= 1]
    bad += [k for k in ("IoU", "Dice") if not all(0 <= v <= 1 for v in res[k])]
    if res["count"] != 8 or bad:
        raise AssertionError(f"eval_lidc: count {res['count']}, out of range: {bad} in {res}")
    if not (EVAL_DIR / "lidc_out" / "lidc_uncertainty_full.json").is_file():
        raise AssertionError("eval_lidc: no results JSON")
    log("eval_lidc", f"flagship bf16, 8 PNG images x 16 samples x {STEPS} steps at batch 2 "
        f"({smi}): wall {wall:.2f} s, harness {res['samples_per_sec']:.2f} samples/s (steady, "
        f"batches 2-4) against the bare sampler's {bare_rate:.2f} at 8 x 16 (phase 5); host "
        f"seconds: generation {res['generation_seconds']:.2f}, PNG decode and crop "
        f"{res['data_seconds']:.3f}, metrics {res['metrics_seconds']:.2f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; GED 1/4/8/16 "
        + "/".join(f"{res[f'GED_{s}']:.4f}" for s in (1, 4, 8, 16)) + ", HM-IoU "
        + "/".join(f"{res[f'HMIoU_{s}']:.4f}" for s in (1, 4, 8, 16))
        + f", Dice {[round(v, 4) for v in res['Dice']]}, mIoU {res['mIoU']:.4f}, nonzero "
        f"{res['nonzero_fraction']:.3f}; launches {launches}")
    return {"launches": launches, "path_launches": {}}, res["samples_per_sec"]


def phase_eval_invariance():
    """Each image's samples, fp32, from one batch of 4 against batches of 1
    with the global indices; then the noise stream's share of a flagship
    step."""
    import torch

    from ccdm_tpu_torch import FLAGSHIP_PARAMS
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.diffusion.categorical import sample_onehot, theta_post_prob
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model

    params = dict(FLAGSHIP_PARAMS, step_T_sample="confidence", compute_dtype="float32")
    model = build_model(params, 2, 1, 128)
    unzero_(model.unet, seed=14)
    gen = torch.Generator(device="cuda").manual_seed(15)
    images = torch.randn(4, 128, 128, 1, generator=gen, device="cuda")
    run = make_prob_sampler(model, SAMPLES, num_steps=10)
    together = run(model.unet, images, EVAL_SEED, [10, 11, 12, 13])
    alone = torch.cat([run(model.unet, images[i:i + 1], EVAL_SEED, [10 + i]) for i in range(4)])
    agree = together.argmax(-1) == alone.argmax(-1)
    share = float(agree.float().mean())
    err = float((together - alone).abs()[agree].max())
    if not (share >= 0.999 and err <= 1e-4):
        raise AssertionError(f"eval_invariance: batch of 4 vs batches of 1: maps agree on "
                             f"{share}, prob err {err}")
    del together, alone

    # the noise stream's device time in a bf16 flagship step at 8 x 16
    bf16 = build_model(dict(params, compute_dtype="bfloat16"), 2, 1, 128)
    unzero_(bf16.unet, seed=1)
    n = IMAGES * SAMPLES
    keys = random.element_keys(EVAL_SEED, torch.arange(n, device="cuda"), random.CHAIN)
    x = torch.nn.functional.one_hot(torch.randint(0, 2, (n, 128, 128), generator=gen,
                                                  device="cuda"), 2).float()
    cond = torch.randn(n, 128, 128, 1, generator=gen, device="cuda")
    t = torch.full((n,), 120, device="cuda", dtype=torch.int32)
    fn = bf16.denoise_fn(bf16.unet, cond)
    with torch.inference_mode():
        noise_ms = time_ms(lambda: random.gumbel(keys, 3, (128, 128, 2)))
        step_ms = time_ms(lambda: sample_onehot(theta_post_prob(
            bf16.diffusion, x, fn(x, t).float(), t).clamp_min(1e-12),
            gumbel=random.gumbel(keys, 3, (128, 128, 2))), reps=3, calls=5)
    log("eval_invariance", f"fp32, TF32 off, 4 images x {SAMPLES} samples x 10 steps: one batch "
        f"of 4 vs 4 batches of 1 with global indices: maps agree on {share:.5f} of pixels, max "
        f"prob err {err:.3g} where they agree; noise stream (Threefry-2x32 as int64 torch ops, "
        f"Gumbel of [{n},128,128,2]) {noise_ms:.3f} ms of a {step_ms:.2f} ms bf16 flagship step "
        f"at {IMAGES} x {SAMPLES} ({noise_ms / step_ms:.1%})")
    return noise_ms, step_ms


def phase_sampling_speed(smi):
    """The default step sweep on 2 PNG images x 16 samples."""
    import torch

    from ccdm_tpu_torch.eval.lidc_sampling_speed import (
        DEFAULT_STEP_SWEEP,
        eval_lidc_sampling_speed,
    )

    params = lidc_eval_params(dataset_val_max_size=2, evaluations=[16],
                              evaluation_path=str(EVAL_DIR / "sweep_out"))
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    res = eval_lidc_sampling_speed(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, _ = read_counts()
    steps = sum(DEFAULT_STEP_SWEEP)
    want = {"group_norm": 66 * steps, "flash_attention": 11 * steps, "group_norm_backward": 0, "quant_conv": 0}
    if sorted(res) != sorted(DEFAULT_STEP_SWEEP) or launches != want:
        raise AssertionError(f"sampling_speed: sweep {sorted(res)}, launches {launches} != "
                             f"{want} (sites x {steps} steps)")
    log("sampling_speed", f"flagship bf16, 2 images x 16 samples, one batch a step count "
        f"({smi}): wall {wall:.2f} s; samples/s by steps " + ", ".join(
            f"{k}: {res[k]['samples_per_sec']:.2f}" for k in DEFAULT_STEP_SWEEP)
        + "; GED_16 by steps " + ", ".join(f"{k}: {res[k]['GED_16']:.4f}"
                                             for k in DEFAULT_STEP_SWEEP)
        + f"; launches {launches}")
    return {"launches": launches, "path_launches": {}}


def write_cityscapes_tree(root: Path, n: int, split: str = "val", hw=CS_LABEL_HW,
                          seed: int = EVAL_SEED) -> list:
    """`n` scenes of `split` at `hw` (default the release's 1024x2048): RGB
    `leftImg8bit`, 8-bit `labelIds` (sky, building, road bands with car and
    person boxes) and 16-bit `instanceIds`, in the release's layout.
    Returns the image paths."""
    from ccdm_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    h, w = hw
    scale = h / CS_LABEL_HW[0]
    paths = []
    for i in range(n):
        ids = np.full((h, w), 11, np.uint8)
        ids[: h // 4] = 23
        ids[h // 2:] = 7
        inst = ids.astype(np.uint16)
        boxes = [(26, 120, 260)] * 4 + [(24, 180, 60)] * 3
        for k, (label, bh, bw) in enumerate(boxes):
            bh, bw = int(bh * scale), int(bw * scale)
            y, x = rng.integers(h // 3, h - bh), rng.integers(0, w - bw)
            ids[y:y + bh, x:x + bw] = label
            inst[y:y + bh, x:x + bw] = label * 1000 + k
        yy, xx = np.mgrid[0:h, 0:w]
        image = np.stack([(xx // 8 + ids) % 256, (yy // 4 + 3 * ids) % 256,
                          rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
        city = "frankfurt" if split == "val" else "aachen"
        base = f"{city}_{i:06d}_000019"
        paths.append(write_png(root / "leftImg8bit" / split / city /
                               f"{base}_leftImg8bit.png", image, level=1))
        write_png(root / "gtFine" / split / city / f"{base}_gtFine_labelIds.png", ids)
        write_png(root / "gtFine" / split / city / f"{base}_gtFine_instanceIds.png", inst)
    return paths


def phase_cityscapes_eval(smi):
    """`run_inference` on CITYSCAPES_EVAL_PARAMS at full width over a
    2-image val tree, with seeded random UNet weights (zero leaves redrawn)
    handed in as a `load_from` checkpoint."""
    import json as json_
    import os

    import torch

    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS
    from ccdm_tpu_torch.eval.cityscapes_eval import run_inference
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.utils.png import read_png

    paths = write_cityscapes_tree(EVAL_DIR / "cs", CS_IMAGES)
    os.environ["CCDM_CITYSCAPES_PATH"] = str(EVAL_DIR / "cs")
    model = build_model(CITYSCAPES_EVAL_PARAMS, 20, 3, 256,
                        generator=torch.Generator().manual_seed(0))
    unzero_(model.unet, seed=16)
    (EVAL_DIR / "cs_ckpt").mkdir(parents=True, exist_ok=True)
    torch.save({"average_model": model.unet.state_dict()}, EVAL_DIR / "cs_ckpt" / "state.pt")
    del model
    out = EVAL_DIR / "cs_out"
    params = dict(CITYSCAPES_EVAL_PARAMS, output_path=str(out),
                  load_from=str(EVAL_DIR / "cs_ckpt"))
    start = time.perf_counter()
    decode = [read_png(p, mode="RGB") for p in paths]
    decode_s = time.perf_counter() - start
    del decode
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    res = run_inference(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, paths_by = read_counts()
    want = {"group_norm": 81 * STEPS, "flash_attention": 16 * STEPS, "group_norm_backward": 0, "quant_conv": 0}
    if launches != want:
        raise AssertionError(f"cityscapes_eval: launches {launches} != {want}")
    official = res["official"]
    miou = res["mIoU"]
    if res["images"] != CS_IMAGES or not (miou != miou or 0 <= miou <= 1):
        raise AssertionError(f"cityscapes_eval: {res['images']} images, mIoU {miou}")
    exported = json_.loads((out / "resultPixelLevelSemanticLabeling.json").read_text())
    if "averageScoreClasses" not in exported or official["nbInstanceImages"] != CS_IMAGES or \
            official["classInstScores"] is None:
        raise AssertionError(f"cityscapes_eval: official scores without classes or instances: "
                             f"{sorted(exported)}, {official['nbInstanceImages']} instance images")
    submitted = sorted((out / "submit").glob("*.png"))
    shapes = {read_png(p).shape for p in submitted}
    if len(submitted) != CS_IMAGES or shapes != {CS_LABEL_HW}:
        raise AssertionError(f"cityscapes_eval: submission PNGs {len(submitted)} of {shapes}")
    sec = res["seconds"]
    per = {k: v / CS_IMAGES * 1e3 for k, v in sec.items()}
    decode_ms = decode_s / CS_IMAGES * 1e3
    log("cityscapes_eval", f"CITYSCAPES_EVAL_PARAMS bf16, {CS_IMAGES} val images 1024x2048 -> "
        f"256x512, 1 vote x {STEPS} steps, labels at 1024x2048 ({smi}): wall {wall:.2f} s, "
        f"{CS_IMAGES / wall:.3f} images/s; ms per image: image decode {decode_ms:.1f}, labels "
        f"decode + resize + normalise {per['data'] - decode_ms:.1f}, sampling (DINO included) "
        f"{per['sampling']:.1f}, upsample + argmax {per['labels']:.1f}, confusion "
        f"{per['confusion']:.1f}, PNG dumps {per['dumps']:.1f}, official scoring "
        f"{per['scoring']:.1f}; mIoU {miou:.4f}, official class mIoU "
        f"{official['averageScoreClasses']:.4f}, iIoU {official['averageScoreInstClasses']:.4f}; "
        f"launches {launches}, by path {paths_by}")
    return {"launches": launches, "path_launches": paths_by}


def phase_eval_cli():
    """`python -m ccdm_tpu_torch.cli.eval` on a `.json` params file in a
    subprocess: the LIDC branch on the card, 2 images, T = 10."""
    import os

    params = lidc_eval_params(dataset_val_max_size=2, evaluations=[1, 4], time_steps=10,
                              load_from=None, evaluation_path=str(EVAL_DIR / "cli_out"))
    path = EVAL_DIR / "cli_params.json"
    path.write_text(json.dumps(params))
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ccdm_tpu_torch.cli.eval", str(path)],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CCDM_LIDC_ORIG_PATH=str(EVAL_DIR / "lidc")))
    wall = time.perf_counter() - start
    result = EVAL_DIR / "cli_out" / "lidc_uncertainty_full.json"
    if proc.returncode != 0 or not result.is_file():
        raise AssertionError(f"eval_cli: exit {proc.returncode}, results {result.is_file()}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    res = json.loads(result.read_text())
    if res["count"] != 2:
        raise AssertionError(f"eval_cli: count {res['count']}")
    log("eval_cli", f"python -m ccdm_tpu_torch.cli.eval {path} (LIDC branch, 2 images x 4 "
        f"samples x 10 steps, on the card by default): exit 0 in {wall:.1f} s, GED_4 "
        f"{res['GED_4']:.4f}, {result}")


CS_TRAIN_DIR = Path("build/chip_smoke_cs_train")
CS_TREE_HW = (256, 512)  # the training tree: 1024x2048 cut by 4 a side


def cs_train_params(base, name: str, **overrides):
    """A Cityscapes training config on the phase's tree, into
    `build/chip_smoke_cs_train/<name>`, saving and validating at the given
    steps, without the progress line."""
    params = dict(base, output_path=str(CS_TRAIN_DIR / name), dataset_val_max_size=4,
                  progress_bar=False)
    params.update(overrides)
    return params


def phase_cityscapes_train(smi):
    """The 20-class Cityscapes trainer at full width on the card (see the
    docstring)."""
    import os
    import shutil

    import torch

    from ccdm_tpu_torch import CITYSCAPES_TRAIN_PARAMS
    from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32
    from ccdm_tpu_torch.train.trainer import TrainingRun

    shutil.rmtree(CS_TRAIN_DIR, ignore_errors=True)
    start = time.perf_counter()
    write_cityscapes_tree(CS_TRAIN_DIR / "tree", 32, "train", CS_TREE_HW, seed=EVAL_SEED + 1)
    write_cityscapes_tree(CS_TRAIN_DIR / "tree", 4, "val", CS_TREE_HW, seed=EVAL_SEED + 2)
    tree_s = time.perf_counter() - start
    os.environ["CCDM_CITYSCAPES_PATH"] = str(CS_TRAIN_DIR / "tree")
    params = cs_train_params(CITYSCAPES_TRAIN_PARAMS, "run", save_freq=TRAIN_EVENT,
                             validation_freq=TRAIN_EVENT, display_freq=10)
    run = TrainingRun(params)  # the default device is the card
    if run.device.type != "cuda" or next(run.net.parameters()).dtype != torch.bfloat16:
        raise AssertionError("TrainingRun did not build a bf16 UNet on the card")
    gn_sites = sum(isinstance(m, GroupNorm32) for m in run.net.modules())
    attn_sites = sum(isinstance(m, AttentionBlock) for m in run.net.modules())
    if (gn_sites, attn_sites) != (81, 16) or len(run.train_ds) != 32:
        raise AssertionError(f"sites per UNet call ({gn_sites}, {attn_sites}) != (81, 16), or "
                             f"{len(run.train_ds)} train images")
    image = run.train_ds.get(0, np.random.default_rng(0))["image"]
    hw = tuple(params["dataset_pipeline_train_settings"]["target_size"])
    if image.shape != (*hw, 3):
        raise AssertionError(f"the train pipeline gave {image.shape}, not {hw}")
    metrics, marks, pauses, results, calls, launches, paths = run_training(
        run, TRAIN_STEPS, (1, 10, TRAIN_STEPS))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_train_launches("cityscapes_train", launches, TRAIN_STEPS, calls)
    scores, val_s, grid_s = check_miou("cityscapes_train", results)
    if not (CS_TRAIN_DIR / "run" / "best_miou" / str(TRAIN_EVENT) / "state.pt").is_file():
        raise AssertionError(f"cityscapes_train: no best_miou/{TRAIN_EVENT} checkpoint")
    inside = sum(d for t0, d in pauses if marks[10] <= t0 <= marks[TRAIN_STEPS])
    warm = (marks[TRAIN_STEPS] - marks[10] - inside) / (TRAIN_STEPS - 10)
    cold = marks[1] - marks[0]

    check_round_trip("cityscapes_train", run.state, TrainingRun(dict(
        params, load_from=str(CS_TRAIN_DIR / "run"),
        output_path=str(CS_TRAIN_DIR / "restored"))).state)
    batch = run.batch_size
    losses = [float(m["loss"]) for m in metrics]
    log("cityscapes_train", f"CITYSCAPES_TRAIN_PARAMS bf16 (128x256, C=20, base 32, weighted), "
        f"batch {batch}, {TRAIN_STEPS} steps on 32 train images at {CS_TREE_HW[0]}x"
        f"{CS_TREE_HW[1]} written in {tree_s:.1f} s ({smi}): cold first step {cold:.2f} s, warm "
        f"{warm * 1e3:.2f} ms/step = {batch / warm:.1f} images/s (steps 11-{TRAIN_STEPS}, the "
        f"loader on the host included; the save, validation and grid taken out), peak "
        f"{peak:.2f} GiB; loss {losses[0]:.4g} -> {losses[-1]:.4g}; validation at step "
        f"{TRAIN_EVENT}: mIoU {scores['mIoU']:.4f}, train-split {scores['mIoU_train']:.4f}, "
        f"{val_s:.2f} s; grid {grid_s:.2f} s; {calls} UNet calls of validation and grid; "
        f"launches {launches}, backward by path {paths['group_norm_backward']}; checkpoint "
        f"round trip exact (params, EMA, Adam, step)")
    return {"launches": launches, "path_launches": paths}


DINO_STEPS = 10


def phase_cityscapes_train_dino(smi):
    """`CITYSCAPES_DINO_TRAIN_PARAMS` on phase 18's tree, frozen and
    trainable, then the evaluator on the trainable run (see the
    docstring). Returns the runs' launch counts."""
    import torch

    from ccdm_tpu_torch import CITYSCAPES_DINO_TRAIN_PARAMS
    from ccdm_tpu_torch.data import cityscapes
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator
    from ccdm_tpu_torch.train.checkpoint import load_tree
    from ccdm_tpu_torch.train.state import ENCODER
    from ccdm_tpu_torch.train.trainer import TrainingRun

    runs, ms = {}, {}
    for mode in ("frozen", "trainable"):
        fce = dict(CITYSCAPES_DINO_TRAIN_PARAMS["feature_cond_encoder"], train=mode == "trainable")
        params = cs_train_params(CITYSCAPES_DINO_TRAIN_PARAMS, f"dino_{mode}",
                                 feature_cond_encoder=fce, save_freq=DINO_STEPS,
                                 validation_freq=DINO_STEPS, display_freq=DINO_STEPS)
        run = TrainingRun(params)
        before = {k: v.clone() for k, v in run.encoder_net.state_dict().items()}
        metrics, marks, pauses, results, calls, launches, paths = run_training(
            run, DINO_STEPS, (1, 2, DINO_STEPS))
        check_train_launches(f"cityscapes_train_dino {mode}", launches, DINO_STEPS, calls)
        scores, val_s, _ = check_miou(f"cityscapes_train_dino {mode}", results)
        warm = (marks[DINO_STEPS] - marks[2]) / (DINO_STEPS - 2)  # no pause inside
        saved = set(load_tree(str(CS_TRAIN_DIR / f"dino_{mode}")))
        after = run.encoder_net.state_dict()
        state = run.state
        if mode == "frozen":
            if not all(torch.equal(before[k], after[k]) for k in before):
                raise AssertionError("cityscapes_train_dino: the frozen encoder moved")
            if saved != {"model", "average_model", "opt_state", "step"}:
                raise AssertionError(f"cityscapes_train_dino: frozen checkpoint keys {saved}")
        else:
            moved = [k for k in before if not torch.equal(before[k], after[k])]
            ema_moved = [k for k in before
                         if not torch.equal(before[k], state.ema_params[ENCODER + k])]
            if not moved or not ema_moved:
                raise AssertionError("cityscapes_train_dino: the trainable encoder's masters "
                                     f"({len(moved)} moved) or EMA ({len(ema_moved)}) did not "
                                     "move")
            if not {"feature_cond_encoder", "average_feature_cond_encoder"} <= saved:
                raise AssertionError(f"cityscapes_train_dino: trainable checkpoint keys {saved}")
        images = torch.from_numpy(np.stack([run.train_ds.get(i)["image"]
                                            for i in range(run.batch_size)])).cuda()
        with torch.inference_mode():
            dino_ms = time_ms(lambda: run.encoder(run.encoder_net, images), reps=3, calls=5)
        ms[mode] = (warm, dino_ms)
        runs[f"cityscapes_train_dino_{mode}"] = {"launches": launches, "path_launches": paths}
        log("cityscapes_train_dino", f"{mode}: CITYSCAPES_DINO_TRAIN_PARAMS bf16, ViT-S/8 random "
            f"weights, batch {run.batch_size}, {DINO_STEPS} steps ({smi}): warm "
            f"{warm * 1e3:.2f} ms/step = {run.batch_size / warm:.1f} images/s (steps 3-"
            f"{DINO_STEPS}, the loader included), DINO forward at batch {run.batch_size} "
            f"{dino_ms:.2f} ms = {dino_ms / (warm * 1e3):.1%} of the step; validation mIoU "
            f"{scores['mIoU']:.4f}, train-split {scores['mIoU_train']:.4f}, {val_s:.2f} s; "
            f"launches {launches}, backward by path {paths['group_norm_backward']}; "
            f"checkpoint keys {sorted(saved)}; encoder "
            + ("bit-identical after the run" if mode == "frozen" else
               f"masters moved in {len(moved)}/{len(before)} tensors, EMA in {len(ema_moved)}"))
        del run

    # the evaluator on the trainable run: its EMA UNet and encoder
    ev_params = dict(CITYSCAPES_DINO_TRAIN_PARAMS, load_from=str(CS_TRAIN_DIR / "dino_trainable"),
                     output_path=str(CS_TRAIN_DIR / "dino_eval"),
                     feature_cond_encoder=dict(CITYSCAPES_DINO_TRAIN_PARAMS["feature_cond_encoder"],
                                               train=True),
                     evaluation={"resolution": "dataloader", "evaluations": 1,
                                 "evaluation_vote_strategy": "confidence"})
    val = cityscapes.validation_dataset(max_size=1, params=CITYSCAPES_DINO_TRAIN_PARAMS)
    image = torch.from_numpy(val.get(0)["image"][None]).cuda()
    ev = CityscapesEvaluator(ev_params)
    ev.build(tuple(image.shape[1:]), 1)
    for name, p in ev.feature_net.named_parameters():
        if not torch.equal(p.detach().cpu(), state.ema_params[ENCODER + name].cpu()):
            raise AssertionError(f"CityscapesEvaluator's encoder {name} is not the EMA's")
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    probs = ev.predict_batch(image, 3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, _ = read_counts()
    want = {"group_norm": 81 * STEPS, "flash_attention": 16 * STEPS, "group_norm_backward": 0, "quant_conv": 0}
    if launches != want or tuple(probs.shape) != (*image.shape[:3], 20) or not bool(
            torch.isfinite(probs).all()):
        raise AssertionError(f"cityscapes_train_dino eval: launches {launches} != {want} or "
                             f"probabilities {tuple(probs.shape)}")
    runs["cityscapes_train_dino_eval"] = {"launches": launches, "path_launches": {}}
    log("cityscapes_train_dino", f"CityscapesEvaluator with load_from on the trainable run "
        f"(EMA UNet and EMA encoder, bit-exact): 1 image x 1 vote x {STEPS} steps at "
        f"{image.shape[1]}x{image.shape[2]} in {wall:.2f} s; launches {launches}; frozen vs "
        f"trainable warm ms/step "
        f"{ms['frozen'][0] * 1e3:.2f} / {ms['trainable'][0] * 1e3:.2f}")
    return runs


def phase_cityscapes_train_reference():
    """One fp32 train step on the card (kernels, TF32 off) against the CPU
    (plain versions): Cityscapes widths, 20 classes with the class weights,
    a trainable tiny DINO, batch 2 of 32x64, the same injected t and x_t."""
    import torch

    from ccdm_tpu_torch import CITYSCAPES_DINO_TRAIN_PARAMS
    from ccdm_tpu_torch.data.cityscapes import get_weights
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.models.dino import DinoFeatureEncoder
    from ccdm_tpu_torch.train.step import train_loss

    fce = dict(CITYSCAPES_DINO_TRAIN_PARAMS["feature_cond_encoder"], train=True, source_layer=1,
               vit_config=dict(embed_dim=48, depth=2, num_heads=2, patch_size=8))
    params = dict(CITYSCAPES_DINO_TRAIN_PARAMS, compute_dtype="float32", feature_cond_encoder=fce)
    enc = DinoFeatureEncoder(fce)
    cpu = build_model(params, 20, 3, 128, device="cpu")
    unzero_(cpu.unet, seed=17)
    cpu_vit = enc.init(device="cpu")
    unzero_(cpu_vit, seed=18)
    card = build_model(params, 20, 3, 128)
    card.unet.load_state_dict(cpu.unet.state_dict())
    card_vit = enc.init()
    card_vit.load_state_dict(cpu_vit.state_dict())
    gen = torch.Generator().manual_seed(19)
    b, h, w = 2, 32, 64
    labels = torch.randint(0, 20, (b, h, w), generator=gen)
    batch = {"image": torch.randn(b, h, w, 3, generator=gen),
             "x0": torch.nn.functional.one_hot(labels, 20).float()}
    t = torch.tensor([2, int(params["time_steps"]) * 3 // 5])
    xt = torch.nn.functional.one_hot(torch.randint(0, 20, (b, h, w), generator=gen), 20).float()
    cw = torch.from_numpy(get_weights())
    results = []
    for model, vit, dev in ((cpu, cpu_vit, "cpu"), (card, card_vit, "cuda")):
        on = {k: v.to(dev) for k, v in batch.items()}
        fc = enc(vit, on["image"])
        loss, _ = train_loss(model, model.unet, on, None, cw.to(dev), fc, t=t.to(dev),
                             xt=xt.to(dev))
        loss.backward()
        results.append((float(loss.detach()),
                        {n: p.grad.cpu() for n, p in model.unet.named_parameters()},
                        {n: p.grad.cpu() if p.grad is not None else torch.zeros_like(p).cpu()
                         for n, p in vit.named_parameters()}))
    (ref_loss, ref, ref_enc), (loss, grads, enc_grads) = results
    rel = abs(loss - ref_loss) / abs(ref_loss)
    if not rel <= 1e-5:
        raise AssertionError(f"cityscapes_train_reference: loss {loss} vs CPU {ref_loss}")
    worst, worst_zero, zero = grad_agreement(ref, grads, "cityscapes_train_reference")
    enc_worst, enc_zero, _ = grad_agreement(ref_enc, enc_grads, "cityscapes_train_reference "
                                            "encoder", key_rows=False)
    log("cityscapes_train_reference", f"fp32 train step, Cityscapes widths, C=20 weighted, "
        f"trainable tiny DINO, batch {b} of {h}x{w}, card vs CPU: loss {loss:.6g} vs "
        f"{ref_loss:.6g} ({rel:.2g} relative), worst UNet gradient err/max {worst[0]:.3g} "
        f"({worst[1]}), analytically zero within {worst_zero:.2g} of the largest ({len(zero)} "
        f"tensors and the key rows); worst encoder gradient err/max {enc_worst[0]:.3g} "
        f"({enc_worst[1]}), zeros within {enc_zero:.2g}")


QUANT_MAPS = 0.97  # phase 23: the least share of the maps card and CPU agree on


def quant_site_shapes(unet, *inputs):
    """The int8 conv sites of one UNet call on `inputs`, by (input shape
    without the batch, kernel, stride, Cout): how many sites each."""
    import collections

    import torch

    from ccdm_tpu_torch.ops import quant

    shapes = collections.Counter()

    def record(mod, args):
        shapes[(tuple(args[0].shape[1:]), mod.kernel_size[0], mod.stride[0],
                mod.out_channels)] += 1

    hooks = [m.register_forward_pre_hook(record) for _, m in quant.quant_sites(unet)]
    with torch.inference_mode():
        unet(*inputs)
    for h in hooks:
        h.remove()
    return shapes


def quant_bound(x, w_q, out, k: int, cout: int):
    """`bound_ms` of one int8 conv: x, w_q, s_w and the bias read once, the
    output written once; 2 M N K int8 operations with K = Cin k^2."""
    nbytes = (x.numel() * x.element_size() + w_q.numel() + 8 * cout
              + out.numel() * out.element_size())
    m = out.shape[0] * out.shape[2] * out.shape[3]
    return bound_ms(nbytes, 2 * m * cout * x.shape[1] * k * k, "int8")


def quant_case(gen, shape, k: int, stride: int, cout: int, dtype, static: bool,
               timed: bool = False, plain_timed: bool = False):
    """One int8 conv case: the kernel against its plain version, bit for bit,
    and a second call against the first; with `timed`, the kernel's, the
    bf16/fp32 cuDNN conv's (`float_conv_ms`, the float path's cost) and
    optionally the plain version's device times beside the bound."""
    import torch
    import torch.nn.functional as F

    from ccdm_tpu_torch.ops import quant

    cin = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2).to(dtype)
    weight = torch.randn(cout, cin, k, k, generator=gen, device="cuda") / math.sqrt(cin * k * k)
    bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
    w_q, s_w = quant.weight_codes(weight)
    s_x = (quant.static_act_scale(x.abs().amax() * 0.7) if static
           else quant.dynamic_act_scale(x))
    pad = (k - 1) // 2

    def kernel():
        return quant.quant_conv(x, w_q, s_w, bias, s_x, k, stride, pad)

    out = kernel()
    again = kernel()
    ref = quant.quant_conv_plain(x, w_q, s_w, bias, s_x, k, stride, pad)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if not (torch.equal(out, ref) and torch.equal(out, again)):
        raise AssertionError(f"quant_conv {tuple(shape)} k{k} s{stride} -> {cout} {dtype} "
                             f"{'static' if static else 'dynamic'}: kernel != plain (max err "
                             f"{err:.3g}) or two calls differ")
    plan = quant._plan_conv(x.shape, cout, k, stride, dtype)
    row = {"shape": list(shape), "kernel": k, "stride": stride, "cout": cout,
           "dtype": str(dtype)[6:], "scale": "static" if static else "dynamic",
           "max_abs_err": err, "path": plan.path, "plan": list(plan.args())}
    if timed:
        wf, bf = weight.to(dtype), bias.to(dtype)
        bound, by = quant_bound(x, w_q, out, k, cout)
        ms = time_ms(kernel)
        row.update(ms=ms, float_conv_ms=time_ms(lambda: F.conv2d(x, wf, bf, stride, pad)),
                   plain_ms=(time_ms(lambda: quant.quant_conv_plain(
                       x, w_q, s_w, bias, s_x, k, stride, pad), reps=3, calls=2)
                       if plain_timed else None),
                   bound_ms=bound, bound_by=by, share=bound / ms, library_ms=None)
    return row


def quant_host_ms(model, sites, batch: int = 32):
    """Host ms of one int8 UNet call of the flagship `model` at `batch` on
    static scales (the launches queued, not waited for): medians of 5 with
    the kernel's plans cached and with the plan cache emptied before each
    call; the plans of the call's `sites` alone, uncached and cached; and
    the call's device ms (CUDA events)."""
    import torch

    from ccdm_tpu_torch.ops import quant

    table = {name: torch.tensor(3.0, device="cuda") for name, _ in quant.quant_sites(model.unet)}
    inputs = (torch.zeros(batch, 128, 128, 2, device="cuda"),
              torch.zeros(batch, 128, 128, 1, device="cuda"), torch.full((batch,), 5, device="cuda"))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def call(cold: bool):
        if cold:
            quant._plan_conv.cache_clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode(), quant.static_scales(model.unet, table):
            start.record()
            model.unet(*inputs)
            end.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return host, start.elapsed_time(end)

    call(False)
    warm = [call(False) for _ in range(5)]
    cold = [call(True)[0] for _ in range(5)]
    plans = [((batch, *chw), cout, k, stride, torch.bfloat16)
             for (chw, k, stride, cout), count in sites.items() for _ in range(count)]

    def plan_ms(fn):
        t0 = time.perf_counter()
        for args in plans:
            fn(*args)
        return (time.perf_counter() - t0) * 1e3

    return {"host_ms_cached": statistics.median(h for h, _ in warm),
            "host_ms_uncached": statistics.median(cold),
            "plans_ms_uncached": statistics.median(plan_ms(quant._plan_conv.__wrapped__)
                                                   for _ in range(5)),
            "plans_ms_cached": statistics.median(plan_ms(quant._plan_conv) for _ in range(5)),
            "device_ms": statistics.median(d for _, d in warm)}


def phase_quant_conv(gen):
    """K3 against its plain version at every int8 site shape of the flagship
    (batch 32 and 128) and of Cityscapes (batch 2), bf16 with a static
    scale as the fast eval runs it; dtype and scale variants on the ragged
    and strided sites and on each path's edge cases; times beside the bound
    and the float path's cuDNN conv; the plan's and a UNet call's host
    time."""
    import torch

    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS, FLAGSHIP_PARAMS
    from ccdm_tpu_torch.models.builder import build_model

    bf16, f32 = torch.bfloat16, torch.float32
    flag = build_model(dict(FLAGSHIP_PARAMS, quantized_inference=True), 2, 1, 128)
    flag_sites = quant_site_shapes(flag.unet, torch.zeros(1, 128, 128, 2, device="cuda"),
                                   torch.zeros(1, 128, 128, 1, device="cuda"),
                                   torch.full((1,), 5, device="cuda"))
    cs = build_model(dict(CITYSCAPES_EVAL_PARAMS, quantized_inference=True), 20, 3, 256)
    cs_sites = quant_site_shapes(cs.unet, torch.zeros(1, *CS_HW, 20, device="cuda"),
                                 torch.zeros(1, *CS_HW, 3, device="cuda"),
                                 torch.full((1,), 5, device="cuda"),
                                 torch.zeros(1, CS_HW[0] // 8, CS_HW[1] // 8, 384, device="cuda"))
    host = quant_host_ms(flag, flag_sites)
    log("quant_conv", f"host side of an int8 flagship UNet call at batch 32 (static scales): "
        f"{host['host_ms_cached']:.3f} ms of host time with the kernel's plans cached, "
        f"{host['host_ms_uncached']:.3f} ms with the plan cache emptied first; the "
        f"{sum(flag_sites.values())} sites' plans alone {host['plans_ms_uncached']:.3f} ms "
        f"uncached, {host['plans_ms_cached']:.4f} ms cached; the call's device time "
        f"{host['device_ms']:.3f} ms")
    del flag, cs
    if sum(flag_sites.values()) != 81 or sum(cs_sites.values()) != 96:
        raise AssertionError(f"int8 sites a UNet call: flagship {sum(flag_sites.values())}, "
                             f"Cityscapes {sum(cs_sites.values())}, not 81 and 96")
    rows, worst = [], 0.0
    per_call = {}
    for name, sites, batches in (("flagship", flag_sites, (32, 128)),
                                 ("cityscapes", cs_sites, (CS_IMAGES,))):
        for batch in batches:
            total = {"ms": 0.0, "float_conv_ms": 0.0, "bound_ms": 0.0}
            paths = collections.Counter()
            for (chw, k, stride, cout), count in sorted(sites.items()):
                headline = (name, batch, chw[0], chw[1], k, stride) in (
                    ("flagship", 128, 32, 128, 3, 1), ("flagship", 32, 32, 128, 3, 1),
                    ("flagship", 128, 3, 128, 3, 1), ("cityscapes", 2, 128, 256, 3, 1),
                    ("cityscapes", 2, 23, 256, 3, 1), ("cityscapes", 2, 640, 32, 3, 1))
                row = quant_case(gen, (batch, *chw), k, stride, cout, bf16, True, timed=True,
                                 plain_timed=headline)
                row.update(config=name, sites=count)
                paths[row["path"]] += count
                for key in total:
                    total[key] += count * row[key]
                worst = max(worst, row["max_abs_err"])
                rows.append(row)
                torch.cuda.empty_cache()
            per_call[f"{name}_b{batch}"] = total
            log("quant_conv", f"{name} batch {batch}: {sum(sites.values())} int8 sites "
                f"({len(sites)} shapes; by path {dict(paths)}) a UNet call, each bit-equal to "
                f"the plain version; sum over a call: kernel {total['ms']:.3f} ms, bf16 cuDNN "
                f"conv {total['float_conv_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms "
                f"({total['bound_ms'] / total['ms']:.1%} of bound)")
    # dtype and scale variants on the ragged and strided sites
    variants = [((32, 32, 128, 128), 3, 1, 32), ((32, 3, 128, 128), 3, 1, 32),
                ((32, 32, 128, 128), 3, 2, 32), ((32, 64, 64, 64), 1, 1, 32),
                ((2, 23, 256, 512), 3, 1, 128), ((2, 640, 32, 64), 3, 1, 256),
                ((3, 40, 13, 21), 3, 1, 20),
                # the ring at ragged H and W (element loads), stride 2 on odd sizes, and
                # split K at the deep sites
                ((2, 32, 37, 77), 3, 1, 48), ((2, 32, 33, 67), 3, 2, 40),
                ((2, 512, 8, 16), 3, 1, 512), ((2, 1024, 4, 8), 1, 1, 512)]
    for shape, k, stride, cout in variants:
        for dtype, static in ((f32, True), (f32, False), (bf16, False)):
            worst = max(worst, quant_case(gen, shape, k, stride, cout, dtype, static)["max_abs_err"])
    for row in rows:
        if row["plain_ms"] is not None:
            log("quant_conv", f"{row['config']} {row['shape']} {row['kernel']}x{row['kernel']} "
                f"s{row['stride']} -> {row['cout']} bf16 static: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f}, bf16 cuDNN conv {row['float_conv_ms']:.4f}, bound "
                f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}), {row['share']:.1%} of bound")
    log("quant_conv", f"{len(rows)} timed site cases and {3 * len(variants)} fp32/dynamic "
        f"variants (the flagship in_conv K = 27, the Cityscapes in_conv K = 207, stride 2, 1x1, "
        f"the DINO concat's 640 channels, ragged 13x21 -> 20, the ring on ragged 37x77 and "
        f"stride 2 on 33x67, K split 16 and 32 ways): all bit-equal, two calls equal; "
        f"per-site rows in build/chip_smoke_quant_conv.json")
    Path("build").mkdir(exist_ok=True)
    Path("build/chip_smoke_quant_conv.json").write_text(json.dumps(
        {"sites": rows, "per_call": per_call}, indent=1))
    head = next(r for r in rows if r["config"] == "flagship" and r["shape"] == [128, 32, 128, 128]
                and r["kernel"] == 3 and r["stride"] == 1)
    cs_head = next(r for r in rows if r["config"] == "cityscapes"
                   and r["shape"] == [2, 128, 256, 512] and r["kernel"] == 3)
    keys = ("ms", "plain_ms", "float_conv_ms", "bound_ms", "bound_by", "library_ms")
    return (worst, {k: head[k] for k in keys}, {k: cs_head[k] for k in keys},
            {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in per_call.items()},
            {k: round(v, 4) for k, v in host.items()})


def unet_sites(unet):
    """Per kernel, its sites in a whole UNet call and in an encoder-reuse
    replay (the middle, the decoder and the head)."""
    from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32
    from ccdm_tpu_torch.ops.quant import QuantConv2d

    replayed = [unet.middle_block, *unet.output_blocks, unet.out]

    def count(kind, modules):
        return sum(isinstance(m, kind) for mod in modules for m in mod.modules())

    kinds = {"group_norm": GroupNorm32, "flash_attention": AttentionBlock,
             "quant_conv": QuantConv2d}
    return ({k: count(v, [unet]) for k, v in kinds.items()},
            {k: count(v, replayed) for k, v in kinds.items()})


def expected_launches(full_sites, replay_sites, full: int, replays: int, float_calls: int = 0):
    """Launch counts of `full` whole UNet calls, `replays` replays and
    `float_calls` calibration calls (float convs: no int8 launches)."""
    want = {k: full * full_sites[k] + replays * replay_sites[k] for k in full_sites}
    want["group_norm"] += float_calls * full_sites["group_norm"]
    want["flash_attention"] += float_calls * full_sites["flash_attention"]
    want["group_norm_backward"] = 0
    return want


def check_lidc_results(name: str, res, count: int) -> None:
    bad = [k for k in ("GED_1", "GED_4", "GED_8", "GED_16") if not 0 <= res.get(k, 0) <= 2]
    bad += [k for k in ("HMIoU_1", "HMIoU_4", "HMIoU_8", "HMIoU_16") if not 0 <= res.get(k, 0) <= 1]
    bad += [k for k in ("IoU", "Dice") if not all(0 <= v <= 1 for v in res[k])]
    if res["count"] != count or bad:
        raise AssertionError(f"{name}: count {res['count']}, out of range: {bad} in {res}")


def phase_quant_eval(smi, float_rate: float):
    """`EVAL_LIDC_FAST_PARAMS` (int8 on calibrated static scales, encoder
    reuse 2) through the LIDC harness on phase 13's tree with phase 11's
    weights; the dynamic mode at R = 1; `CityscapesEvaluator` at full width
    with static scales."""
    import torch

    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS, EVAL_LIDC_FAST_PARAMS
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator
    from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty
    from ccdm_tpu_torch.models.builder import build_model

    full_sites, replay_sites = unet_sites(build_model(EVAL_LIDC_FAST_PARAMS, 2, 1, 128).unet)
    if (full_sites["quant_conv"], replay_sites["quant_conv"]) != (81, 53):
        raise AssertionError(f"flagship int8 sites {full_sites}, replay {replay_sites}")
    runs, rates = {}, {}
    base = dict(EVAL_LIDC_FAST_PARAMS, dataset_file="datasets.lidc_orig",
                load_from="build/chip_smoke_train/run", seed=EVAL_SEED)
    for name, overrides, images in (
            ("eval_lidc_fast", {}, 8),
            ("eval_lidc_dynamic", {"quantized_inference": True, "encoder_reuse": 1,
                                   "dataset_val_max_size": 2}, 2)):
        params = dict(base, evaluation_path=str(EVAL_DIR / f"{name}_out"), **overrides)
        reuse = int(params["encoder_reuse"])
        torch.cuda.synchronize()
        reset_counts()
        start = time.perf_counter()
        res = eval_lidc_uncertainty(params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches, _ = read_counts()
        batches = images // 2
        full = len(range(0, STEPS, reuse))
        calib = 8 if str(params["quantized_inference"]) == "static" else 0
        want = expected_launches(full_sites, replay_sites, batches * full,
                                 batches * (STEPS - full), calib)
        if launches != want:
            raise AssertionError(f"{name}: launches {launches} != {want} ({batches} batches x "
                                 f"({full} full UNet calls, {STEPS - full} replays), {calib} "
                                 f"calibration calls)")
        check_lidc_results(name, res, images)
        rates[name] = res["samples_per_sec"]
        log("quant_eval", f"{name}: quantized_inference {params['quantized_inference']!r}, "
            f"encoder reuse {reuse}, {images} PNG images x 16 samples x {STEPS} steps at batch 2 "
            f"({smi}): wall {wall:.2f} s, calibration {res['calibration_seconds']:.2f} s, harness "
            f"{res['samples_per_sec']:.2f} samples/s against the float harness's "
            f"{float_rate:.2f} (phase 13); GED 1/4/8/16 "
            + "/".join(f"{res[f'GED_{s}']:.4f}" for s in (1, 4, 8, 16)) + ", HM-IoU_16 "
            + f"{res['HMIoU_16']:.4f}, Dice {[round(v, 4) for v in res['Dice']]}; launches "
            f"{launches}")
        runs[name] = {"launches": launches, "path_launches": {}}

    # the eval CLI on the card by default, on .json params as the card reads
    # them: the step sweep with static scales and reuse 2, then dynamic
    for name, overrides in (
            ("cli_sweep_static", {"dataset_file": "datasets.lidc_orig_sampling_speed",
                                  "step_sweep": [10, 5]}),
            ("cli_dynamic", {"quantized_inference": True, "encoder_reuse": 1,
                             "time_steps": 10})):
        out = EVAL_DIR / f"{name}_out"
        path = EVAL_DIR / f"{name}.json"
        path.write_text(json.dumps(dict(base, dataset_val_max_size=2, evaluations=[1, 4],
                                        evaluation_path=str(out), **overrides)))
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ccdm_tpu_torch.cli.eval", str(path)],
                              capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - start
        files = sorted(out.glob("lidc_uncertainty_*.json"))
        results = [json.loads(f.read_text()) for f in files]
        want_files = 2 if "sweep" in name else 1
        static = "sweep" in name
        if proc.returncode != 0 or len(files) != want_files or any(
                r["count"] != 2 or (r["calibration_seconds"] > 0) != static for r in results):
            raise AssertionError(f"{name}: exit {proc.returncode}, results {files}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        log("quant_eval", f"{name}: python -m ccdm_tpu_torch.cli.eval {path} (on the card by "
            f"default): exit 0 in {wall:.1f} s, " + ", ".join(
                f"{f.name} GED_4 {r['GED_4']:.4f} calibration {r['calibration_seconds']:.2f} s"
                for f, r in zip(files, results)))

    # Cityscapes at full width on phase 16's checkpoint, static scales
    ev = CityscapesEvaluator(dict(CITYSCAPES_EVAL_PARAMS, quantized_inference="static",
                                  load_from=str(EVAL_DIR / "cs_ckpt"),
                                  output_path=str(EVAL_DIR / "cs_quant_out")))
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.randn(CS_IMAGES, *CS_HW, 3, generator=gen, device="cuda")
    ev.build((*CS_HW, 3), CS_IMAGES, calibration_images=images)
    cs_full, _ = unet_sites(ev.model.unet)
    if cs_full["quant_conv"] != 96 or len(ev.model.quant_scales) != 96:
        raise AssertionError(f"Cityscapes int8 sites {cs_full}, {len(ev.model.quant_scales)} "
                             f"calibrated scales")
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    mean = ev.predict_batch(images, 6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, _ = read_counts()
    labels = ev.predict_labels(mean, CS_LABEL_HW)
    want = expected_launches(cs_full, cs_full, STEPS, 0)
    if launches != want:
        raise AssertionError(f"cityscapes_quant: launches {launches} != {want}")
    sum_err = float((mean.sum(-1) - 1).abs().max())
    if tuple(mean.shape) != (CS_IMAGES, *CS_HW, 20) or not sum_err <= 1e-3 or not (
            0 <= int(labels.min()) and int(labels.max()) <= 18):
        raise AssertionError(f"cityscapes_quant: probabilities {tuple(mean.shape)} sum err "
                             f"{sum_err}, labels in [{int(labels.min())}, {int(labels.max())}]")
    log("quant_eval", f"cityscapes_quant: CITYSCAPES_EVAL_PARAMS with quantized_inference "
        f"'static', {CS_IMAGES} images x 1 vote x {STEPS} steps at 256x512, R=1 ({smi}): "
        f"calibration {ev.calibration_seconds:.2f} s (8 float steps with DINO), wall "
        f"{wall:.2f} s, {CS_IMAGES / wall:.3f} images/s, {wall / STEPS * 1e3:.2f} ms per step; "
        f"labels in [{int(labels.min())}, {int(labels.max())}]; launches {launches}")
    runs["cityscapes_quant"] = {"launches": launches, "path_launches": {}}
    return runs, rates


def sites_against_cpu(card_net, cpu_net, table):
    """Forward hooks on every int8 site of `card_net`: each call's output
    against the plain version on the CPU on the same input, with the CPU
    net's weight codes and, given `table`, that table's static scale (else
    the input's dynamic scale). Returns (hooks, {site: [calls, bit-equal]})."""
    import torch

    from ccdm_tpu_torch.ops import quant

    seen = {}

    def check(mod, args, out, name):
        ref_mod = cpu_net.get_submodule(name)
        x = args[0].cpu()
        s_x = (quant.static_act_scale(table[name].cpu()) if table is not None
               else quant.dynamic_act_scale(x))
        ref = quant.quant_conv_plain(x, *ref_mod.codes(), ref_mod.bias, s_x,
                                     mod.kernel_size[0], mod.stride[0], mod.padding[0])
        calls = seen.setdefault(name, [0, 0])
        calls[0] += 1
        calls[1] += int(torch.equal(out.cpu(), ref))

    hooks = [m.register_forward_hook(lambda mod, args, out, n=name: check(mod, args, out, n))
             for name, m in quant.quant_sites(card_net)]
    return hooks, seen


def phase_quant_reference():
    """The fp32 int8 sampler on the card (kernels, TF32 off) against the CPU
    (plain versions), flagship widths at 64x64, 1 image x 2 samples x 3
    steps, the same injected noise, dynamic and on one calibrated table:
    every site call of the card's run bit-equal to the plain version on the
    CPU with the expected scale, and the whole run near the CPU's; and the
    calibration itself, card against CPU."""
    import torch

    from ccdm_tpu_torch import FLAGSHIP_PARAMS
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.ops import quant

    params = dict(FLAGSHIP_PARAMS, step_T_sample="confidence", compute_dtype="float32",
                  quantized_inference=True)
    cpu = build_model(params, 2, 1, 128, device="cpu")
    unzero_(cpu.unet, seed=17)
    card = build_model(params, 2, 1, 128)
    card.unet.load_state_dict(cpu.unet.state_dict())
    gen = torch.Generator().manual_seed(18)
    s, k, hw = 2, 3, 64
    images = torch.randn(1, hw, hw, 1, generator=gen)
    prior = torch.nn.functional.one_hot(torch.randint(0, 2, (s, hw, hw), generator=gen), 2).float()
    gumbel = -torch.log(-torch.log(torch.rand(k, s, hw, hw, 2, generator=gen).clamp_min(1e-38)))
    flt = build_model(dict(params, quantized_inference=False), 2, 1, 128, device="cpu")
    flt.unet.load_state_dict(cpu.unet.state_dict())
    float_ref = make_prob_sampler(flt, s, k)(flt.unet, images, prior=prior, gumbel=gumbel)
    table = quant.calibrate_sampler(cpu, cpu.unet, images)
    card_table = quant.calibrate_sampler(card, card.unet, images.cuda())
    # fp32 convs (TF32 off) summed in another order, and the same noise streams
    table_err = max(abs(float(card_table[n]) - float(v)) / float(v) for n, v in table.items())
    if set(card_table) != set(table) or len(table) != 81 or not table_err <= 1e-3:
        raise AssertionError(f"quant_reference: card calibration {len(card_table)} sites, "
                             f"rel err {table_err} against the CPU's {len(table)}")
    results = []
    for mode, (ref_model, card_model) in (
            ("dynamic", (cpu, card)),
            ("static", (cpu.with_quant_scales(table),
                        card.with_quant_scales({n: v.cuda() for n, v in table.items()})))):
        ref = make_prob_sampler(ref_model, s, k)(ref_model.unet, images, prior=prior,
                                                 gumbel=gumbel)
        hooks, seen = sites_against_cpu(card.unet, cpu.unet, table if mode == "static" else None)
        try:
            out = make_prob_sampler(card_model, s, k)(
                card_model.unet, images.cuda(), prior=prior.cuda(), gumbel=gumbel.cuda()).cpu()
        finally:
            for h in hooks:
                h.remove()
        # where codes cannot move: each site call of the card's run, on its
        # own input, equals the plain version with the expected scale; a site
        # left in float, a wrong scale or a wrong weight code fails here
        if len(seen) != 81 or any(calls != [k, k] for calls in seen.values()):
            raise AssertionError(f"quant_reference {mode}: site calls [calls, bit-equal to "
                                 f"the CPU's plain version] {seen}, expected [{k}, {k}] at "
                                 f"81 sites")
        # the whole run: the float parts (GroupNorm, attention) sum in another
        # order on each device, and an ulp moves an int8 code wherever an
        # activation sits at a rounding boundary; moved codes compound over
        # the 81 sites (tests/test_torch_quant.py measures the same drift
        # against the JAX package), so two correct int8 runs differ by about
        # as much as int8 differs from float. Held: the mean |dp| between
        # card and CPU at most twice the CPU int8 run's mean distance from
        # the float run (two roundings of one trajectory, each that far from
        # it), and the maps agreeing on >= QUANT_MAPS of the pixels
        agree = out.argmax(-1) == ref.argmax(-1)
        share, mean_dp = float(agree.float().mean()), float((out - ref).abs().mean())
        int8_noise = float((ref - float_ref).abs().mean())
        if not (share >= QUANT_MAPS and mean_dp <= 2 * int8_noise):
            raise AssertionError(f"quant_reference {mode}: maps agree on {share}, mean |dp| "
                                 f"{mean_dp} against int8's own {int8_noise} from float")
        results.append(f"{mode}: {81 * k} site calls bit-equal to the CPU's plain version, "
                       f"maps agree on {share:.5f}, mean |dp| {mean_dp:.3g} (int8 "
                       f"from float on the CPU: {int8_noise:.3g}), largest "
                       f"{float((out - ref).abs().max()):.3g}")
    log("quant_reference", f"fp32 int8 sampler, 1 image {hw}x{hw} x {s} samples x {k} steps, "
        f"card vs CPU (tolerance: each site call bit for bit; the run's maps >= "
        f"{QUANT_MAPS}, mean |dp| <= twice int8's own from float): "
        + "; ".join(results) + f"; calibration tables (81 sites, 8 steps) within {table_err:.3g} "
        f"relative")

DP_DIR = Path("build/chip_smoke_dp")
DP_RANKS, DP_STEPS, DP_EVAL_STEPS, DP_SEED = 2, 20, 50, 5


def dp_step(masters, rows=slice(None), draws=None):
    """One process's part of the fp32 data-parallel step: `DEMO_TRAIN_PARAMS`
    in fp32 on the card from `masters`, rows `rows` of a global batch of 16
    synthetic lesions at 128x128: the loss and the (reduced) gradients of a
    first step, with the step's own draws or `draws` `(t, x_t)` of the
    global batch, then, without `draws`, the masters after 3 Adam steps
    (CPU tensors)."""
    import torch

    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.train.optimizer import build_optimizer
    from ccdm_tpu_torch.train.state import create_train_state, master_params
    from ccdm_tpu_torch.train.step import make_train_step

    params = dict(DEMO_TRAIN_PARAMS, compute_dtype="float32")
    model = build_model(params, 2, 1, 128)
    with torch.no_grad():
        for name, prm in model.unet.named_parameters():
            prm.copy_(masters[name])
    batch, _, _ = lesion_batch(16, 128, seed=24)
    batch = {k: v[rows].cuda() for k, v in batch.items()}
    tx, schedule = build_optimizer(params, steps_per_epoch=100)
    state = create_train_state(master_params(model.unet), tx,
                               polyak_alpha=params["polyak_alpha"])
    step = make_train_step(model, torch.ones(2, device="cuda"), schedule)
    injected = {} if draws is None else {"t": draws[0][rows], "xt": draws[1][rows]}
    grads, m = step.gradients(state, model.unet, batch, DP_SEED, **injected)
    loss, grads = float(m["loss"]), {k: g.cpu() for k, g in grads.items()}
    if draws is not None:
        return loss, grads, None
    for _ in range(3):
        step(state, model.unet, batch, DP_SEED)
    return loss, grads, {k: v.cpu() for k, v in state.params.items()}


def dp_draws():
    """`(t, x_t)` of `dp_step`'s global batch as its first step draws them
    (`train/step.py`: from the generator of `(seed, step)`, t then the
    Gumbel noise, for all 16 rows)."""
    import torch

    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.diffusion.categorical import (
        gumbel_noise,
        q_xt_given_x0_probs,
        sample_onehot,
    )
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.train.step import step_seed

    diffusion = build_model(dict(DEMO_TRAIN_PARAMS, compute_dtype="float32"), 2, 1,
                            128).diffusion
    x0 = lesion_batch(16, 128, seed=24)[0]["x0"].cuda()
    gen = torch.Generator(device="cuda").manual_seed(step_seed(DP_SEED, 0))
    t = torch.randint(1, diffusion.time_steps + 1, (16,), generator=gen, device="cuda")
    gumbel = gumbel_noise(x0.shape, gen, x0.device)
    return t, sample_onehot(q_xt_given_x0_probs(diffusion, x0, t), gumbel=gumbel)


def dp_child(rank: int) -> None:
    """One rank of phase 24 (`chip_smoke.py --data-parallel-rank R`): joins
    the phase's gloo group on cuda:0 and runs the fp32 step, the bf16
    `TrainingRun` and the LIDC harness; its results go to
    `build/chip_smoke_dp/rank<R>.pt`."""
    import os

    import torch
    import torch.distributed as dist

    from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty
    from ccdm_tpu_torch.models.layers import AttentionBlock, GroupNorm32
    from ccdm_tpu_torch.train import checkpoint
    from ccdm_tpu_torch.train import step as train_step
    from ccdm_tpu_torch.train.trainer import TrainingRun

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", rank=rank, world_size=DP_RANKS,
                            init_method=f"tcp://127.0.0.1:{os.environ['DP_PORT']}")
    out = {}
    masters = torch.load(DP_DIR / "masters.pt")
    # this rank's own gradients, as they enter the all-reduce
    local = []
    reduce = train_step._reduce_gradients

    def spy(grads, *args):
        local.append({k: g.detach().cpu().clone() for k, g in grads.items()})
        return reduce(grads, *args)

    train_step._reduce_gradients = spy
    rows = slice(rank, None, DP_RANKS)
    out["step"] = dp_step(masters, rows)
    out["local"] = local[0]  # the first step's
    # the same rows and draws with cuDNN held to its deterministic algorithms
    torch.backends.cudnn.deterministic = True
    local.clear()
    dp_step(masters, rows, dp_draws())
    out["local_pinned"] = local[0]
    torch.backends.cudnn.deterministic = False
    train_step._reduce_gradients = reduce

    # the bf16 trainer over two ranks: a save and a validation at step 20
    writes = []
    write = checkpoint._write
    checkpoint._write = lambda *a: writes.append(a[0]) or write(*a)
    run = TrainingRun(dict(_dp_train_params(), output_path=str(DP_DIR / "run")))
    sites = (sum(isinstance(m, GroupNorm32) for m in run.net.modules()),
             sum(isinstance(m, AttentionBlock) for m in run.net.modules()))
    metrics, marks, pauses, _, calls, launches, paths = run_training(
        run, DP_STEPS, (1, 10, DP_STEPS))
    check_train_launches(f"data_parallel rank {rank}", launches, DP_STEPS, calls, *sites)
    inside = sum(d for t0, d in pauses if marks[10] <= t0 <= marks[DP_STEPS])
    out["train"] = {"launches": launches, "path_launches": paths, "calls": calls,
                    "writes": writes, "steps_per_epoch": run.steps_per_epoch,
                    "warm_ms": (marks[DP_STEPS] - marks[10] - inside) / (DP_STEPS - 10) * 1e3,
                    "losses": [float(m["loss"]) for m in metrics]}
    torch.save(run.state.tree(), DP_DIR / f"state_rank{rank}.pt")

    # the step's all-reduce alone: the fp32 gradients and the loss, one buffer
    flat = torch.zeros(sum(v.numel() for v in run.state.params.values()) + 1, device="cuda")
    for _ in range(3):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(10):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    out["allreduce"] = {"ms": (time.perf_counter() - start) / 10 * 1e3,
                        "bytes": flat.numel() * 4}

    # the LIDC harness on phase 13's tree and phase 11's weights
    reset_counts()
    out["lidc"] = eval_lidc_uncertainty(
        lidc_eval_params(evaluation_path=str(DP_DIR / "lidc2")), num_steps=DP_EVAL_STEPS)
    out["lidc_launches"], out["lidc_paths"] = read_counts()
    torch.save(out, DP_DIR / f"rank{rank}.pt")
    dist.destroy_process_group()


def trees_equal(a, b) -> bool:
    """Two checkpoint trees hold the same keys and the same bits."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            trees_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def spawn_ranks(n: int, argv):
    """Start `n` copies of `argv` (the rank as the last argument), each
    with its output in `build/chip_smoke_dp/rank<r>.log`; wait for all and
    raise, with their logs, if any exits non-zero."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank in range(n):
            log = open(DP_DIR / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen([*argv, str(rank)], stdout=log,
                                           stderr=subprocess.STDOUT,
                                           env=dict(os.environ, DP_PORT=str(port))),
                          log))
        # a rank that fails leaves the others waiting in a collective: stop
        # at the first failure
        deadline = time.monotonic() + 600
        while any(proc.poll() is None for proc, _ in procs) and time.monotonic() < deadline \
                and not any(proc.poll() for proc, _ in procs):
            time.sleep(0.5)
        rcs = [proc.poll() for proc, _ in procs]
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if rcs != [0] * n:
        logs = "\n".join(f"--- rank {r} (exit {rc}):\n"
                         + (DP_DIR / f"rank{r}.log").read_text()[-4000:]
                         for r, rc in enumerate(rcs))
        raise AssertionError(f"data_parallel: a rank failed: {rcs}\n{logs}")


def phase_data_parallel(smi, masters, one_rank_warm_ms: float):
    """Phase 24: two ranks in a gloo group on cuda:0 against one process
    (see the docstring); then the CLI under torchrun through nccl."""
    import os
    import shutil

    import torch

    from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty
    from ccdm_tpu_torch.train.trainer import TrainingRun

    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    torch.save(masters, DP_DIR / "masters.pt")
    # the one-process references first, so the ranks later have the card
    ref_loss, ref_grads, ref_masters = dp_step(masters)
    # each rank's rows as one process computes them, from the global draws;
    # rank 0's again (a repeat, the model built anew), and with cuDNN's
    # deterministic algorithms
    draws = dp_draws()
    halves = [dp_step(masters, slice(p, None, DP_RANKS), draws) for p in range(DP_RANKS)]
    repeat = dp_step(masters, slice(0, None, DP_RANKS), draws)[1]
    torch.backends.cudnn.deterministic = True
    pinned = [dp_step(masters, slice(p, None, DP_RANKS), draws)[1] for p in range(DP_RANKS)]
    torch.backends.cudnn.deterministic = False
    ref_lidc = eval_lidc_uncertainty(lidc_eval_params(evaluation_path=str(DP_DIR / "lidc1")),
                                     num_steps=DP_EVAL_STEPS)
    start = time.perf_counter()
    spawn_ranks(DP_RANKS, [sys.executable, str(Path(__file__).resolve()),
                           "--data-parallel-rank"])
    ranks_s = time.perf_counter() - start
    r = [torch.load(DP_DIR / f"rank{i}.pt", weights_only=False) for i in range(DP_RANKS)]

    # 1. the fp32 step. (a) The ranks hold the same bits, and the reduced
    # gradients are the mean of the ranks' own, bit for bit: the all-reduce
    # adds what one process would. (b) A rank's own gradients against one
    # process's on the same rows under the global batch's draws (the rank
    # drew its rows of them): within 1e-5 of each tensor's largest, as is
    # one process's repeat of its own rows on a model built anew: cuDNN's
    # default algorithms do not give the same bits from one build to the
    # next even in one process alone. With cuDNN held to its deterministic
    # algorithms in both, a rank's own equal one process's bit for bit. (c)
    # Against the one-process step at batch 16 the sums run in another
    # order (8 rows twice, cuDNN's algorithms for batch 8): every gradient
    # within 1e-4 of its tensor's largest, the analytically zero ones within
    # 1e-6 of the tree's largest (grad_agreement, the fp32 rule of phase
    # 12), and each tensor within 1e-5 of its largest or within twice the
    # control's error there: one process's mean of the two halves against
    # its batch-16 step, the same split with no rank in it. (d) The
    # masters after 3 Adam steps as tests/test_torch_parallel.py holds
    # them: every weight within 3 steps x 2 lr (Adam moves a weight by up
    # to lr whatever its gradient's size, so gradients at their rounding
    # floor move by a share of lr that the order of the sums decides), all
    # but 1e-4 of the weights (the zero gradients' left out) within 1e-5 of
    # their tensor's largest
    losses = [ri["step"][0] for ri in r]
    reduced = r[0]["step"][1]
    for name in ref_grads:
        if not all(torch.equal(reduced[name], ri["step"][1][name])
                   and torch.equal(r[0]["step"][2][name], ri["step"][2][name]) for ri in r[1:]):
            raise AssertionError(f"data_parallel: the ranks' {name} differ")
    unequal = [k for k in ref_grads
               if not torch.equal(sum(ri["local"][k] for ri in r) / DP_RANKS, reduced[k])]
    if unequal or losses[0] != losses[1]:
        raise AssertionError(f"data_parallel: the reduced gradients are not the mean of the "
                             f"ranks' own: {unequal[:5]} ({len(unequal)} tensors)")
    own = [grad_errors(h[1], ri["local"]) for h, ri in zip(halves, r)]
    again = grad_errors(halves[0][1], repeat)
    if not all(e[0][0] <= 1e-5 and e[1] <= 1e-6 for e in own + [again]):
        raise AssertionError(f"data_parallel: a rank's own gradients against one process's "
                             f"on its rows: {[(e[0], e[1]) for e in own]}; one process's "
                             f"repeat: {again[:2]}")
    diverged = {i: [k for k in g if not torch.equal(g[k], ri["local_pinned"][k])]
                for i, (g, ri) in enumerate(zip(pinned, r))}
    if any(diverged.values()):
        raise AssertionError(f"data_parallel: with cuDNN's deterministic algorithms, a rank's "
                             f"own gradients differ from one process's: "
                             + "; ".join(f"rank {i}: {len(v)} tensors, {v[:3]}, worst err/max "
                                         f"{grad_errors(pinned[i], r[i]['local_pinned'])[0]}"
                                         for i, v in diverged.items() if v))

    def differ(a, b):
        return sum(not torch.equal(a[k], b[k]) for k in a)

    def tensor_errors(ref, grads, zero):
        """err/max of each tensor that is not an analytic zero."""
        return {k: grad_errors({k: v}, {k: grads[k]}, zero=set())[0][0]
                for k, v in ref.items() if k not in zero}

    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    worst, worst_zero, zero = grad_agreement(ref_grads, reduced, "data_parallel")
    mean = {k: sum(h[1][k] for h in halves) / DP_RANKS for k in ref_grads}
    errs, control = tensor_errors(ref_grads, reduced, zero), tensor_errors(ref_grads, mean, zero)
    past = sorted((round(e, 8), k, round(control[k], 8)) for k, e in errs.items() if e > 1e-5)
    wide = [p for p in past if p[0] > 2 * p[2]]
    if not rel <= 1e-5 or wide:
        raise AssertionError(f"data_parallel: 2-rank loss {losses[0]} vs one process's "
                             f"{ref_loss} ({rel:.3g}); tensors past 1e-5 of their largest and "
                             f"twice the control's error (err, name, control): {wide}")
    lr = 1e-4  # DEMO_TRAIN_PARAMS' learning rate
    beyond, total, moved = 0, 0, 0.0
    for name, v in ref_masters.items():
        diff = (r[0]["step"][2][name] - v).abs()
        moved = max(moved, float(diff.max()))
        if name in zero:
            continue
        if name.endswith("qkv.bias"):
            diff = diff[(torch.arange(v.numel()) // 32) % 3 != 1]
        beyond += int((diff > 1e-5 * float(v.abs().max())).sum())
        total += diff.numel()
    if not (moved <= 3 * 2 * lr and beyond <= 1e-4 * total):
        raise AssertionError(f"data_parallel: masters after 3 Adam steps: largest move apart "
                             f"{moved:.3g}, {beyond} of {total} weights past 1e-5 of their "
                             f"tensor's largest")
    log("data_parallel", f"fp32 step, DEMO_TRAIN_PARAMS at 128x128, global batch 16 (8 a rank), "
        f"{DP_RANKS} ranks in a gloo group on cuda:0: bit-equal to each other, the reduced "
        f"gradients bit-equal to the mean of the ranks' own; a rank's own against one "
        f"process's on its rows and draws: worst err/max "
        + ", ".join(f"{e[0][0]:.3g} ({e[0][1]})" for e in own)
        + f" ({differ(halves[0][1], r[0]['local'])} of {len(repeat)} tensors differ), "
        f"one process's repeat on a model built anew {again[0][0]:.3g} ({again[0][1]}; "
        f"{differ(halves[0][1], repeat)} differ), deterministic against default algorithms "
        f"in one process {differ(pinned[0], halves[0][1])} differ; with cuDNN's deterministic "
        f"algorithms in both, each rank's own bit-equal to one process's; against the "
        f"one-process step at batch 16: loss "
        f"{losses[0]:.7g} vs {ref_loss:.7g} ({rel:.2g} relative), worst gradient err/max "
        f"{worst[0]:.3g} ({worst[1]}), analytically zero gradients within {worst_zero:.2g} "
        f"of the largest ({len(zero)} tensors and the key rows), tensors past 1e-5 (err, "
        f"name, the control's err: one process's mean of the halves against its batch-16 "
        f"step): {past}; masters after 3 Adam steps: largest difference {moved:.3g}, "
        f"{beyond} of {total} weights past 1e-5 of their tensor's largest")

    # 2. the bf16 TrainingRun: launches a step as phase 11's, one writer
    writes = [ri["train"]["writes"] for ri in r]
    if writes[1] or not writes[0] or sorted(os.listdir(DP_DIR / "run" / "model")) != [
            str(DP_STEPS)]:
        raise AssertionError(f"data_parallel: checkpoint writes by rank {writes}, model/ "
                             f"{sorted(os.listdir(DP_DIR / 'run' / 'model'))}")
    # one process resumes from it (load_from: load_checkpoint) and holds
    # what rank 1 held, bit for bit
    restored = TrainingRun(dict(_dp_train_params(), load_from=str(DP_DIR / "run"),
                                output_path=str(DP_DIR / "restored"))).state.tree()
    if not trees_equal(restored, torch.load(DP_DIR / "state_rank1.pt")):
        raise AssertionError("data_parallel: the checkpoint reloaded in one process differs "
                             "from rank 1's state")
    if r[0]["train"]["losses"] != r[1]["train"]["losses"]:
        raise AssertionError("data_parallel: the ranks logged different losses")
    log("data_parallel", f"bf16 TrainingRun(DEMO_TRAIN_PARAMS), {DP_STEPS} steps at global "
        f"batch 16 over {DP_RANKS} ranks ({r[0]['train']['steps_per_epoch']} steps an epoch on "
        f"each), a save and a validation at step {DP_STEPS}: launches per rank "
        + ", ".join(f"{i}: {ri['train']['launches']} ({ri['train']['calls']} validation UNet "
                    f"calls)" for i, ri in enumerate(r))
        + f", each 66 GroupNorm forward + 66 backward + 11 attention a step as phase 11; "
        f"checkpoint written by rank 0 only ({len(writes[0])} writes), reloaded by one process "
        f"bit-exact against rank 1's state; loss {r[0]['train']['losses'][0]:.4g} -> "
        f"{r[0]['train']['losses'][-1]:.4g} on both ranks")
    ar = r[0]["allreduce"]
    log("data_parallel", f"gloo through the host on one card, not NCCL ({smi}): the step's "
        f"all-reduce of {ar['bytes']} fp32 bytes takes {ar['ms']:.2f} ms (rank 0; rank 1 "
        f"{r[1]['allreduce']['ms']:.2f} ms)")
    log("data_parallel", f"gloo through the host on one card, not NCCL ({smi}): bf16 step wall "
        f"{one_rank_warm_ms:.2f} ms at one rank (phase 11, batch 16) and "
        + "/".join(f"{ri['train']['warm_ms']:.2f}" for ri in r)
        + f" ms at {DP_RANKS} ranks (8 rows each, steps 11-{DP_STEPS}); the ranks' processes "
        f"took {ranks_s:.1f} s in all")

    # 3. the harness over two ranks against one
    for i, ri in enumerate(r):
        res = ri["lidc"]
        bad = [k for k in ref_lidc if k.startswith(("GED_", "HMIoU_", "diversity_"))
               or k in ("mIoU", "nonzero_fraction")
               if not math.isclose(res[k], ref_lidc[k], rel_tol=1e-6, abs_tol=1e-12)]
        bad += [k for k in ("IoU", "Dice")
                if not np.allclose(res[k], ref_lidc[k], rtol=1e-6, atol=0)]
        if bad or res["count"] != ref_lidc["count"]:
            raise AssertionError(f"data_parallel: rank {i}'s harness differs from one "
                                 f"process's in {bad}: {res} vs {ref_lidc}")
        batches = 2  # 4 of the 8 images a rank, at batch 2
        want = {"group_norm": 66 * DP_EVAL_STEPS * batches,
                "flash_attention": 11 * DP_EVAL_STEPS * batches,
                "group_norm_backward": 0, "quant_conv": 0}
        if ri["lidc_launches"] != want:
            raise AssertionError(f"data_parallel: rank {i}'s harness launches "
                                 f"{ri['lidc_launches']} != {want}")
    log("data_parallel", f"LIDC harness, phase 13's 8 PNG images and phase 11's weights, T = "
        f"{DP_EVAL_STEPS}, batch 2 x 16: {DP_RANKS} ranks (4 images each) equal one process "
        f"within 1e-6 relative on every rank: GED 1/4/8/16 "
        + "/".join(f"{r[0]['lidc'][f'GED_{s}']:.6f}" for s in (1, 4, 8, 16))
        + f", Dice {[round(v, 6) for v in r[0]['lidc']['Dice']]}; launches per rank "
        f"{r[0]['lidc_launches']}")

    # 4. the CLI under torchrun, through nccl
    params = DP_DIR / "cli.json"
    params.write_text(json.dumps(dict(_dp_train_params(), output_path=str(DP_DIR / "cli"))))
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", "-m", "ccdm_tpu_torch.cli.train",
                           str(params), "--multihost", "--max-steps", "4"],
                          capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - start
    if proc.returncode != 0 or "trained to step 4" not in proc.stdout or \
            "nccl" not in proc.stdout:
        raise AssertionError(f"data_parallel: the CLI under torchrun exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    if sorted(os.listdir(DP_DIR / "cli" / "model")) != ["4"]:
        raise AssertionError("data_parallel: the CLI run saved no step-4 checkpoint")
    log("data_parallel", f"python -m torch.distributed.run --standalone --nproc_per_node 1 -m "
        f"ccdm_tpu_torch.cli.train cli.json --multihost --max-steps 4: exit 0 in {cli_s:.1f} s, "
        f"{[l for l in proc.stdout.splitlines() if 'nccl' in l][0].strip()}")
    return {f"data_parallel_train_r{i}": {"launches": ri["train"]["launches"],
                                          "path_launches": ri["train"]["path_launches"]}
            for i, ri in enumerate(r)} | {
        f"data_parallel_eval_lidc_r{i}": {"launches": ri["lidc_launches"],
                                          "path_launches": ri["lidc_paths"]}
        for i, ri in enumerate(r)}


SERVE_DIR = Path("build/chip_smoke_serving")
SERVE_SEED = 2 ** 40 + 25  # both seed words non-zero
# what a serving process may import of the port: the kernels' package and
# the loader
SERVE_MODULES = {"ccdm_tpu_torch", "ccdm_tpu_torch.ops", "ccdm_tpu_torch.utils",
                 "ccdm_tpu_torch.utils.serving"}


def serving_child(jobs_file: Path) -> None:
    """Phase 25's serving process: imports `torch` and the loader only, then
    per job loads an artifact, serves it `serves` times (the first call's
    maps and launches are the job's; a second is timed warm) and writes the
    maps.
    cuDNN is held to its deterministic algorithms, as in the parent; the
    TF32 settings are PyTorch's defaults. A job with `no_fp32` serves with
    the loader's `fp32_precision` taken out (the control of case d)."""
    import contextlib

    import torch

    import ccdm_tpu_torch.ops.precision
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn
    from ccdm_tpu_torch.ops import quant
    from ccdm_tpu_torch.utils.serving import load_sampler

    torch.backends.cudnn.deterministic = True
    fp32 = ccdm_tpu_torch.ops.precision.fp32_precision
    results = []
    for job in json.loads(jobs_file.read_text()):
        ccdm_tpu_torch.ops.precision.fp32_precision = (
            contextlib.nullcontext if job.get("no_fp32") else fp32)
        start = time.perf_counter()
        serve = load_sampler(job["artifact"])
        load_s = time.perf_counter() - start
        images = torch.from_numpy(np.load(job["images"])).cuda()
        seed = torch.tensor(job["seed"], dtype=torch.int64, device="cuda")
        walls, counts = [], None
        for _ in range(job.get("serves", 1)):
            torch.cuda.synchronize()
            gn.launches = fa.launches = quant.launches = 0
            for c in (gn.path_launches, fa.path_launches, quant.path_launches):
                c.update(dict.fromkeys(c, 0))
            start = time.perf_counter()
            maps = serve(images, seed)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            if counts is None:
                counts = ({"group_norm": gn.launches, "flash_attention": fa.launches,
                           "group_norm_backward": 0, "quant_conv": quant.launches},
                          {"group_norm": dict(gn.path_launches),
                           "flash_attention": dict(fa.path_launches),
                           "quant_conv": dict(quant.path_launches)})
                np.save(job["out"], maps.cpu().numpy())
        del maps
        wrong = None
        if job.get("wrong_batch"):
            try:
                serve(torch.zeros(images.shape[0] + 1, *images.shape[1:], device="cuda"), seed)
                wrong = "served"
            except ValueError as e:
                wrong = str(e)
        results.append({"load_s": load_s, "serve_s": walls, "launches": counts[0],
                        "path_launches": counts[1], "wrong_batch": wrong})
        del serve
        torch.cuda.empty_cache()
    modules = sorted(m for m in sys.modules if m.startswith(("ccdm", "jax", "flax")))
    print(json.dumps({"modules": modules, "jobs": results}), flush=True)


def host_us_per_call(fn, calls: int = 2000) -> float:
    """Host microseconds a call: `calls` calls enqueued back to back at a
    site small enough that the card keeps up, then one synchronise."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - start
    torch.cuda.synchronize()
    return wall / calls * 1e6


def serving_host_costs():
    """Per kernel, the host µs a call of its eager wrapper and of its
    registered op (`torch.ops.ccdm.*`, the node a served graph calls), at a
    small bf16 site, in turns wrapper, op, op, wrapper."""
    import torch

    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn
    from ccdm_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(25)
    x = torch.randn(2, 32, 8, 8, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.rand(32, generator=gen, device="cuda")
    b = torch.randn(32, generator=gen, device="cuda")
    qkv = torch.randn(2, 96, 64, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, :32], qkv[:, 32:64], qkv[:, 64:]
    w_q, s_w = quant.weight_codes(torch.randn(32, 32, 3, 3, generator=gen, device="cuda"))
    s_x = quant.static_act_scale(torch.tensor(3.0, device="cuda"))
    pairs = {
        "group_norm": (lambda: gn.group_norm(x, w, b, 32, 1e-5, True),
                       lambda: torch.ops.ccdm.group_norm(x, w, b, None, 32, 1e-5, True)),
        "flash_attention": (lambda: fa.flash_attention(q, k, v),
                            lambda: torch.ops.ccdm.flash_attention(q, k, v)),
        "quant_conv": (lambda: quant.quant_conv(x, w_q, s_w, b, s_x, 3, 1, 1),
                       lambda: torch.ops.ccdm.quant_conv(x, w_q, s_w, b, s_x, 3, 1, 1)),
    }
    out = {}
    with torch.inference_mode():
        for name, (wrapper, op) in pairs.items():
            if not torch.equal(wrapper(), op()):
                raise AssertionError(f"{name}: the registered op and the wrapper disagree")
            times = [host_us_per_call(f) for f in (wrapper, op, op, wrapper)]
            out[name] = {"wrapper_us": (times[0] + times[3]) / 2, "op_us": (times[1] + times[2]) / 2}
    return out


def phase_serving(smi, eager_rates):
    """Phase 25: the sampler exported as a serving artifact (`utils/serving.py`)
    on the card, loaded and served in a fresh process that imports only
    `torch` and the loader, against the eager `make_prob_sampler` on the same
    seed, cuDNN deterministic in both processes, TF32 at PyTorch's default:
    (a) the flagship 8 x 16 x 250 bf16, (b) the same model with calibrated
    static int8 scales, (c) `CITYSCAPES_EVAL_PARAMS` 2 x 1 x 250 with DINO
    ViT-S/8 (the evaluator's own sampler; its DINO map must equal the one
    computed under `fp32_precision`), (d) the flagship in fp32, 1 x 2 x 3 at
    128x128, and its control served without the loader's `fp32_precision`."""
    import torch

    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS, FLAGSHIP_PARAMS
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.ops import quant
    from ccdm_tpu_torch.ops.precision import fp32_precision
    from ccdm_tpu_torch.utils.serving import save_sampler

    phase_start = time.perf_counter()
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    host_us = serving_host_costs()
    saved_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
                   torch.backends.cuda.matmul.allow_tf32)
    # PyTorch's defaults (phase 1 turned TF32 off)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    # the repair's check: the Cityscapes-DINO evaluator under PyTorch's
    # default settings (cuDNN's own algorithms too) computes the DINO map
    # that fp32_precision gives
    ev = CityscapesEvaluator(dict(CITYSCAPES_EVAL_PARAMS))
    ev.build((*CS_HW, 3), CS_IMAGES)
    unzero_(ev.model.unet, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    cs_images = torch.randn(CS_IMAGES, *CS_HW, 3, generator=gen, device="cuda")
    with torch.inference_mode():
        with fp32_precision():
            dino_fp32 = ev.feature_fn(ev.feature_net, cs_images)
        dino_tf32 = ev.feature_fn(ev.feature_net, cs_images)  # the control: TF32 on
    seen = []
    hook = ev.feature_net.register_forward_hook(lambda m, i, out: seen.append(out))
    torch.cuda.synchronize()
    start = time.perf_counter()
    ev.predict_batch(cs_images, SERVE_SEED)
    torch.cuda.synchronize()
    ev_rate = CS_IMAGES / (time.perf_counter() - start)
    hook.remove()
    if len(seen) != 1 or not torch.equal(seen[0], dino_fp32):
        raise AssertionError("the Cityscapes evaluator's DINO map under the TF32 default is "
                             "not the one computed under fp32_precision")
    tf32_err = float((dino_tf32 - dino_fp32).abs().max())
    del seen, dino_tf32, dino_fp32

    torch.backends.cudnn.deterministic = True  # for the rest: served against eager, bit for bit
    seed_words = random.seed_words(SERVE_SEED).tolist()
    cases, jobs = {}, []

    def add_case(name, model, net, images, samples, steps, feature_fn=None, feature_net=None,
                 **job):
        """The eager maps, the export, and the serving process's job."""
        torch.cuda.synchronize()
        reset_counts()
        start = time.perf_counter()
        eager = make_prob_sampler(model, samples, steps, feature_fn=feature_fn)(
            net, images, key=SERVE_SEED, feature_net=feature_net)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - start
        launches = read_counts()
        start = time.perf_counter()
        path = save_sampler(str(SERVE_DIR / f"{name}.ccdm"), model, net,
                            tuple(images.shape[1:]), num_samples=samples, num_steps=steps,
                            batch_size=images.shape[0], feature_fn=feature_fn,
                            feature_net=feature_net)
        export_s = time.perf_counter() - start
        np.save(SERVE_DIR / f"{name}_images.npy", images.cpu().numpy())
        cases[name] = {"eager": eager.cpu(), "eager_s": eager_s, "launches": launches,
                       "export_s": export_s, "mb": Path(path).stat().st_size / 1e6,
                       "images": images.shape[0], "samples": samples}
        jobs.append(dict(name=name, artifact=path, images=str(SERVE_DIR / f"{name}_images.npy"),
                         seed=seed_words, out=str(SERVE_DIR / f"{name}_maps.npy"), **job))

    # (a) and (b): the flagship, float then int8 on calibrated static scales
    params = dict(FLAGSHIP_PARAMS, step_T_sample="confidence")
    model = build_model(params, 2, 1, 128, generator=torch.Generator().manual_seed(0))
    unzero_(model.unet, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randn(IMAGES, 128, 128, 1, generator=gen, device="cuda")
    add_case("flagship", model, model.unet, images, SAMPLES, STEPS, serves=2, wrong_batch=True)
    int8 = build_model(dict(params, quantized_inference="static"), 2, 1, 128)
    int8.unet.load_state_dict(model.unet.state_dict())
    int8 = quant.calibrate_static_scales(int8, int8.unet, images[:2])
    add_case("flagship_int8", int8, int8.unet, images, SAMPLES, STEPS)
    del model, int8

    # (c) Cityscapes with DINO, the evaluator's model, encoder and sampler
    add_case("cityscapes", ev.model, ev.model.unet, cs_images, 1, STEPS, ev.feature_fn,
             ev.feature_net, serves=2)
    del ev

    # (d) fp32 at a small size, served under the TF32 default, and its control
    params32 = dict(params, compute_dtype="float32")
    model32 = build_model(params32, 2, 1, 128, generator=torch.Generator().manual_seed(3))
    unzero_(model32.unet, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    add_case("flagship_fp32", model32, model32.unet,
             torch.randn(1, 128, 128, 1, generator=gen, device="cuda"), 2, 3)
    jobs.append(dict(jobs[-1], name="flagship_fp32_no_fp32", no_fp32=True,
                     out=str(SERVE_DIR / "flagship_fp32_no_fp32_maps.npy")))
    del model32
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = saved_flags
    torch.cuda.empty_cache()

    # one fresh process serves every artifact
    jobs_file = SERVE_DIR / "jobs.json"
    jobs_file.write_text(json.dumps(jobs))
    start = time.perf_counter()
    # started from a two-line entry, not as `python3 chip_smoke.py <flag>`: run
    # as this script's `__main__` the same function served several times slower, its
    # host busy for the whole wall (PERF.md §6)
    entry = ("import sys; from pathlib import Path; sys.path.insert(0, '.'); import chip_smoke; "
             "chip_smoke.serving_child(Path(sys.argv[1]))")
    proc = subprocess.run([sys.executable, "-c", entry, str(jobs_file)],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600)
    child_s = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"serving process exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    port = {m for m in child["modules"] if not m.startswith("ccdm_tpu_torch.ops.")}
    if not port <= SERVE_MODULES or any(m.split(".")[0] in ("jax", "flax", "ccdm_tpu")
                                        for m in child["modules"]):
        raise AssertionError(f"the serving process imported {child['modules']}")

    runs, rows = {}, {}
    for job, res in zip(jobs, child["jobs"]):
        name = job["name"]
        case = cases["flagship_fp32" if job.get("no_fp32") else name]
        maps = torch.from_numpy(np.load(job["out"]))
        if job.get("no_fp32"):
            if torch.equal(maps, case["eager"]):
                raise AssertionError("control: served without fp32_precision under the TF32 "
                                     "default, the fp32 maps equal eager's, so case d cannot "
                                     "see TF32")
            rows[name] = {"max_abs_diff": float((maps - case["eager"]).abs().max())}
            continue
        if maps.shape != case["eager"].shape or not torch.equal(maps, case["eager"]):
            diff = (float((maps - case["eager"]).abs().max())
                    if maps.shape == case["eager"].shape else None)
            raise AssertionError(f"serving {name}: served maps {tuple(maps.shape)} not bit-equal "
                                 f"to eager {tuple(case['eager'].shape)} (max diff {diff})")
        want, want_paths = case["launches"]
        if res["launches"] != want or any(res["path_launches"][k] != want_paths[k]
                                          for k in res["path_launches"]):
            raise AssertionError(f"serving {name}: launches {res['launches']} by path "
                                 f"{res['path_launches']} != eager's {want} {want_paths}")
        if job.get("wrong_batch") and "this artifact serves" not in (res["wrong_batch"] or ""):
            raise AssertionError(f"serving {name}: a batch of the wrong size gave "
                                 f"{res['wrong_batch']!r}")
        n = case["images"] * case["samples"]  # Cityscapes: 1 vote, so images
        rows[name] = {"export_s": case["export_s"], "mb": case["mb"], "load_s": res["load_s"],
                      "served_per_s": [n / s for s in res["serve_s"]],
                      "eager_per_s": n / case["eager_s"]}
        runs[f"serving_{name}"] = {"launches": res["launches"],
                                   "path_launches": res["path_launches"]}

    # the expected counts: sites x 250 UNet calls, as phases 5, 7 and 22 count them
    sites = {"flagship": (66, 11, 0), "flagship_int8": (66, 11, 81), "cityscapes": (81, 16, 0)}
    for name, (g, a, q) in sites.items():
        got = runs[f"serving_{name}"]["launches"]
        want = {"group_norm": g * STEPS, "flash_attention": a * STEPS,
                "group_norm_backward": 0, "quant_conv": q * STEPS}
        if got != want:
            raise AssertionError(f"serving {name}: launches {got} != sites x {STEPS} {want}")
    units = {"flagship": "samples/s", "flagship_int8": "samples/s", "cityscapes": "images/s"}
    earlier = {"flagship": f"phase 5 {eager_rates['flagship']:.2f}",
               "flagship_int8": f"phase 22's harness (2 x 16, reuse 2) "
                                f"{eager_rates['int8_harness']:.2f}",
               "cityscapes": f"phase 7 {eager_rates['cityscapes']:.3f}"}
    for name, unit in units.items():
        r = rows[name]
        served = " then ".join(f"{v:.3f}" for v in r["served_per_s"])
        log("serving", f"{name}: export {r['export_s']:.1f} s, artifact {r['mb']:.1f} MB, load "
            f"{r['load_s']:.2f} s, served {served} {unit} (first call, then warm) against eager "
            f"{r['eager_per_s']:.3f} "
            f"(deterministic cuDNN; {earlier[name]}) ({smi}); launches "
            f"{runs[f'serving_{name}']['launches']}, by path "
            f"{runs[f'serving_{name}']['path_launches']}, bit-equal to eager")
    log("serving", f"fp32 1 x 2 x 3 at 128x128 under the TF32 default: served bit-equal to "
        f"eager; without the loader's fp32_precision it differs by "
        f"{rows['flagship_fp32_no_fp32']['max_abs_diff']:.3g}; the Cityscapes evaluator's DINO "
        f"map under PyTorch's defaults equals the fp32 one (the evaluator at "
        f"{ev_rate:.3f} images/s; TF32 on moves the map by {tf32_err:.3g}); a "
        f"batch of {IMAGES + 1} raised; the serving process imported {sorted(port)} and the "
        f"ops modules, no jax")
    log("serving", "host µs a call, eager wrapper / registered op: " + ", ".join(
        f"{k} {v['wrapper_us']:.1f} / {v['op_us']:.1f}" for k, v in host_us.items())
        + f"; serving process {child_s:.1f} s; phase {time.perf_counter() - phase_start:.1f} s")
    return runs, host_us


REMAINING_DIR = Path("build/chip_smoke_remaining")
# phase 26: the A/B's T, cut from the flagship's 250 as phase 24's harness
# is, and its test images, 4 of DEMO_EVAL_PARAMS' 16 (2 batches of 2 x 16)
AB_STEPS, AB_IMAGES = 50, 4
NPZ_STEPS = 10  # phase 26: the trainer's steps on the LIDC .npy directory
# phase 26, DINO card against CPU in fp32 (TF32 off): a descriptor map's
# largest |difference| over its largest magnitude; the saliency map (min-max
# normalised to [0, 1]) in absolute terms
DINO_REL_TOL, SALIENCY_TOL = 1e-4, 1e-3


def _host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of `fn()` (after one call)."""
    fn()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def _device_ms(fn, reps: int = 3) -> float:
    """Median milliseconds of `fn()` on the card, synchronised (after one
    call)."""
    import torch

    def synced():
        fn()
        torch.cuda.synchronize()

    return _host_ms(synced, reps)


def remaining_native():
    """Phase 26 (a): the native confusion counts against NumPy."""
    from ccdm_tpu_torch import native

    rng = np.random.default_rng(26)
    pairs = [tuple(rng.integers(0, 34, CS_LABEL_HW, dtype=np.uint8) for _ in range(2))
             for _ in range(2)]
    start = time.perf_counter()
    native.add_to_confusion_matrix(*pairs[0], 256)  # builds the library if no phase has
    first_s = time.perf_counter() - start

    def count(fn):
        cm = np.zeros((256, 256), np.int64)
        for gt, pred in pairs:
            fn(gt, pred, 256, cm)
        return cm

    if not np.array_equal(count(native.add_to_confusion_matrix),
                          count(native.add_to_confusion_matrix_numpy)):
        raise AssertionError("remaining: native confusion counts differ from np.bincount's")
    ms = {name: _host_ms(lambda: count(fn)) / len(pairs) for name, fn in (
        ("native", native.add_to_confusion_matrix),
        ("numpy", native.add_to_confusion_matrix_numpy))}
    x, y = (rng.integers(0, 2, (16, 128 * 128), dtype=np.uint8) for _ in range(2))
    got, want = native.pairwise_intersection_union(x, y, 2), \
        native.pairwise_intersection_union_numpy(x, y, 2)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("remaining: native pairwise counts differ from NumPy's")
    pair_ms = {"native": _host_ms(lambda: native.pairwise_intersection_union(x, y, 2)),
               "numpy": _host_ms(lambda: native.pairwise_intersection_union_numpy(x, y, 2))}
    log("remaining", f"native counts: 2 label maps of {CS_LABEL_HW[0]}x{CS_LABEL_HW[1]} (uint8, "
        f"34 ids) equal to np.bincount's; host ms an image {ms['native']:.3f} native against "
        f"{ms['numpy']:.3f} NumPy (the process's first call, which builds the library, "
        f"is phase 16's scoring; here {first_s:.2f} s); "
        f"pairwise_intersection_union of 16 x 16 samples of 128x128 equal to NumPy's, "
        f"{pair_ms['native']:.2f} ms against {pair_ms['numpy']:.2f}")


def remaining_dino(smi):
    """Phase 26 (b): DINO's descriptor extras, ViT-S/8 at 224x224, stride 4,
    on the card against the CPU, then the descriptor CLI on a PNG."""
    import torch

    from ccdm_tpu_torch.models.dino import DinoFeatureEncoder
    from ccdm_tpu_torch.tools import convert_dino_checkpoint, extract_dino_descriptors
    from ccdm_tpu_torch.utils.png import write_png

    enc = DinoFeatureEncoder({"model": "dino_vits8", "output_stride": 4, "source_layer": 11,
                              "facet": "key"})
    card = enc.init(torch.Generator().manual_seed(26))
    cpu = enc.init(torch.Generator().manual_seed(26), device="cpu")
    images = torch.randn(1, 224, 224, 3, generator=torch.Generator().manual_seed(27))
    calls = {
        "keys of blocks 5 and 11, log-binned": lambda vit, x: enc.extract_descriptors(
            vit, x, layers=[5, 11], log_bin=True),
        "saliency": lambda vit, x: [enc.extract_saliency_maps(vit, x)],
    }
    for name, call in calls.items():
        ours = call(card, images.cuda())
        ref = call(cpu, images)
        if name == "saliency":
            err = float((ours[0].cpu() - ref[0]).abs().max())
            ok = err <= SALIENCY_TOL
        else:
            err = max(float((o.cpu() - r).abs().max() / r.abs().max()) for o, r in zip(ours, ref))
            ok = err <= DINO_REL_TOL
        if not ok or not all(bool(torch.isfinite(o).all()) for o in ours):
            raise AssertionError(f"remaining: DINO {name}: card against CPU {err}")
        ms = _device_ms(lambda: call(card, images.cuda()))
        log("remaining", f"DINO ViT-S/8 at 224x224, stride 4, {name}: shapes "
            f"{[tuple(o.shape) for o in ours]}, card against CPU fp32 {err:.3g} "
            f"({'of the largest magnitude' if name != 'saliency' else 'absolute'}; limit "
            f"{DINO_REL_TOL if name != 'saliency' else SALIENCY_TOL}); {ms:.2f} ms on the card "
            f"({smi})")

    # the CLI on a PNG, with the card's weights converted to the .npz
    REMAINING_DIR.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:240, 0:320]
    rgb = np.stack([(yy * 255 // 239), (xx * 255 // 319), ((yy + xx) * 7) % 256], axis=-1)
    write_png(str(REMAINING_DIR / "image.png"), rgb.astype(np.uint8))
    np.savez(REMAINING_DIR / "vits8.npz", **convert_dino_checkpoint.convert(
        {k: v.cpu().numpy() for k, v in card.state_dict().items()}))
    image = torch.from_numpy(extract_dino_descriptors.load_image(
        str(REMAINING_DIR / "image.png"), 224)).cuda()
    for flag, want_shape, ref in (
            ("--bin", (1, 56, 74, 384 * 17), enc.extract_descriptors(card, image, log_bin=True)),
            ("--saliency", (1, 55 * 73), enc.extract_saliency_maps(card, image))):
        npy = REMAINING_DIR / f"desc{flag[1:]}.npy"
        start = time.perf_counter()
        rc = extract_dino_descriptors.main([
            "--image_path", str(REMAINING_DIR / "image.png"), "--output_path", str(npy),
            "--weights", str(REMAINING_DIR / "vits8.npz"), flag])
        wall = time.perf_counter() - start
        got = np.load(npy)
        ref = ref.cpu().numpy()
        err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
        if rc != 0 or got.shape != want_shape or not np.isfinite(got).all() or \
                err > DINO_REL_TOL:
            raise AssertionError(f"remaining: extract_dino_descriptors {flag}: exit {rc}, "
                                 f"shape {got.shape} (want {want_shape}), err {err}")
        log("remaining", f"tools/extract_dino_descriptors.py {flag} on a 240x320 PNG (LANCZOS "
            f"to 224x299): exit 0 in {wall:.2f} s, {got.shape}, against the in-process call "
            f"{err:.3g} of the largest magnitude")


def remaining_lidc_npz(smi):
    """Phase 26 (c, d): a synthesised LIDC pickle converted to `.npy` files, the
    flagship trainer on it, the harness on its test split, the checkpoint
    exported in the reference schema and loaded back."""
    import os
    import pickle

    import torch

    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.data import lidc as lidc_data
    from ccdm_tpu_torch.data.synthetic import make_synthetic_lidc_group
    from ccdm_tpu_torch.eval.lidc_uncertainty import (
        eval_lidc_uncertainty,
        load_eval_params,
        make_prob_sampler,
    )
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.tools import export_torch_checkpoint, lidc_pickle_to_npz
    from ccdm_tpu_torch.train.trainer import TrainingRun

    group = make_synthetic_lidc_group(n=48, resolution=128, seed=26)
    data = {f"LIDC-{i:03d}": {"image": group["images"][i] + 0.5, "masks": group["labels"][i],
                              "series_uid": f"1.3.6.1.4.1.14519.5.2.1.6279.{i // 4}"}
            for i in range(48)}
    pkl, npy = REMAINING_DIR / "data_lidc.pickle", REMAINING_DIR / "data_lidc"
    pkl.write_bytes(pickle.dumps(data))
    start = time.perf_counter()
    if lidc_pickle_to_npz.main([str(pkl), str(npy)]) != 0:
        raise AssertionError("remaining: lidc_pickle_to_npz failed")
    convert_s = time.perf_counter() - start
    os.environ["CCDM_LIDC_PATH"] = str(npy)
    sizes = {s: len(lidc_data.npy_group(str(npy), s)["uids"]) for s in ("train", "val", "test")}

    run_dir = REMAINING_DIR / "run"
    params = dict(DEMO_TRAIN_PARAMS, dataset_file="datasets.lidc", output_path=str(run_dir),
                  save_freq=NPZ_STEPS, validation_freq=10 ** 6, display_freq=NPZ_STEPS,
                  progress_bar=False)
    run = TrainingRun(params)
    metrics, marks, _, _, calls, launches, paths = run_training(run, NPZ_STEPS, (1, NPZ_STEPS))
    check_train_launches("lidc_npz_train", launches, NPZ_STEPS, calls, 66, 11)
    runs = {"lidc_npz_train": {"launches": launches, "path_launches": paths}}
    warm = (marks[NPZ_STEPS] - marks[1]) / (NPZ_STEPS - 1)
    log("remaining", f"LIDC .npy directory: a synthesised pickle of 48 crops (128x128, 4 "
        f"masks, 12 series) -> tools/lidc_pickle_to_npz.py in {convert_s:.2f} s, splits "
        f"{sizes}; DEMO_TRAIN_PARAMS with datasets.lidc on it ({smi}): {NPZ_STEPS} steps at "
        f"batch 16, loss {float(metrics[0]['loss']):.4g} -> {float(metrics[-1]['loss']):.4g}, "
        f"{warm * 1e3:.1f} ms/step after the first; launches {launches}")

    # the harness on the .npy test split, from the run and from its export,
    # with cuDNN held to its deterministic algorithms
    pt = REMAINING_DIR / "exported.pt"
    start = time.perf_counter()
    if export_torch_checkpoint.main([str(run_dir), str(pt)]) != 0:
        raise AssertionError("remaining: export_torch_checkpoint failed")
    export_s = time.perf_counter() - start
    written = torch.load(pt, weights_only=True)
    if set(written) != {"model", "average_model"} or not all(
            torch.equal(written["average_model"][k], v.cpu()) and v.dtype == torch.float32
            for k, v in run.state.ema_params.items()):
        raise AssertionError("remaining: the exported .pt is not the run's fp32 EMA")
    torch.backends.cudnn.deterministic = True
    try:
        results, maps = [], []
        for name, source in (("lidc_npz_eval", run_dir), ("lidc_npz_eval_pt", pt)):
            eval_params = lidc_eval_params(dataset_file="datasets.lidc", load_from=str(source),
                                           dataset_val_max_size=4,
                                           evaluation_path=str(REMAINING_DIR / name))
            torch.cuda.synchronize()
            reset_counts()
            start = time.perf_counter()
            res = eval_lidc_uncertainty(eval_params, num_steps=AB_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches, paths = read_counts()
            want = {"group_norm": 66 * AB_STEPS * 2, "flash_attention": 11 * AB_STEPS * 2,
                    "group_norm_backward": 0, "quant_conv": 0}
            if launches != want:
                raise AssertionError(f"{name}: launches {launches} != {want}")
            check_lidc_results(name, res, 4)
            runs[name] = {"launches": launches, "path_launches": paths}
            results.append({k: v for k, v in res.items()
                            if not k.endswith(("seconds", "_per_sec"))})
            model = build_model(eval_params, 2, 1, 128, generator=torch.Generator().manual_seed(0))
            net = load_eval_params(eval_params, model.unet)
            images = torch.from_numpy(np.stack([lidc_data.test_dataset(2).get(i)["image"]
                                                for i in range(2)])).cuda()
            maps.append(make_prob_sampler(model, 16, AB_STEPS)(net, images, EVAL_SEED))
            log("remaining", f"{name}: the harness on the .npy test split (4 crops, 2 x 16 x "
                f"{AB_STEPS}), load_from {source}: wall {wall:.2f} s, GED_16 {res['GED_16']:.4f}, "
                f"HM-IoU_16 {res['HMIoU_16']:.4f}, Dice {[round(v, 4) for v in res['Dice']]}; "
                f"launches {launches}")
    finally:
        torch.backends.cudnn.deterministic = False
    if results[0] != results[1] or not torch.equal(maps[0], maps[1]):
        raise AssertionError(f"remaining: load_from the .pt differs from the run directory: "
                             f"{results}")
    log("remaining", f"tools/export_torch_checkpoint.py: {len(written['average_model'])} fp32 "
        f"tensors a state dict in {export_s:.2f} s; load_from the .pt gives the harness's "
        f"results and the sampler's maps bit-equal to load_from the run directory (cuDNN "
        f"deterministic)")
    return runs


def _per_call_paths(params, mode: str):
    """Launches by kernel and path of one whole UNet call and one replay of
    `params`' model at the harness's batch (2 x 16), and for the int8 mode
    of its calibration first; and the model's sites (`unet_sites`)."""
    import torch

    from ccdm_tpu_torch.eval.lidc_uncertainty import load_eval_params
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.ops import quant

    def counted(fn):
        torch.cuda.synchronize()
        reset_counts()
        result = fn()
        torch.cuda.synchronize()
        return result, read_counts()[1]

    model = build_model(params, 2, 1, 128, generator=torch.Generator().manual_seed(0))
    sites = unet_sites(model.unet)
    net = load_eval_params(params, model.unet)
    gen = torch.Generator(device="cuda").manual_seed(26)
    images = torch.randn(2, 128, 128, 1, generator=gen, device="cuda")
    calibration = None
    if mode != "float":
        model, calibration = counted(lambda: quant.calibrate_static_scales(model, net, images))
    cond = images.repeat_interleave(16, dim=0)
    xt = torch.nn.functional.one_hot(torch.randint(0, 2, (32, 128, 128), generator=gen,
                                                   device="cuda"), 2).float()
    t = torch.full((32,), 100, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        full_fn, reuse_fn = model.denoise_fns_cached(net, cond)
        (_, skips), full = counted(lambda: full_fn(xt, t))
        _, replay = counted(lambda: reuse_fn(xt, t, skips))
    return calibration, full, replay, sites


def remaining_ab(smi):
    """Phase 26 (e): `tools/encoder_reuse_ab.py` over phase 11's masters."""
    from ccdm_tpu_torch import DEMO_EVAL_PARAMS
    from ccdm_tpu_torch.tools.encoder_reuse_ab import MODES, ab_rows, format_row

    params = dict(DEMO_EVAL_PARAMS, load_from="build/chip_smoke_train/run",
                  dataset_val_max_size=AB_IMAGES, output_path=str(REMAINING_DIR / "ab"),
                  evaluation_path=str(REMAINING_DIR / "ab"))
    per_call = {mode: _per_call_paths(dict(params, **extra), mode) for mode, extra in MODES}
    for mode, (calibration, one_full, one_replay, (full_sites, replay_sites)) in per_call.items():
        # the measured call and replay launch at each of the model's sites
        # once, and the calibration's min(8, T) float calls none of int8
        calib = 8 if calibration else 0

        def total(counts):
            return {k: sum(counts[k].values()) if counts else 0 for k in full_sites}

        got = (total(one_full), total(one_replay), total(calibration))
        want = (full_sites, replay_sites, {k: n for k, n in expected_launches(
            full_sites, replay_sites, 0, 0, calib).items() if k in full_sites})
        if got != want or full_sites["quant_conv"] != (81 if calib else 0):
            raise AssertionError(f"ab {mode}: one call, one replay and the calibration launch "
                                 f"{got}; the model's sites give {want}")
    rows, runs = [], {}
    batches = AB_IMAGES // 2
    rows_iter = ab_rows(params, (1, 2, 3), num_steps=AB_STEPS)
    while True:
        reset_counts()
        start = time.perf_counter()
        try:
            row, res = next(rows_iter)
        except StopIteration:
            break
        wall = time.perf_counter() - start
        launches, paths = read_counts()
        r = row["R"]
        full = batches * len(range(0, AB_STEPS, r))
        replays = batches * AB_STEPS - full
        calibration, one_full, one_replay, (full_sites, replay_sites) = per_call[row["mode"]]
        want = {k: {p: full * n + replays * one_replay[k][p]
                    + (calibration[k][p] if calibration else 0) for p, n in one_full[k].items()}
                for k in one_full}
        calib = 8 if calibration else 0
        want_total = expected_launches(full_sites, replay_sites, full, replays, calib)
        if paths != want or launches != want_total:
            raise AssertionError(f"ab {row['mode']} R={r}: launches {launches} != {want_total} "
                                 f"by the sites, by path {paths} != {want} ({full} whole UNet "
                                 f"calls, {replays} replays, {calib} calibration calls)")
        check_lidc_results(f"ab {row['mode']} R={r}", res, AB_IMAGES)
        rows.append(dict(row, samples_per_sec=res["samples_per_sec"]))
        runs[f"ab_{row['mode']}_r{r}"] = {"launches": launches, "path_launches": paths}
        log("remaining", f"{format_row(row)} samples/s {res['samples_per_sec']:.2f} wall "
            f"{wall:.2f} s; {full} whole UNet calls + {replays} replays; launches {launches} "
            f"by path {paths}")
    log("remaining", f"encoder-reuse A/B ({smi}): phase 11's masters (30 steps), "
        f"DEMO_EVAL_PARAMS at T = {AB_STEPS} (cut from 250), {AB_IMAGES} of its 16 synthetic "
        f"test images at batch 2 x 16; samples/s by mode and R: " + ", ".join(
            f"{r['mode']} R={r['R']} {r['samples_per_sec']:.2f}" for r in rows))
    return runs


def phase_remaining(smi):
    """Phase 26: the modules the port added last, each on the card."""
    import shutil

    phase_start = time.perf_counter()
    shutil.rmtree(REMAINING_DIR, ignore_errors=True)
    REMAINING_DIR.mkdir(parents=True)
    remaining_native()
    remaining_dino(smi)
    runs = remaining_lidc_npz(smi)
    runs.update(remaining_ab(smi))
    log("remaining", f"phase {time.perf_counter() - phase_start:.1f} s")
    return runs


def _dp_train_params():
    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS

    return dict(DEMO_TRAIN_PARAMS, save_freq=DP_STEPS, validation_freq=DP_STEPS,
                display_freq=10, progress_bar=False)


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if sys.argv[1:2] == ["--data-parallel-rank"]:  # one of phase 24's ranks
        dp_child(int(sys.argv[2]))
        return
    import torch

    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    gn_err, gn_row, gn_cs_row, gn_train_row = phase_group_norm(gen)
    attn_err, attn_row, attn_cs_row, attn_train_row = phase_attention(gen)
    runs = {}
    runs["flagship"], bare_rate = phase_slice(smi)
    phase_reference()
    for reuse in (1, 3):
        runs[f"cityscapes_r{reuse}"] = phase_cityscapes(smi, reuse)
    phase_cityscapes_reference()
    gnb_err, gnb_row, gnb_train_row = phase_group_norm_backward(gen)
    phase_attention_backward(gen)
    runs["train"], trained = phase_train(smi)
    phase_train_reference(trained)
    runs["eval_lidc"], harness_rate = phase_eval_lidc(smi, bare_rate)
    phase_eval_invariance()
    runs["sampling_speed"] = phase_sampling_speed(smi)
    runs["cityscapes_eval"] = phase_cityscapes_eval(smi)
    phase_eval_cli()
    runs["cityscapes_train"] = phase_cityscapes_train(smi)
    runs.update(phase_cityscapes_train_dino(smi))
    phase_cityscapes_train_reference()
    q_err, q_row, q_cs_row, q_per_call, q_host = phase_quant_conv(gen)
    quant_runs, quant_rates = phase_quant_eval(smi, harness_rate)
    runs.update(quant_runs)
    phase_quant_reference()
    runs.update(phase_data_parallel(smi, trained, runs["train"]["warm_ms"]))
    serving_runs, host_us = phase_serving(smi, {
        "flagship": bare_rate, "cityscapes": runs["cityscapes_r1"]["images_per_s"],
        "int8_harness": quant_rates["eval_lidc_fast"]})
    runs.update(serving_runs)
    runs.update(phase_remaining(smi))

    def by_run(kernel):
        return {run: {"launches": r["launches"][kernel],
                      "path_launches": r["path_launches"].get(kernel, {})}
                for run, r in runs.items()}

    kernels = [
        {"name": "group_norm", "route": "cuda", "source": "ccdm_tpu_torch/csrc/group_norm.cu",
         "replaces": "ccdm_tpu/ops/group_norm.py:40",
         "launches": sum(r["launches"]["group_norm"] for r in runs.values()),
         "max_abs_err": gn_err, **gn_row, "cityscapes_case": gn_cs_row,
         "cityscapes_train_case": gn_train_row, "serving_host_us": host_us["group_norm"], "runs": by_run("group_norm")},
        {"name": "flash_attention", "route": "cuda",
         "source": "ccdm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "ccdm_tpu/ops/flash_attention.py:34",
         "launches": sum(r["launches"]["flash_attention"] for r in runs.values()),
         "max_abs_err": attn_err, **attn_row, "cityscapes_case": attn_cs_row,
         "cityscapes_train_case": attn_train_row, "serving_host_us": host_us["flash_attention"], "runs": by_run("flash_attention")},
        {"name": "group_norm_backward", "route": "cuda",
         "source": "ccdm_tpu_torch/csrc/group_norm_backward.cu",
         # K2's backward: the JAX package trains through flax's GroupNorm
         # (ccdm_tpu/models/layers.py:65), whose gradient is XLA code
         "replaces": "ccdm_tpu/ops/group_norm.py:40",
         "launches": sum(r["launches"]["group_norm_backward"] for r in runs.values()),
         "max_abs_err": gnb_err, **gnb_row, "cityscapes_train_case": gnb_train_row,
         "paths": {path: sum(r["path_launches"].get("group_norm_backward", {}).get(path, 0)
                             for r in runs.values()) for path in ("S", "M", "L")},
         "runs": by_run("group_norm_backward")},
        {"name": "quant_conv", "route": "cuda", "source": "ccdm_tpu_torch/csrc/quant_conv.cu",
         # K3, no TPU kernel: the JAX package's int8 conv is XLA code
         "replaces": "ccdm_tpu/ops/quant.py:115",
         "launches": sum(r["launches"]["quant_conv"] for r in runs.values()),
         "max_abs_err": q_err, **q_row, "cityscapes_case": q_cs_row,
         "per_unet_call": q_per_call, "host_per_unet_call": q_host,
         "serving_host_us": host_us["quant_conv"], "runs": by_run("quant_conv")},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
