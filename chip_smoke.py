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
   and at the Cityscapes sampler's sites (B = 2 images x 1 vote, 256x512,
   base 128: path L at 768 KB-2 MB slabs, the DINO concat's 640 channels).
4. attention: the attention kernel against its plain version at the
   flagship's attention shapes, at T = 70 (element loads), at T = 2048 (many
   K/V tiles), with 64-channel heads, and at the Cityscapes sites (BH 16 x
   T 2048, 32 x 512, 32 x 128).
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
   version at the flagship training step's sites (batch 16) and at path-L
   shapes, with and without SiLU and the add, bf16 and fp32: errors of dx,
   dweight, dbias and dadd; kernel, plain, library (autograd's backward of
   `F.group_norm`, where it computes the same function) and bound times
   (read x and dy, write dx).
10. attention_backward: the attention's autograd Function (the kernel's
   forward, the JAX package's backward math in PyTorch) against autograd
   through the plain `dense_attention`, at the training sites [48,32,256]
   and [64,32,64] in bf16 and fp32 and at [16,32,2048] (the streaming
   branch); backward, plain, library (SDPA's backward) and bound times.
11. train: `TrainingRun(DEMO_TRAIN_PARAMS)` at full width and depth on the
   card (128x128, C=2, base 32, batch 16, bf16, synthetic LIDC), 30 steps
   with a periodic save and a GED/HM-IoU validation at step 20, into
   `build/chip_smoke_train/`. Checks a finite loss and no invalid flag at
   every step, launches of exactly 66 GroupNorm forward + 66 backward + 11
   attention a step plus the validation sampler's sites x UNet calls, GED
   in [0, 2] and HM-IoU in [0, 1], and that a new `TrainingRun` loading the
   checkpoint holds the same params, EMA, Adam state and step, bit for bit.
   Prints the cold first step, the warm s/step and images/s of steps 11-30
   (validation and saves taken out), peak memory and the validation's
   seconds.
12. train_reference: one fp32 train step (flagship widths, 32x32 input,
   batch 2, injected t and x_t) on the card (kernels, TF32 off) against the
   CPU (plain versions): loss within 1e-5 relative, every gradient within
   1e-4 of its tensor's largest magnitude.

The last lines are the card's `nvidia-smi` name and power limit, one JSON
line of per-kernel results, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

IMAGES, SAMPLES, STEPS = 8, 16, 250

# NVIDIA H100 SXM peaks (data sheet, dense): device memory, bf16 tensor
# cores, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


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
        nbytes = 2 * x.numel() * x.element_size() + 2 * 4 * shape[1] + (
            e.numel() * e.element_size() if e is not None else 0)
        ops = x.numel() * (6 + 3 * silu + (e is not None))
        bound, bound_by = bound_ms(nbytes, ops, "float32")
        worst = max(worst, err)
        if (shape, dtype, silu, with_add) in (((128, 64, 128, 128), bf16, True, False),
                                              ((2, 128, 256, 512), bf16, True, True)):
            rows[shape[0]] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "bound_by": bound_by,
                              "library_ms": library_ms}
        library = "none" if library_ms is None else f"{library_ms:.4f} ms{lib_note}"
        log("group_norm", f"{name} path {plan.path} (vec {plan.vec}, param {plan.param}): "
            f"max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library}, bound {bound:.4f} ms ({bound_by}), {bound / ms:.1%} of bound")
        del x, e
    torch.cuda.empty_cache()
    return worst, rows[128], rows[2]


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
        if (bh, t, dh, dtype) in ((384, 256, 32, bf16), (16, 2048, 32, bf16)):
            rows[bh] = {"shape": [bh, dh, t], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}
        log("attention", f"{name} path {path}: max_abs_err {err:.3g}{detail}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by}), {bound / ms:.1%} of bound")
        del qkv, q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    return worst, rows[384], rows[16]


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

    gn.launches = 0
    gn.launches_bwd = 0
    fa.launches = 0
    for counts in (gn.path_launches, fa.path_launches):
        counts.update(dict.fromkeys(counts, 0))


def read_counts():
    """(launches per kernel, launches per kernel and path) since the reset."""
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn

    return ({"group_norm": gn.launches, "flash_attention": fa.launches,
             "group_norm_backward": gn.launches_bwd},
            {"group_norm": dict(gn.path_launches), "flash_attention": dict(fa.path_launches),
             "group_norm_backward": {}})


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
    probs = run(model.unet, images, gen)
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
            "group_norm_backward": 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != sites x steps {want}")
    n = IMAGES * SAMPLES
    log("slice", f"flagship bf16 {IMAGES} images x {SAMPLES} samples x {STEPS} steps: "
        f"wall {wall:.2f} s, {n / wall:.2f} samples/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi}); launches "
        f"{launches} = sites ({gn_sites} GN, {attn_sites} attention) x {STEPS}, by path "
        f"{paths}; sum err {sum_err:.2g}, foreground share "
        f"{float((probs.argmax(-1) == 1).float().mean()):.3f}")
    return {"launches": launches, "path_launches": paths}


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
    mean = ev.predict_batch(images, gen)
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
            "group_norm_backward": 0}
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
    return {"launches": launches, "path_launches": paths}


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
    cases = [  # (shape, dtype, silu, add): the training step's sites at batch 16
        ((16, 32, 128, 128), bf16, True, False),   # level-0 in-norms
        ((16, 32, 128, 128), bf16, True, True),    # level-0 out-norms, the fused add
        ((16, 64, 128, 128), bf16, True, False),   # level-0 decoder concat: 64 KB slabs
        ((16, 64, 128, 128), bf16, False, False),  # the same, F.group_norm's function
        ((16, 32, 128, 128), fp32, True, False),   # the fp32 head
        ((16, 96, 16, 16), bf16, True, True),      # ds 8, path S in the forward
        ((16, 256, 8, 8), bf16, True, False),      # the ds-16 decoder concat
        ((16, 96, 256), bf16, False, False),       # attention pre-norm at ds 8
        ((16, 128, 64), bf16, False, False),       # attention pre-norm at ds 16
        ((2, 128, 256, 512), bf16, True, True),    # path-L shapes: 1 MB slabs
        ((2, 128, 256, 512), fp32, False, False),  # 2 MB slabs
    ]
    worst, row = 0.0, None  # the largest |dx - plain dx| over all cases
    for shape, dtype, silu, with_add in cases:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        b = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        e = torch.randn(shape[:2], generator=gen, device="cuda").to(dtype) if with_add else None
        out = gn.group_norm_backward(dy, x, w, b, 32, silu=silu, add=e)
        ref = gn.torch_group_norm_backward(dy, x, w, b, 32, silu=silu, add=e)
        torch.cuda.synchronize()
        dx_err = float((out[0].float() - ref[0].float()).abs().max())
        errs = {"dx": _err_to_max(out[0], ref[0]), "dw": _err_to_max(out[1], ref[1]),
                "db": _err_to_max(out[2], ref[2])}
        if e is not None:  # a sum over positions: against the scale of its terms
            scale = float(ref[0].float().abs().reshape(*shape[:2], -1).sum(-1).max())
            errs["dadd"] = float((out[3].float() - ref[3].float()).abs().max()) / scale
        low = 1e-4 if dtype == fp32 else 1e-2  # bf16 dx, dadd: one rounding of fp32 sums
        limits = {"dx": low, "dw": 1e-4, "db": 1e-4, "dadd": low}
        name = f"{list(shape)} {str(dtype)[6:]} silu={silu} add={with_add}"
        bad = {k: v for k, v in errs.items() if not v <= limits[k]}
        if bad:
            raise AssertionError(f"group_norm_backward {name}: errors over the largest "
                                 f"magnitude {bad} beyond {limits}")
        del out, ref
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
        n = x.numel()
        nbytes = 3 * n * x.element_size() + 4 * 4 * shape[1] + (
            2 * e.numel() * e.element_size() if e is not None else 0)
        bound, bound_by = bound_ms(nbytes, n * (14 + 8 * silu + (e is not None)), "float32")
        worst = max(worst, dx_err)
        if (shape, dtype, silu, with_add) == ((16, 64, 128, 128), bf16, True, False):
            row = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by, "library_ms": library_ms}
        library = "none" if library_ms is None else f"{library_ms:.4f} ms{lib_note}"
        log("group_norm_backward", f"{name}: max_abs_err dx {dx_err:.3g}; err/max " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()) + f"; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {library}, bound {bound:.4f} ms ({bound_by}), "
            f"{bound / ms:.1%} of bound")
        del x, dy, e
    torch.cuda.empty_cache()
    return worst, row


def phase_attention_backward(gen):
    import torch
    import torch.nn.functional as F

    from ccdm_tpu_torch.ops import flash_attention as fa

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [(48, 256, bf16), (48, 256, fp32), (64, 64, bf16), (64, 64, fp32),
             (16, 2048, bf16), (16, 2048, fp32)]  # (BH, T, dtype), dh 32
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

    metrics, marks, pauses, val = [], {}, [], {}
    step_fn = run.step_fn

    def step(*args, **kwargs):
        m = step_fn(*args, **kwargs)
        metrics.append(m)
        if len(metrics) in (1, 10, TRAIN_STEPS):
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
                val[key] = (result, pauses[-1][1])
            return result
        return wrapped

    val_calls = []
    run.ema_net.register_forward_pre_hook(lambda *_: val_calls.append(1))
    run.step_fn = step
    run.validate = timed(run.validate, "validate")
    run.checkpoints.save_periodic = timed(run.checkpoints.save_periodic, None)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    state = run.run(max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    launches, _ = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    if state.step != TRAIN_STEPS or len(metrics) != TRAIN_STEPS:
        raise AssertionError(f"trained to step {state.step} in {len(metrics)} steps")
    losses = [float(m["loss"]) for m in metrics]
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)) or any(
            bool(m["invalid"]) for m in metrics):
        raise AssertionError(f"a non-finite loss or an invalid step: {losses}")
    calls = len(val_calls)
    want = {"group_norm": gn_sites * (TRAIN_STEPS + calls),
            "group_norm_backward": gn_sites * TRAIN_STEPS,
            "flash_attention": attn_sites * (TRAIN_STEPS + calls)}
    if launches != want:
        raise AssertionError(f"train: launches {launches} != {want} ({TRAIN_STEPS} steps, "
                             f"{calls} validation UNet calls)")
    scores, val_s = val["validate"]
    if not (0 <= scores["GED"] <= 2 and 0 <= scores["HMIoU"] <= 1):
        raise AssertionError(f"validation scores out of range: {scores}")
    # the save and the validation at TRAIN_EVENT fall inside steps 11-30:
    # their time comes off the window
    inside = sum(d for t0, d in pauses if marks[10] <= t0 <= marks[TRAIN_STEPS])
    warm = (marks[TRAIN_STEPS] - marks[10] - inside) / (TRAIN_STEPS - 10)
    cold = marks[1] - start

    restored = TrainingRun(dict(params, load_from=str(out / "run"),
                                output_path=str(out / "restored")))
    for what, a, b in (("params", state.params, restored.state.params),
                       ("EMA", state.ema_params, restored.state.ema_params),
                       ("Adam mu", state.opt_state["mu"], restored.state.opt_state["mu"]),
                       ("Adam nu", state.opt_state["nu"], restored.state.opt_state["nu"])):
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"checkpoint round trip: {what} differ")
    if (restored.state.step, restored.state.opt_state["count"]) != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"checkpoint round trip: step {restored.state.step}, count "
                             f"{restored.state.opt_state['count']}")
    batch = run.batch_size
    log("train", f"DEMO_TRAIN_PARAMS bf16, batch {batch}, {TRAIN_STEPS} steps ({smi}): cold "
        f"first step {cold:.2f} s, warm {warm * 1e3:.2f} ms/step = {batch / warm:.1f} images/s "
        f"(steps 11-{TRAIN_STEPS}, the save and validation taken out), peak {peak:.2f} GiB; "
        f"loss {losses[0]:.4g} -> {losses[-1]:.4g}; validation at step {TRAIN_EVENT}: GED "
        f"{scores['GED']:.4f}, HM-IoU {scores['HMIoU']:.4f}, {calls} UNet calls, "
        f"{val_s:.2f} s; launches {launches}; checkpoint round trip exact (params, EMA, "
        f"Adam, step {TRAIN_STEPS})")
    return {"launches": launches, "path_launches": {}}


def phase_train_reference():
    """One fp32 train step on the card (kernels) against the CPU (plain
    versions): flagship widths, batch 2 of 32x32, the same injected t and
    x_t."""
    import torch

    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.train.step import train_loss

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
    cw = torch.ones(2)
    results = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        loss, _ = train_loss(model, model.unet, {k: v.to(dev) for k, v in batch.items()}, None,
                             cw.to(dev), t=t.to(dev), xt=xt.to(dev))
        loss.backward()
        results.append((float(loss.detach()), {n: p.grad.cpu()
                                               for n, p in model.unet.named_parameters()}))
    (ref_loss, ref), (loss, grads) = results
    rel = abs(loss - ref_loss) / abs(ref_loss)
    if not rel <= 1e-5:
        raise AssertionError(f"train_reference: loss {loss} vs CPU {ref_loss} ({rel:.3g})")
    # Gradients that are 0 in exact arithmetic are rounding noise on both
    # devices, and a relative error means nothing there. They are what the
    # model adds per channel in front of a GroupNorm of one channel a group,
    # which the norm's mean removes (a ResBlock's first conv bias and
    # time-embedding projection, the last ResBlock's output biases in front
    # of the head's norm), and the key rows of an attention's qkv bias (the
    # softmax removes q.b_k). A tensor whose largest CPU gradient is under
    # 1e-5 of the model's largest counts as one; those and the key rows are
    # held to 1e-6 of the model's largest gradient instead.
    top = max(float(g.abs().max()) for g in ref.values())
    zero = {n for n, g in ref.items() if float(g.abs().max()) < 1e-5 * top}
    worst, worst_zero = (0.0, ""), 0.0
    for name, g in ref.items():
        diff = (grads[name] - g).abs()
        if name in zero:
            worst_zero = max(worst_zero, float(diff.max()) / top)
            continue
        if name.endswith("qkv.bias"):
            keys = (torch.arange(g.numel()) // 32) % 3 == 1
            worst_zero = max(worst_zero, float(diff[keys].max()) / top)
            diff, g = diff[~keys], g[~keys]
        e = float(diff.max()) / max(float(g.abs().max()), 1e-30)
        worst = max(worst, (e, name))
    if not (worst[0] <= 1e-4 and worst_zero <= 1e-6):
        raise AssertionError(f"train_reference: gradient err/max {worst}, analytically zero "
                             f"gradients {worst_zero:.3g} of the largest ({sorted(zero)})")
    log("train_reference", f"fp32 train step, flagship widths, batch {b} of {hw}x{hw}, card "
        f"vs CPU: loss {loss:.6g} vs {ref_loss:.6g} ({rel:.2g} relative), worst gradient "
        f"err/max {worst[0]:.3g} ({worst[1]}), analytically zero gradients within "
        f"{worst_zero:.2g} of the largest ({len(zero)} tensors and the key rows)")


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    gn_err, gn_row, gn_cs_row = phase_group_norm(gen)
    attn_err, attn_row, attn_cs_row = phase_attention(gen)
    runs = {"flagship": phase_slice(smi)}
    phase_reference()
    for reuse in (1, 3):
        runs[f"cityscapes_r{reuse}"] = phase_cityscapes(smi, reuse)
    phase_cityscapes_reference()
    gnb_err, gnb_row = phase_group_norm_backward(gen)
    phase_attention_backward(gen)
    runs["train"] = phase_train(smi)
    phase_train_reference()

    def by_run(kernel):
        return {run: {"launches": r["launches"][kernel],
                      "path_launches": r["path_launches"].get(kernel, {})}
                for run, r in runs.items()}

    kernels = [
        {"name": "group_norm", "route": "cuda", "source": "ccdm_tpu_torch/csrc/group_norm.cu",
         "replaces": "ccdm_tpu/ops/group_norm.py:40",
         "launches": sum(r["launches"]["group_norm"] for r in runs.values()),
         "max_abs_err": gn_err, **gn_row, "cityscapes_case": gn_cs_row,
         "runs": by_run("group_norm")},
        {"name": "flash_attention", "route": "cuda",
         "source": "ccdm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "ccdm_tpu/ops/flash_attention.py:34",
         "launches": sum(r["launches"]["flash_attention"] for r in runs.values()),
         "max_abs_err": attn_err, **attn_row, "cityscapes_case": attn_cs_row,
         "runs": by_run("flash_attention")},
        {"name": "group_norm_backward", "route": "cuda",
         "source": "ccdm_tpu_torch/csrc/group_norm_backward.cu",
         # K2's backward: the JAX package trains through flax's GroupNorm
         # (ccdm_tpu/models/layers.py:65), whose gradient is XLA code
         "replaces": "ccdm_tpu/ops/group_norm.py:40",
         "launches": sum(r["launches"]["group_norm_backward"] for r in runs.values()),
         "max_abs_err": gnb_err, **gnb_row, "runs": by_run("group_norm_backward")},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
