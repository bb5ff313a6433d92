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
    fa.launches = 0
    for counts in (gn.path_launches, fa.path_launches):
        counts.update(dict.fromkeys(counts, 0))


def read_counts():
    """(launches per kernel, launches per kernel and path) since the reset."""
    from ccdm_tpu_torch.ops import flash_attention as fa
    from ccdm_tpu_torch.ops import group_norm as gn

    return ({"group_norm": gn.launches, "flash_attention": fa.launches},
            {"group_norm": dict(gn.path_launches), "flash_attention": dict(fa.path_launches)})


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
    want = {"group_norm": gn_sites * STEPS, "flash_attention": attn_sites * STEPS}
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
            "flash_attention": full * full_attn + (STEPS - full) * replay_attn}
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

    def by_run(kernel):
        return {run: {"launches": r["launches"][kernel], "path_launches": r["path_launches"][kernel]}
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
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
