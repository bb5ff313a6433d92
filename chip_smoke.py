#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ccdm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing its result:

1. device: requires CUDA (no CPU fallback); prints the card and its power
   limit; turns TF32 off so fp32 comparisons are fp32.
2. build: compiles `ccdm_tpu_torch/csrc/*.cu` with nvcc into
   `build/ccdm_tpu_torch/` and prints the seconds.
3. group_norm: the GroupNorm(+SiLU) kernel against its plain PyTorch version
   at the flagship sampler's shapes (B = 8 images x 16 samples = 128), with
   max-abs errors and median CUDA-event times of both.
4. attention: the attention kernel against its plain version at the
   flagship's attention shapes and at T = 2048 (many K/V tiles).
5. slice: the flagship LIDC model (128x128, C=2, base 32, bf16, seeded
   random weights with the zero-initialised leaves redrawn) samples 8 images
   x 16 samples x 250 steps through `make_prob_sampler`; the output must be
   finite probabilities of shape [8,16,128,128,2], and each kernel's launch
   count must equal its sites per UNet call x 250.
6. reference: on a small input, the fp32 sampler on the card (kernels)
   against the same sampler on the CPU (plain versions), same noise.

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


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    log("build", f"nvcc built {_build.LIB_PATH} in {seconds:.1f} s")


def phase_group_norm(gen):
    import torch

    from ccdm_tpu_torch.ops import group_norm as gn

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (shape, dtype, groups, silu)
        ((128, 32, 128, 128), bf16, 32, True),
        ((128, 64, 128, 128), bf16, 32, True),   # first decoder level
        ((128, 256, 8, 8), bf16, 32, False),
        ((128, 32, 128, 128), fp32, 32, True),   # the fp32 head
        ((128, 96, 13, 13), fp32, 32, True),     # H*W = 169: ragged, scalar loads
    ]
    worst, timed = 0.0, None
    for shape, dtype, groups, silu in cases:
        # unit scale: x ~ N(0,1), gamma ~ 1 + N(0, 0.1^2), beta ~ N(0, 0.1^2)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        b = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        out = gn.group_norm(x, w, b, groups, silu=silu)
        ref = gn.torch_group_norm(x, w, b, groups, silu=silu)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if dtype == fp32 and not err <= 2e-5:
            raise AssertionError(f"group_norm {shape} fp32: max err {err} > 2e-5")
        if dtype == bf16 and bf16_excess(out.float(), ref.float()) > 0:
            raise AssertionError(f"group_norm {shape} bf16: max err {err} beyond "
                                 f"max(3e-2, 1 ulp)")
        ms = time_ms(lambda: gn.group_norm(x, w, b, groups, silu=silu))
        plain_ms = time_ms(lambda: gn.torch_group_norm(x, w, b, groups, silu=silu))
        worst = max(worst, err)
        if shape == (128, 64, 128, 128):
            timed = (ms, plain_ms)
        log("group_norm", f"{list(shape)} {str(dtype)[6:]} silu={silu}: max_abs_err "
            f"{err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return worst, timed


def phase_attention(gen):
    import torch

    from ccdm_tpu_torch.ops import flash_attention as fa

    cases = [  # (BH, T, dh, dtype)
        (384, 256, 32, torch.float32),    # ds=8: 128 x 3 heads, 16x16 tokens
        (384, 256, 32, torch.bfloat16),
        (512, 64, 32, torch.float32),     # ds=16 and the middle: 128 x 4 heads
        (512, 64, 32, torch.bfloat16),
        (64, 2048, 32, torch.float32),    # Cityscapes-size T: 32 K/V tiles
        (64, 2048, 32, torch.bfloat16),
    ]
    worst, timed = 0.0, None
    for bh, t, dh, dtype in cases:
        # the model's layout: q, k, v are views of one packed [BH, 3*dh, T]
        qkv = torch.randn(bh, 3 * dh, t, generator=gen, device="cuda").to(dtype)
        q, k, v = qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]
        out = fa.flash_attention(q, k, v)
        ref = fa.dense_attention(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if dtype == torch.float32:
            if not err <= 2e-5:
                raise AssertionError(f"attention {bh}x{t}x{dh} fp32: max err {err} > 2e-5")
            detail = ""
        else:
            # bf16: no worse than the plain bf16 path against fp32 truth
            truth = fa.dense_attention(q.float(), k.float(), v.float())
            err_kernel = float((out.float() - truth).abs().max())
            err_plain = float((ref.float() - truth).abs().max())
            if not err_kernel <= err_plain + 1e-3:
                raise AssertionError(f"attention {bh}x{t}x{dh} bf16: kernel err {err_kernel}"
                                     f" > plain err {err_plain} + 1e-3")
            detail = f" (vs fp32 truth: kernel {err_kernel:.3g}, plain {err_plain:.3g})"
        ms = time_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: fa.dense_attention(q, k, v))
        worst = max(worst, err)
        if (bh, t, dtype) == (384, 256, torch.bfloat16):
            timed = (ms, plain_ms)
        log("attention", f"BH={bh} T={t} dh={dh} {str(dtype)[6:]}: max_abs_err {err:.3g}"
            f"{detail}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return worst, timed


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
    gn.launches = 0
    fa.launches = 0
    start = time.perf_counter()
    probs = run(model.unet, images, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {"group_norm": gn.launches, "flash_attention": fa.launches}

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
        f"{launches} = sites ({gn_sites} GN, {attn_sites} attention) x {STEPS}; "
        f"sum err {sum_err:.2g}, foreground share {float((probs.argmax(-1) == 1).float().mean()):.3f}")
    return launches


def phase_reference():
    """The fp32 sampler on the card (kernels) against the CPU (plain
    versions), flagship widths, one image x 2 samples x 3 steps, the same
    injected prior and Gumbel noise."""
    import torch

    from ccdm_tpu_torch import FLAGSHIP_PARAMS
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model

    params = dict(FLAGSHIP_PARAMS, step_T_sample="confidence", compute_dtype="float32")
    cpu = build_model(params, 2, 1, 128)
    unzero_(cpu.unet, seed=3)
    card = build_model(params, 2, 1, 128, device="cuda")
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


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    gn_err, (gn_ms, gn_plain_ms) = phase_group_norm(gen)
    attn_err, (attn_ms, attn_plain_ms) = phase_attention(gen)
    launches = phase_slice(smi)
    phase_reference()

    kernels = [
        {"name": "group_norm", "route": "cuda", "source": "ccdm_tpu_torch/csrc/group_norm.cu",
         "replaces": "ccdm_tpu/ops/group_norm.py:40", "launches": launches["group_norm"],
         "max_abs_err": gn_err, "ms": gn_ms, "plain_ms": gn_plain_ms},
        {"name": "flash_attention", "route": "cuda",
         "source": "ccdm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "ccdm_tpu/ops/flash_attention.py:34",
         "launches": launches["flash_attention"], "max_abs_err": attn_err,
         "ms": attn_ms, "plain_ms": attn_plain_ms},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
