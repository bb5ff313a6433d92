#!/usr/bin/env python3
"""LIDC quality gate of the port: train the flagship config on synthetic data
and fail (exit 1) if its distributional quality falls past pinned
thresholds. A copy of `scripts/demo_gate.py` that trains and evaluates
through `ccdm_tpu_torch`.

    python3 ccdm_tpu_torch/tools/demo_gate.py
    DEMO_STEPS=800 python3 ccdm_tpu_torch/tools/demo_gate.py   # looser gates
    DEMO_SEEDS=0,1,2 python3 ccdm_tpu_torch/tools/demo_gate.py  # a seed-spread table

Protocol, as the original's: `DEMO_STEPS` (default 5000) training steps of
`DEMO_TRAIN_PARAMS` (`configs/params_demo.yml`) in a fresh run directory,
then the 16-sample LIDC uncertainty evaluation of `DEMO_EVAL_PARAMS`
(`configs/params_demo_eval.yml`) on the same checkpoint in three inference
modes: `float`, `int8-static` (`quantized_inference: static`) and
`int8+er2` (static int8 with `encoder_reuse: 2`). Each mode is gated:

    at >= 5000 steps:  GED_16 <= 0.16   HMIoU_16 >= 0.69   Dice[nodule] >= 0.80
    below:             GED_16 <= 0.25   HMIoU_16 >= 0.55   Dice[nodule] >= 0.70

The thresholds are the JAX package's (`scripts/demo_gate.py:42-43`), quality
pins that hold on any chip. Each seed's `demo_gate.json` (the gates, the
failures, and each mode's gated metrics, samples/s and calibration
seconds) goes into its run directory.

Environment beyond the original's: `DEMO_GATE_ROOT` (default
`build/demo_gate` in the checkout; seed s runs in `<root>/s<s>`),
`DEMO_TINY=1` (the CPU test's size: base 8, T 3, fp32, 2 test images) and
`DEMO_CPU=1` to run on the CPU; by default it runs on the CUDA card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# gates for the full 5000-step run; the short (DEMO_STEPS < 5000) run uses
# the step-800 measurements plus a margin (TRAINING_DEMO.md tables)
FULL_GATES = {"GED_16": 0.16, "HMIoU_16": 0.69, "dice_nodule": 0.80}
SHORT_GATES = {"GED_16": 0.25, "HMIoU_16": 0.55, "dice_nodule": 0.70}
MODES = (("float", {}),
         ("int8-static", {"quantized_inference": "static"}),
         ("int8+er2", {"quantized_inference": "static", "encoder_reuse": 2}))
TINY_UNET = {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [4],
             "num_head_channels": 4}


def gate_failures(mode: str, metrics: dict, gates: dict, seed: int) -> list:
    """The gates `metrics` misses, as `mode:key@seed<seed>`, each printed."""
    failures = []
    for key, bound in gates.items():
        value = float(metrics[key])
        ok = value <= bound if key.startswith("GED") else value >= bound
        word = "<=" if key.startswith("GED") else ">="
        print(f"[demo-gate] seed={seed} {mode:<11s} {key} = {value:.4f} (gate {word} {bound}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{mode}:{key}@seed{seed}")
    return failures


def run_one_seed(seed: int, steps: int, gates: dict) -> dict:
    """Train one seed, evaluate the three modes on its checkpoint, gate each.
    Returns `{"failures": [...], <mode>: {metric: value}}`."""
    import torch

    from ccdm_tpu_torch import DEMO_EVAL_PARAMS, DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty
    from ccdm_tpu_torch.train.trainer import run_train

    device = "cpu" if os.environ.get("DEMO_CPU") == "1" else None  # None: the card
    root = Path(os.environ.get("DEMO_GATE_ROOT", REPO / "build" / "demo_gate")) / f"s{seed}"
    run_dir = root / "run"
    train_params = dict(DEMO_TRAIN_PARAMS, seed=seed, output_path=str(run_dir))
    eval_params = dict(DEMO_EVAL_PARAMS, load_from=str(run_dir), output_path=str(root / "eval"),
                       evaluation_path=str(root / "eval"))
    if os.environ.get("DEMO_TINY") == "1":
        tiny = {"unet_openai": TINY_UNET, "time_steps": 3, "compute_dtype": "float32"}
        train_params.update(tiny, batch_size=2, validation_freq=10 ** 6, save_freq=10 ** 6)
        eval_params.update(tiny, dataset_val_max_size=2)

    # a fresh run directory every time: a leftover checkpoint from an earlier
    # (possibly longer) run would be the one the evaluation loads
    if root.exists():
        shutil.rmtree(root)
    start = time.perf_counter()
    state = run_train(train_params, max_steps=steps, device=device)
    train_seconds = time.perf_counter() - start
    if int(state.step) < steps:
        raise RuntimeError(f"training stopped at step {int(state.step)} < {steps}")

    per_mode, failures = {}, []
    for mode, extra in MODES:
        results = eval_lidc_uncertainty(dict(eval_params, **extra), device=device)
        results["dice_nodule"] = results["Dice"][1]
        per_mode[mode] = {**{k: float(results[k]) for k in gates},
                          "samples_per_sec": float(results["samples_per_sec"]),
                          "calibration_seconds": float(results["calibration_seconds"])}
        failures += gate_failures(mode, results, gates, seed)

    out = run_dir / "demo_gate.json"
    out.write_text(json.dumps({
        "seed": seed, "steps": steps, "gates": gates, "failures": failures,
        "train_seconds": train_seconds,
        "device": device or torch.cuda.get_device_name(0), **per_mode}, indent=2))
    print(f"[demo-gate] summary -> {out}", flush=True)
    return {"failures": failures, **per_mode}


def main() -> int:
    sys.path.insert(0, str(REPO))
    steps = int(os.environ.get("DEMO_STEPS", 5000))
    gates = FULL_GATES if steps >= 5000 else SHORT_GATES
    seeds = [int(s) for s in os.environ.get("DEMO_SEEDS", "0").split(",")]

    runs = {seed: run_one_seed(seed, steps, gates) for seed in seeds}

    if len(seeds) > 1:
        print(f"[demo-gate] seed spread over {seeds} (use to justify the pinned thresholds):")
        for mode, _ in MODES:
            for key in gates:
                vals = [runs[s][mode][key] for s in seeds]
                print(f"[demo-gate]   {mode:<11s} {key:<12s} mean={sum(vals) / len(vals):.4f} "
                      f"min={min(vals):.4f} max={max(vals):.4f}")

    failures = [f for r in runs.values() for f in r["failures"]]
    if failures:
        print(f"[demo-gate] QUALITY REGRESSION: {failures}")
        return 1
    print("[demo-gate] all quality gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
