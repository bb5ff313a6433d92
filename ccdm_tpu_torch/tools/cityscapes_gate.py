#!/usr/bin/env python3
"""Cityscapes quality gate of the port: train the 20-class path on a
learnable synthetic tree, evaluate it with the official protocol, and fail
(exit 1) below a pinned mIoU. A copy of `scripts/cityscapes_gate.py` that
trains and evaluates through `ccdm_tpu_torch` and writes its PNGs with
`utils/png.py` (no jax, no PIL).

    python3 ccdm_tpu_torch/tools/cityscapes_gate.py
    CS_STEPS=300 CS_GATE_MIOU=0.5 python3 ccdm_tpu_torch/tools/cityscapes_gate.py

What it gates: 20 train classes -> the class-weighted KL (ignore class
zeroed) -> mIoU validation -> `run_inference` (confidence vote of 2,
PNG dumps, official re-scoring). The tree: each image is a Voronoi
partition of 3-6 regions, each region one of 8 evaluated Cityscapes label
ids painted in the class's official colour plus Gaussian noise, so a
working trainer learns it from local colour alone. Only 8 of the 19
evaluated classes appear, so one stray pixel of an absent class adds an
IoU of 0 to the official mean and caps it at 8/9 of the present classes'.

Environment, as the original: `CS_STEPS` (default 6000), `CS_GATE_MIOU`
(0.70, the JAX package's pin from three seeds on a TPU; a first reading for
this port), `CS_SEEDS` (comma-separated, default 0), `CS_GATE_ROOT`
(default `build/cs_gate` in the checkout), `CS_TINY=1` (the CPU test's
size: base 8, T 3, fp32), `CS_REUSE_RUN=1` (evaluate an existing run
again), `CS_ENCODER_REUSE` (R of the evaluation, default 1), and `CS_CPU=1`
to run on the CPU; by default it runs on the CUDA card. Exit 0: passed;
1: below the gate; 2: training was preempted.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]

# 8 evaluated classes spanning 6 categories; colours are the official table's
LEARNABLE_IDS = (7, 8, 11, 21, 23, 24, 26, 33)


def make_learnable_tree(root: str, n_train: int = 24, n_val: int = 8,
                        size=(64, 128), seed: int = 0) -> str:
    """Write a leftImg8bit/gtFine tree whose images are class-coloured
    Voronoi regions plus noise: the label follows from the local colour."""
    from ccdm_tpu_torch.data.cityscapes_labels import LABELS
    from ccdm_tpu_torch.utils.png import write_png

    color_of = {lbl.id: lbl.color for lbl in LABELS}
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, "leftImg8bit", split, "synth")
        gt_dir = os.path.join(root, "gtFine", split, "synth")
        for i in range(n):
            k = int(rng.integers(3, 7))
            cy = rng.uniform(0, h, size=k)
            cx = rng.uniform(0, w, size=k)
            region = np.argmin((yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2, axis=-1)
            ids_of_region = rng.choice(LEARNABLE_IDS, size=k)
            label_ids = ids_of_region[region].astype(np.uint8)
            img = np.zeros((h, w, 3), np.float32)
            for r_i, v in enumerate(ids_of_region):
                img[region == r_i] = color_of[int(v)]
            img += rng.normal(0.0, 12.0, img.shape)
            img = np.clip(img, 0, 255).astype(np.uint8)
            write_png(os.path.join(img_dir, f"synth{i:03d}_leftImg8bit.png"), img)
            write_png(os.path.join(gt_dir, f"synth{i:03d}_gtFine_labelIds.png"), label_ids)
    return root


def main() -> int:
    sys.path.insert(0, str(REPO))
    seeds = [int(s) for s in os.environ.get("CS_SEEDS", "0").split(",")]
    results = [run_one_seed(s) for s in seeds]
    if any(r is None for r in results):
        return 2  # preempted: no quality verdict
    if len(results) > 1:
        for key in ("mIoU_official", "mIoU_trainid_cm"):
            vals = [r[key] for r in results]
            print(f"[cs-gate] {key}: mean {np.mean(vals):.4f} "
                  f"[{min(vals):.4f}, {max(vals):.4f}] over seeds {seeds}")
    gate_miou = results[0]["gate_miou"]
    worst = min(min(r["mIoU_official"], r["mIoU_trainid_cm"]) for r in results)
    if worst < gate_miou:
        print("[cs-gate] QUALITY REGRESSION on the cityscapes eval path")
        return 1
    print("[cs-gate] cityscapes quality gate passed")
    return 0


def run_one_seed(seed: int):
    import time

    import torch

    from ccdm_tpu_torch.eval.cityscapes_eval import run_inference
    from ccdm_tpu_torch.train.trainer import run_train

    steps = int(os.environ.get("CS_STEPS", 6000))
    gate_miou = float(os.environ.get("CS_GATE_MIOU", 0.70))
    device = "cpu" if os.environ.get("CS_CPU") == "1" else None  # None: the card
    root = os.environ.get("CS_GATE_ROOT", str(REPO / "build" / "cs_gate")) + (
        f"_s{seed}" if seed else "")
    run_dir = os.path.join(root, "run")
    data_dir = os.path.join(root, "data")
    # CS_REUSE_RUN=1: keep a trained checkpoint and only evaluate again
    reuse_run = os.environ.get("CS_REUSE_RUN") == "1" and os.path.isdir(run_dir)
    if os.path.isdir(root) and not reuse_run:
        shutil.rmtree(root)  # stale checkpoints would gate old weights
    if not reuse_run:
        make_learnable_tree(data_dir)
    os.environ["CCDM_CITYSCAPES_PATH"] = data_dir

    tiny = os.environ.get("CS_TINY") == "1"
    time_steps = 3 if tiny else 250
    unet = ({"base_channels": 8, "channel_mult": [1, 2],
             "attention_resolutions": [4], "num_head_channels": 4}
            if tiny else
            {"base_channels": 32, "channel_mult": [1, 2, 2, 4],
             "attention_resolutions": [16, 8], "num_heads": 1,
             "num_head_channels": 32, "softmax_output": True})
    pipeline = {
        "dataset_pipeline_train": ["flip", "resize", "torchvision_normalise"],
        "dataset_pipeline_train_settings": {"target_size": [64, 128]},
        "dataset_pipeline_val": ["resize", "torchvision_normalise"],
        "dataset_pipeline_val_settings": {"target_size": [64, 128]},
    }
    train_params = {
        "output_path": run_dir,
        "dataset_file": "datasets.cityscapes",
        "unet_openai": unet,
        **pipeline,
        "dataset_val_max_size": 8,
        "batch_size": 8,
        "max_epochs": 10 ** 6,
        "time_steps": time_steps,
        "beta_schedule": "cosine",
        "beta_schedule_params": {"s": 0.008},
        "polyak_alpha": 0.999,
        "compute_dtype": "float32" if tiny else "bfloat16",
        "optim": {"name": "Adam", "learning_rate": 2e-4, "lr_function": "polynomial",
                  "lr_params": {"power": 1.0, "min_lr": 1e-6},
                  "epochs": max(1, steps // 3)},
        "display_freq": 200,
        "save_freq": 1000,
        "validation_freq": 1000,
        "validation_max_batches": 1,
        "n_validation_images": 1,
        "n_validation_predictions": 1,
        "progress_bar": False,
        "seed": seed,
    }

    train_s = 0.0
    if reuse_run:
        print(f"[cs-gate] CS_REUSE_RUN: evaluating the checkpoint in {run_dir}")
    else:
        start = time.perf_counter()
        state = run_train(train_params, max_steps=steps, device=device)
        train_s = time.perf_counter() - start
        if state.step < steps:
            # a SIGTERM makes the trainer save and return early: gating a
            # partly trained model would report a false regression
            print(f"[cs-gate] ABORT: training preempted at step {state.step} < {steps}; "
                  f"no quality verdict")
            return None

    eval_params = {
        "output_path": os.path.join(root, "eval"),
        "dataset_file": "datasets.cityscapes",
        **{k: v for k, v in pipeline.items() if "val" in k},
        "dataset_val_max_size": 8,
        "batch_size": 4,
        "time_steps": time_steps,
        "beta_schedule": "cosine",
        "beta_schedule_params": {"s": 0.008},
        "polyak_alpha": 0.999,
        "compute_dtype": train_params["compute_dtype"],
        "unet_openai": unet,
        "evaluation": {"resolution": "dataloader", "evaluations": 2,
                       "evaluation_vote_strategy": "confidence"},
        "load_from": run_dir,
        "seed": seed,
        "encoder_reuse": int(os.environ.get("CS_ENCODER_REUSE", 1)),
    }
    start = time.perf_counter()
    res = run_inference(eval_params, device=device)
    eval_s = time.perf_counter() - start
    official = res["official"]["averageScoreClasses"]
    summary = {"steps": steps, "seed": seed, "gate_miou": gate_miou,
               "encoder_reuse": eval_params["encoder_reuse"],
               "mIoU_trainid_cm": float(res["mIoU"]), "mIoU_official": float(official),
               "train_seconds": train_s, "eval_seconds": eval_s,
               "device": device or torch.cuda.get_device_name(0)}
    out = os.path.join(root, "cityscapes_gate.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[cs-gate] seed {seed}: official class mIoU = {official:.4f} "
          f"(train-id CM {res['mIoU']:.4f}), gate >= {gate_miou}; train {train_s:.1f} s, "
          f"eval {eval_s:.1f} s -> {out}")
    return summary


if __name__ == "__main__":
    sys.exit(main())
