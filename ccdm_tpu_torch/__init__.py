"""ccdm_tpu_torch — the PyTorch/CUDA port of `ccdm_tpu` for NVIDIA Hopper.

The package mirrors `ccdm_tpu`'s layout module for module, so each
counterpart sits at the same path (`core/schedules.py`,
`diffusion/categorical.py`, `models/unet.py`, ...). It imports `torch` and
numpy only, never jax, flax or `ccdm_tpu`: the JAX package is the reference
the port is tested against, not a dependency.

Ported so far: the LIDC ancestral sampler and the Cityscapes inference
path, end to end — schedules, the categorical posterior with its Gumbel and
inverse-CDF draws, the UNet (with the DINO feature concat and encoder
reuse) and its builder, the DINO ViT encoder, both sampler states,
`eval.lidc_uncertainty.make_prob_sampler` and
`eval.cityscapes_eval.CityscapesEvaluator`'s build and prediction — and
LIDC training (`train.trainer.run_train`, `python -m
ccdm_tpu_torch.cli.train`) with GED/HM-IoU validation and checkpoints —
and evaluation (`python -m ccdm_tpu_torch.cli.eval`: the LIDC uncertainty
harness, the step sweep, Cityscapes inference with the official scoring),
with per-element noise streams (`diffusion/random.py`), its own PNG codec
(`utils/png.py`) and PIL-exact resampling (`data/resample.py`). Two
hand-written CUDA kernels (`csrc/`) replace the JAX package's two Pallas
kernels: fused GroupNorm(+SiLU), with a hand-written backward for
training, and attention.

Layouts: public sampler functions keep the JAX layout (`[B,H,W,C]` states
and probabilities, `[B,H,W,Ci]` images); the UNet is NCHW inside.
"""

__version__ = "0.1.0"

# The flagship LIDC configuration (128x128, C=2, base 32, channel mult
# (1,1,2,3,4), attention at ds {8,16} with 32-channel heads, T=250, bf16
# torso). A copy of `__graft_entry__.FLAGSHIP_PARAMS`, kept here so the port
# imports nothing from the JAX side; a test holds the two equal.
FLAGSHIP_PARAMS = {
    "beta_schedule": "cosine",
    "beta_schedule_params": {"s": 0.008},
    "time_steps": 250,
    "polyak_alpha": 0.9999,
    "compute_dtype": "bfloat16",
    "optim": {"name": "Adam", "learning_rate": 1e-4, "lr_function": "polynomial",
              "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 2000},
    "max_epochs": 2000,
    "unet_openai": {
        "base_channels": 32,
        "image_size": 128,
        "channel_mult": None,          # -> (1, 1, 2, 3, 4) @128px
        "attention_resolutions": [32, 16, 8],
        "num_heads": 1,
        "num_head_channels": 32,
        "softmax_output": True,
    },
}

# `configs/params_cityscapes_eval.yml` after `ccdm_tpu.config.with_defaults`:
# 256x512 street scenes, C=20 (ignore class 19), base 128, channel mult
# (1,1,2,2,4,4) from image_size = min(H, W) = 256, attention at ds {8,16,32}
# with 32-channel heads, DINO ViT-S/8 key facet of block 11 concatenated
# before input block 10, T=250, bf16 torso, one confidence vote. A copy,
# because the port reads no YAML (the card's machine has no PyYAML) and
# imports nothing from the JAX side; a test holds the two equal.
CITYSCAPES_EVAL_PARAMS = {
    "class_weights": "uniform",
    "beta_schedule": "cosine",
    "beta_schedule_params": {"s": 0.008},
    "time_steps": 250,
    "polyak_alpha": 0.999,
    "backbone": "unet_openai",
    "batch_size": 2,
    "samples": 12,
    "step_T_sample": "majority",   # the evaluator sets its vote strategy
    "feature_cond_encoder": {
        "type": "dino",
        "model": "dino_vits8",
        "channels": 384,
        "conditioning": "concat_pixels_concat_features",
        "output_stride": 8,
        "scale": "single",
        "train": False,
        "source_layer": 11,
        "target_layer": 10,
        "weights": None,
    },
    "compute_dtype": "bfloat16",
    "output_path": "./logs/cs_eval_${NOW}",
    "dataset_file": "datasets.cityscapes",
    "dataset_val_max_size": None,
    "seed": 0,
    "dataset_pipeline_val": ["resize", "torchvision_normalise"],
    "dataset_pipeline_val_settings": {"target_size": [256, 512],
                                      "return_original_labels": True},
    "evaluation": {"resolution": "original", "evaluations": 1,
                   "evaluation_vote_strategy": "confidence"},
    "encoder_reuse": 1,
    "unet_openai": {
        "base_channels": 128,
        "channel_mult": None,          # -> (1, 1, 2, 2, 4, 4) @256px
        "attention_resolutions": [32, 16, 8],
        "num_heads": 1,
        "num_head_channels": 32,
        "softmax_output": True,
        "ce_head": False,
    },
    "quantized_inference": False,
    "load_from": None,
}

# `configs/params_demo.yml` as PyYAML reads it: the flagship LIDC model
# (128x128, C=2, base 32, bf16) trained on the synthetic multi-annotator set
# at batch 16 with Adam and a polynomial LR 1e-4 -> 1e-6, Polyak 0.999. A
# copy for the same reasons as the one above; a test holds it equal to the
# YAML. `steps_per_launch` is accepted and not ported (one step a launch).
DEMO_TRAIN_PARAMS = {
    "output_path": "/tmp/ccdm_demo/run",
    "dataset_file": "ccdm_tpu.data.synthetic",
    "batch_size": 16,
    "samples": 8,
    "max_epochs": 100000,
    "time_steps": 250,
    "beta_schedule": "cosine",
    "beta_schedule_params": {"s": 0.008},
    "polyak_alpha": 0.999,
    "compute_dtype": "bfloat16",
    "optim": {"name": "Adam", "learning_rate": 1e-4, "lr_function": "polynomial",
              "lr_params": {"power": 1.0, "min_lr": 1e-6}, "epochs": 1250},
    "unet_openai": {
        "base_channels": 32,
        "channel_mult": None,          # -> (1, 1, 2, 3, 4) @128px
        "attention_resolutions": [32, 16, 8],
        "num_heads": 1,
        "num_head_channels": 32,
        "softmax_output": True,
    },
    "display_freq": 200,
    "save_freq": 1000,
    "validation_freq": 1000,
    "dataset_val_max_size": 8,
    "validation_max_batches": 2,
    "n_validation_images": 2,
    "n_validation_predictions": 3,
    "steps_per_launch": 2,
    "seed": 0,
}
