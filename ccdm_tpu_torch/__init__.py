"""ccdm_tpu_torch — the PyTorch/CUDA port of `ccdm_tpu` for NVIDIA Hopper.

The package mirrors `ccdm_tpu`'s layout module for module, so each
counterpart sits at the same path (`core/schedules.py`,
`diffusion/categorical.py`, `models/unet.py`, ...). It imports `torch` and
numpy only, never jax, flax or `ccdm_tpu`: the JAX package is the reference
the port is tested against, not a dependency.

Ported so far: the LIDC ancestral sampler, end to end — schedules, the
categorical posterior and Gumbel draw, the UNet and its builder, the
one-hot-state sampler loop and `eval.lidc_uncertainty.make_prob_sampler`.
Its two hand-written CUDA kernels (`csrc/`) replace the JAX package's two
Pallas kernels: fused GroupNorm(+SiLU) and attention.

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
