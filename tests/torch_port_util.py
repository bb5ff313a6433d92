"""Shared pieces of the port's parity tests (`tests/test_torch_*.py`):
a small UNet config both packages build, and the JAX weights made
non-trivial and handed to the port."""

import jax
import numpy as np
import torch

# base 16, 32x32, two levels, attention at ds 2 with 8-channel heads (4 heads)
TINY_UNET = {"base_channels": 16, "image_size": 32, "channel_mult": [1, 2],
             "attention_resolutions": [2], "num_head_channels": 8}
TINY_PARAMS = {"beta_schedule": "cosine", "beta_schedule_params": {"s": 0.008},
               "time_steps": 250, "compute_dtype": "float32",
               "step_T_sample": "confidence", "unet_openai": TINY_UNET}


def unzero(params, seed: int = 1):
    """Nested numpy dicts of the Flax params, with every all-zero leaf
    (output heads, ResBlock out convs, attention proj, biases) redrawn as
    N(0, 0.05²): left at zero, both UNets emit a uniform softmax whatever
    their torsos compute, and a parity test proves nothing."""
    rng = np.random.default_rng(seed)

    def fix(leaf):
        leaf = np.asarray(leaf, np.float32)
        if not leaf.any():
            leaf = (rng.standard_normal(leaf.shape) * 0.05).astype(np.float32)
        return leaf

    return jax.tree.map(fix, jax.device_get(params))


def load_port_weights(net: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Load Flax params into the port's UNet through the jax-free converter."""
    from ccdm_tpu_torch.models.convert import flax_params_to_state_dict

    net.load_state_dict(flax_params_to_state_dict(flax_params), strict=True)
    return net
