"""Ancestral sampling for categorical diffusion (port of
`ccdm_tpu/diffusion/sampling.py`).

The JAX package runs the reverse process as one `lax.scan`; here it is a
Python loop of K UNet calls. Only the one-hot-state path is ported: the
state is a one-hot float `[B,H,W,C]` tensor, each step draws from the
posterior with Gumbel noise, and the final (t==1) step resolves to the
argmax ("majority") or the probabilities ("confidence"). That is the path
the JAX sampler picks for narrow class axes such as LIDC's C=2. The
index/inverse-CDF state path and encoder reuse are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ccdm_tpu_torch.diffusion.categorical import (
    CategoricalDiffusion,
    max_prob_onehot,
    sample_onehot,
    theta_post_prob,
    uniform_onehot_noise,
)

# DenoiseFn: (xt [B,H,W,C] one-hot, t [B] int 1-based) -> p0 probs [B,H,W,C].
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class SamplerConfig(NamedTuple):
    """Sampler options; the same fields as the JAX `SamplerConfig`.

    `step_T_sample`: how the final (t==1) step resolves — "majority" takes
    the argmax one-hot, "confidence" returns the posterior probabilities.
    The JAX config's `encoder_reuse` and `state` fields are not ported yet.
    """

    num_steps: int
    step_T_sample: str = "majority"


# The class count from which the JAX sampler's "auto" state picks the
# index path (`ccdm_tpu/diffusion/sampling.py:_INDEX_STATE_MIN_CLASSES`),
# which is not ported yet.
_INDEX_STATE_MIN_CLASSES = 8


def subsampled_t_values(time_steps: int, num_steps: int) -> np.ndarray:
    """The descending timestep grid of a K-of-T step run: the full range when
    K == T, else `round(linspace(T, 1, K))`."""
    if not 0 < num_steps <= time_steps:
        raise ValueError(f"num_steps must be in (0, {time_steps}], got {num_steps}")
    if num_steps == time_steps:
        return np.arange(time_steps, 0, -1, dtype=np.int32)
    return np.array(
        [round(v) for v in np.linspace(time_steps, 1, num_steps)], dtype=np.int32
    )


def ancestral_sampler(
    d: CategoricalDiffusion,
    denoise_fn: DenoiseFn,
    xt: torch.Tensor,
    config: SamplerConfig,
    generator: Optional[torch.Generator] = None,
    *,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the reverse process from `xt ~ q(x_T)` (one-hot `[B,H,W,C]`)
    down to one-hot (majority) or probability (confidence) maps `[B,H,W,C]`.

    Step k's draw uses Gumbel noise from `generator`, or `gumbel[k]` when a
    `[K,B,H,W,C]` tensor is injected (the tests feed the JAX sampler's noise).
    The final t==1 step draws nothing.
    """
    if xt.shape[-1] >= _INDEX_STATE_MIN_CLASSES:
        raise NotImplementedError(
            f"{xt.shape[-1]} classes need the index sampler state, not ported yet")
    t_grid = subsampled_t_values(d.time_steps, config.num_steps)
    if gumbel is not None and gumbel.shape != (len(t_grid), *xt.shape):
        raise ValueError(f"gumbel must be [K,*xt.shape] = {(len(t_grid), *xt.shape)}, "
                         f"got {tuple(gumbel.shape)}")
    batch = xt.shape[0]
    x = xt
    for step, t_scalar in enumerate(t_grid.tolist()):
        t = torch.full((batch,), t_scalar, dtype=torch.int32, device=x.device)
        p0 = denoise_fn(x, t)
        probs = theta_post_prob(d, x, p0.float(), t).clamp_min(1e-12)
        if t_scalar > 1:
            x = sample_onehot(probs, generator,
                              gumbel=None if gumbel is None else gumbel[step])
        elif config.step_T_sample == "confidence":
            x = probs
        else:  # "majority" (also the reference's default)
            x = max_prob_onehot(probs)
    return x


def sample_prior(batch: int, height: int, width: int, num_classes: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Draw `x_T` from the uniform categorical prior, one-hot `[B,H,W,C]`."""
    return uniform_onehot_noise((batch, height, width), num_classes, generator, device)
