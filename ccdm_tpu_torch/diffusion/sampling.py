"""Ancestral sampling for categorical diffusion (port of
`ccdm_tpu/diffusion/sampling.py`).

The JAX package runs the reverse process as one `lax.scan`; here it is a
Python loop of K UNet calls. The state layout follows the class count, as
in the JAX sampler:

- **index state** (C >= 8, e.g. Cityscapes' C=20): the loop carries int
  class indices `[B,H,W]`; the one-hot UNet input is rebuilt each step, the
  posterior is the index-specialised `theta_post_prob_from_idx`, and each
  draw is inverse-CDF (one uniform per pixel). The final step runs after
  the loop.
- **one-hot state** (narrow C, e.g. LIDC's C=2): a one-hot float carry and
  Gumbel draws, the final (t==1) step resolved inside the loop.

Either resolves the final step to the argmax ("majority") or the
probabilities ("confidence"). With `encoder_reuse` R > 1 the UNet encoder
runs only on every R-th step and its skip activations are replayed in
between (`DenoisingModel.denoise_fns_cached`).

Noise comes from per-element streams (`diffusion/random.py`): element b's
draw at step k is a pure function of its key and k, as the JAX sampler's
`element_keys`, so a trajectory does not depend on the batch around it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccdm_tpu_torch.diffusion import random
from ccdm_tpu_torch.diffusion.categorical import (
    CategoricalDiffusion,
    max_prob_onehot,
    sample_categorical_icdf,
    sample_onehot,
    theta_post_prob,
    theta_post_prob_from_idx,
)
from ccdm_tpu_torch.utils.precision import fp32_precision

# DenoiseFn: (xt [B,H,W,C] one-hot, t [B] int 1-based) -> p0 probs [B,H,W,C].
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class SamplerConfig(NamedTuple):
    """Sampler options; the same fields as the JAX `SamplerConfig`.

    `step_T_sample`: how the final (t==1) step resolves — "majority" takes
    the argmax one-hot, "confidence" returns the posterior probabilities.
    `encoder_reuse`: R; the full UNet runs on steps with `step % R == 0`,
    the cached encoder activations are replayed on the others (1 = off,
    the reference's semantics). `state`: "auto", "index" or "onehot".
    """

    num_steps: int
    step_T_sample: str = "majority"
    encoder_reuse: int = 1
    state: str = "auto"


# The class count from which "auto" picks the index state
# (`ccdm_tpu/diffusion/sampling.py:_INDEX_STATE_MIN_CLASSES`).
_INDEX_STATE_MIN_CLASSES = 8


def _resolve_state(config: SamplerConfig, num_classes: int) -> str:
    if config.state != "auto":
        return config.state
    return "index" if num_classes >= _INDEX_STATE_MIN_CLASSES else "onehot"


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


class _Denoiser:
    """One UNet call per step: the plain `denoise_fn`, or with encoder reuse
    R > 1 the `(full, reuse)` pair — full on `step % R == 0` (it refreshes
    the cached skips), a replay of the cached skips otherwise."""

    def __init__(self, denoise_fn, config: SamplerConfig, denoise_pair):
        self.fn = denoise_fn
        self.r = int(config.encoder_reuse)
        if self.r > 1 and denoise_pair is None:
            raise ValueError("encoder_reuse > 1 needs denoise_pair "
                             "(DenoisingModel.denoise_fns_cached)")
        self.pair = denoise_pair
        self.skips = None

    def __call__(self, step: int, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.r == 1:
            return self.fn(x, t)
        full_fn, reuse_fn = self.pair
        if step % self.r == 0:
            p0, self.skips = full_fn(x, t)
            return p0
        return reuse_fn(x, t, self.skips)


def ancestral_sampler(
    d: CategoricalDiffusion,
    denoise_fn: DenoiseFn,
    xt: torch.Tensor,
    config: SamplerConfig,
    *,
    element_keys: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    denoise_pair=None,
) -> torch.Tensor:
    """Run the reverse process from `xt ~ q(x_T)` (one-hot `[B,H,W,C]`)
    down to one-hot (majority) or probability (confidence) maps `[B,H,W,C]`.

    Step k's draw uses element b's stream `element_keys[b]` (`[B, 2]`, from
    `random.element_keys`) at step k, or the injected noise the JAX sampler
    drew (the tests feed it): `gumbel[k]` `[K,B,H,W,C]` in the one-hot
    state, `uniforms[k]` `[K,B,H,W]` in the index state. With
    `config.encoder_reuse > 1`, `denoise_pair` is
    `DenoisingModel.denoise_fns_cached`'s `(full, reuse)`. The UNet calls
    run their fp32 convolutions in fp32 (`utils.precision.fp32_precision`).
    """
    with fp32_precision():
        return _ancestral_sampler(d, denoise_fn, xt, config, element_keys=element_keys,
                                  gumbel=gumbel, uniforms=uniforms, denoise_pair=denoise_pair)


def _ancestral_sampler(d: CategoricalDiffusion, denoise_fn: DenoiseFn, xt: torch.Tensor,
                       config: SamplerConfig, *, element_keys, gumbel, uniforms,
                       denoise_pair) -> torch.Tensor:
    t_grid = subsampled_t_values(d.time_steps, config.num_steps)
    k = len(t_grid)
    if gumbel is not None and gumbel.shape != (k, *xt.shape):
        raise ValueError(f"gumbel must be [K,*xt.shape] = {(k, *xt.shape)}, "
                         f"got {tuple(gumbel.shape)}")
    if uniforms is not None and uniforms.shape != (k, *xt.shape[:-1]):
        raise ValueError(f"uniforms must be [K,*xt.shape[:-1]] = {(k, *xt.shape[:-1])}, "
                         f"got {tuple(uniforms.shape)}")
    state = _resolve_state(config, xt.shape[-1])
    if state not in ("index", "onehot"):
        raise ValueError(f"unknown sampler state {config.state!r}")
    denoise = _Denoiser(denoise_fn, config, denoise_pair)
    if element_keys is None and (uniforms if state == "index" else gumbel) is None:
        raise ValueError(f"the {state} state draws its noise from element_keys or from "
                         f"injected {'uniforms' if state == 'index' else 'gumbel'} noise")
    batch = xt.shape[0]

    def t_vec(t_scalar):
        return torch.full((batch,), t_scalar, dtype=torch.int32, device=xt.device)

    def resolve_final(probs):
        if config.step_T_sample == "confidence":
            return probs
        return max_prob_onehot(probs)  # "majority" (also the reference's default)

    if state == "index":
        num_classes = xt.shape[-1]

        def posterior(idx, p0, t):
            return theta_post_prob_from_idx(d, idx, p0.float(), t).clamp_min(1e-12)

        def draw(step, probs):
            u = (uniforms[step] if uniforms is not None
                 else random.uniform(element_keys, step, probs.shape[1:-1]))
            return sample_categorical_icdf(probs, u)

        idx = torch.argmax(xt, dim=-1)
        for step, t_scalar in enumerate(t_grid[:-1].tolist()):
            t = t_vec(t_scalar)
            p0 = denoise(step, F.one_hot(idx, num_classes).float(), t)
            idx = draw(step, posterior(idx, p0, t))
        t_final = int(t_grid[-1])
        t = t_vec(t_final)
        probs = posterior(idx, denoise(k - 1, F.one_hot(idx, num_classes).float(), t), t)
        if t_final > 1:
            # only for K == 1 < T: the single step ends in an ordinary draw
            return F.one_hot(draw(k - 1, probs), num_classes).float()
        return resolve_final(probs)

    x = xt
    for step, t_scalar in enumerate(t_grid.tolist()):
        t = t_vec(t_scalar)
        probs = theta_post_prob(d, x, denoise(step, x, t).float(), t).clamp_min(1e-12)
        if t_scalar > 1:
            g = (gumbel[step] if gumbel is not None
                 else random.gumbel(element_keys, step, probs.shape[1:]))
            x = sample_onehot(probs, gumbel=g)
        else:
            x = resolve_final(probs)
    return x


def sample_prior_per_key(keys: torch.Tensor, height: int, width: int,
                         num_classes: int) -> torch.Tensor:
    """`x_T` from the uniform categorical prior, one-hot `[B,H,W,C]`, element
    b drawn from its stream `keys[b]` (step 0 of the `PRIOR` stream's keys
    in the samplers)."""
    return F.one_hot(random.randint(keys, 0, (height, width), num_classes),
                     num_classes).float()
