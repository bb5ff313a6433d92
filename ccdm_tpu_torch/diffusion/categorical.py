"""Categorical (uniform-transition) diffusion math (port of
`ccdm_tpu/diffusion/categorical.py`).

Layout is the JAX package's: states and probabilities are `[B, H, W, C]`,
classes on the last axis. All math is float32. Timesteps `t` are 1-based
int tensors of shape `[B]`.

Random draws take an explicit `torch.Generator`, or injected noise (Gumbel
noise of the probabilities' shape, or one uniform per pixel); the port
keeps no global RNG state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ccdm_tpu_torch.core.schedules import Schedule, make_schedule


class CategoricalDiffusion(NamedTuple):
    """Schedule + class count."""

    schedule: Schedule
    num_classes: int

    @property
    def time_steps(self) -> int:
        return self.schedule.time_steps

    @staticmethod
    def create(schedule: str, time_steps: int, num_classes: int,
               schedule_params=None, device=None) -> "CategoricalDiffusion":
        return CategoricalDiffusion(
            schedule=make_schedule(schedule, time_steps, schedule_params, device),
            num_classes=num_classes,
        )


def _gather_bcast(values: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Schedule values at 1-based timesteps, broadcast to `[B,1,1,1]`."""
    return values[t.long() - 1].view(-1, 1, 1, 1).float()


def q_xt_given_xtm1_probs(d: CategoricalDiffusion, xtm1: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """One-step forward kernel `q(x_t | x_{t-1})` probabilities."""
    betas = _gather_bcast(d.schedule.betas, t)
    return (1.0 - betas) * xtm1 + betas / d.num_classes


def q_xt_given_x0_probs(d: CategoricalDiffusion, x0: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """Closed-form forward marginal `q(x_t | x_0)` probabilities."""
    cumalphas = _gather_bcast(d.schedule.cumalphas, t)
    return cumalphas * x0 + (1.0 - cumalphas) / d.num_classes


def theta_post(d: CategoricalDiffusion, xt: torch.Tensor, x0: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Exact posterior `q(x_{t-1} | x_t, x_0)` for one-hot `x0`, with the
    t==1 boundary baked into the schedule."""
    a = _gather_bcast(d.schedule.alphas_eff, t)
    cab = _gather_bcast(d.schedule.cumalphas_prev, t)
    c = d.num_classes
    theta = (a * xt + (1.0 - a) / c) * (cab * x0 + (1.0 - cab) / c)
    return theta / theta.sum(dim=-1, keepdim=True)


def theta_post_prob(d: CategoricalDiffusion, xt: torch.Tensor,
                    theta_x0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Posterior marginalised over a predicted x0 distribution, in O(C) per
    pixel.

    With `u[c] = a*xt[c] + (1-a)/C` and the transition matrix
    `M = cab*I + (1-cab)/C`, the reference's C×C form collapses to

        denom[k] = cab * u[k] + (1-cab)/C * sum(u)
        r[k]     = p0[k] / denom[k]
        out[c]   = u[c] * (cab * r[c] + (1-cab)/C * sum(r))

    (derivation in the JAX counterpart); `theta_post_prob_naive` is the
    C×C oracle.
    """
    a = _gather_bcast(d.schedule.alphas_eff, t)
    cab = _gather_bcast(d.schedule.cumalphas_prev, t)
    c = d.num_classes
    u = a * xt + (1.0 - a) / c
    s_u = u.sum(dim=-1, keepdim=True)
    denom = cab * u + (1.0 - cab) / c * s_u
    r = theta_x0 / denom
    s_r = r.sum(dim=-1, keepdim=True)
    return u * (cab * r + (1.0 - cab) / c * s_r)


def theta_post_prob_from_idx(d: CategoricalDiffusion, idx: torch.Tensor,
                             theta_x0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`theta_post_prob` for an exactly one-hot `x_t` given as indices
    `[B,H,W]` (the index-state sampler): `u` is analytic and `sum(u) == 1`,
    so that reduction drops out."""
    a = _gather_bcast(d.schedule.alphas_eff, t)
    cab = _gather_bcast(d.schedule.cumalphas_prev, t)
    c = theta_x0.shape[-1]
    hit = torch.arange(c, device=idx.device) == idx[..., None]
    u = (1.0 - a) / c + a * hit.float()
    denom = cab * u + (1.0 - cab) / c
    r = theta_x0.float() / denom
    s_r = r.sum(dim=-1, keepdim=True)
    return u * (cab * r + (1.0 - cab) / c * s_r)


def theta_post_prob_naive(d: CategoricalDiffusion, xt: torch.Tensor,
                          theta_x0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Direct C×C-matrix evaluation of the marginalised posterior (test oracle)."""
    a = _gather_bcast(d.schedule.alphas_eff, t)
    cab = _gather_bcast(d.schedule.cumalphas_prev, t)[..., None]
    c = d.num_classes
    eye = torch.eye(c, dtype=torch.float32, device=xt.device)
    theta_xt_xtm1 = a * xt + (1.0 - a) / c                     # [B,H,W,C1]
    theta_xtm1_x0 = cab * eye + (1.0 - cab) / c                # [B,1,1,C1,C2]
    aux = theta_xt_xtm1[..., :, None] * theta_xtm1_x0          # [B,H,W,C1,C2]
    theta_xtm1_xtx0 = aux / aux.sum(dim=-2, keepdim=True)
    return torch.einsum("bhwcd,bhwd->bhwc", theta_xtm1_xtx0, theta_x0)


def categorical_kl(pred_probs: torch.Tensor, target_probs: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    """Per-pixel `KL(target ‖ pred)` summed over the class axis, as torch's
    `kl_div(log(clamp(pred, eps)), target)`: `xlogy(target, target) -
    target * log(clamp(pred, eps))`, so exact zeros in the target add 0."""
    log_pred = torch.log(pred_probs.clamp_min(eps))
    return (torch.xlogy(target_probs, target_probs) - target_probs * log_pred).sum(dim=-1)


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise, `-log(-log(u))` with `u` uniform on `[tiny, 1)`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_onehot(probs: torch.Tensor, generator: Optional[torch.Generator] = None,
                  *, gumbel: Optional[torch.Tensor] = None,
                  eps: float = 1e-12) -> torch.Tensor:
    """Categorical draw over the last axis as one-hot float32: the Gumbel-max
    `argmax(log(clip(p, eps)) + g)`.

    `g` is drawn from `generator`, or is the injected `gumbel` tensor (the
    tests feed the noise the JAX package drew).
    """
    if gumbel is None:
        gumbel = gumbel_noise(probs.shape, generator, probs.device)
    logits = torch.log(probs.clamp_min(eps))
    idx = torch.argmax(logits + gumbel, dim=-1)
    return F.one_hot(idx, probs.shape[-1]).float()


def sample_categorical_icdf(probs: torch.Tensor,
                            generator: Optional[torch.Generator] = None, *,
                            uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF draw over the last axis -> int64 indices `probs.shape[:-1]`.

    `probs` need not be normalised: the draw is `min(#(cdf <= u * cdf[-1]),
    C - 1)` with one uniform `u` per pixel, from `generator` or the injected
    `uniforms` (the tests feed the JAX package's). The prefix sum is an fp32
    `cumsum`; it sums in another order than the JAX package's triangular
    product, so a target within ~1e-6 of a cdf boundary may land on the
    neighbouring class.
    """
    cdf = torch.cumsum(probs.float(), dim=-1)
    if uniforms is None:
        uniforms = torch.rand(probs.shape[:-1], generator=generator, device=probs.device,
                              dtype=torch.float32)
    target = uniforms[..., None] * cdf[..., -1:]
    idx = (cdf <= target).sum(dim=-1)
    return idx.clamp_max(probs.shape[-1] - 1)


def max_prob_onehot(probs: torch.Tensor) -> torch.Tensor:
    """Argmax one-hot ("majority" vote); ties go to the first class."""
    return F.one_hot(torch.argmax(probs, dim=-1), probs.shape[-1]).float()


def uniform_onehot_noise(shape, num_classes: int,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> torch.Tensor:
    """x_T prior draw: uniform categorical, one-hot. `shape` excludes the
    class axis."""
    idx = torch.randint(0, num_classes, tuple(shape), generator=generator, device=device)
    return F.one_hot(idx, num_classes).float()
