"""Categorical diffusion with uniform transitions, as plain float64 PyTorch.

The model (Hoogeboom et al., "Argmax flows and multinomial diffusion",
NeurIPS 2021; Zbinden et al., "Stochastic segmentation with conditional
categorical diffusion models", ICCV 2023): q(x_t | x_{t-1}) keeps the class
with probability alpha_t = 1 - beta_t and otherwise draws it uniformly;
the cosine schedule of Nichol and Dhariwal sets cumalpha_t. The reverse
step marginalises the exact posterior q(x_{t-1} | x_t, x_0) over the
UNet's prediction p0(x_0), written out here as the C x C sum of its
definition. At t = 1 the posterior is p0 itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import noise


def cosine_schedule(time_steps: int, s: float = 0.008):
    """`(alphas, cumalphas)` float64 arrays of length T; index t-1 is step
    t. cumalpha_t = f(t - 1), f(u) = cos((u / T + s) / (1 + s) * pi / 2)^2,
    beta_t = min(1 - f(t) / f(t - 1), 0.999): the reference code's form,
    which shifts cumalpha by one step against the betas."""
    def f(u):
        return math.cos((u / time_steps + s) / (1 + s) * math.pi / 2) ** 2

    betas = np.array([min(1 - f(i + 1) / f(i), 0.999) for i in range(time_steps)])
    cumalphas = np.array([f(i) for i in range(time_steps)])
    return 1 - betas, cumalphas


class Diffusion:
    def __init__(self, time_steps: int, num_classes: int, device):
        alphas, cumalphas = cosine_schedule(time_steps)
        self.time_steps, self.num_classes = time_steps, num_classes
        self.alphas = torch.tensor(alphas, dtype=torch.float64, device=device)
        self.cumalphas = torch.tensor(cumalphas, dtype=torch.float64, device=device)

    def posterior(self, xt: torch.Tensor, p0: torch.Tensor, t: int) -> torch.Tensor:
        """`sum_j q(x_{t-1} = i | x_t, x_0 = j) p0[j]`, float64 `[B,H,W,C]`,
        for a one-hot `xt` `[B,H,W,C]` and the UNet's `p0`."""
        c = self.num_classes
        if t == 1:
            return p0.double()
        a = self.alphas[t - 1]
        cab = self.cumalphas[t - 2]
        like = a * xt.double() + (1 - a) / c                       # q(x_t | x_{t-1} = i)
        prior = cab * torch.eye(c, dtype=torch.float64, device=xt.device) + (1 - cab) / c
        joint = like[..., :, None] * prior                         # [B,H,W,i,j]
        post = joint / joint.sum(dim=-2, keepdim=True)             # q(x_{t-1}=i | x_t, x_0=j)
        return torch.einsum("bhwij,bhwj->bhwi", post, p0.double())


def prior_draw(seed: int, ids: torch.Tensor, height: int, width: int, c: int) -> torch.Tensor:
    """x_T, one-hot float `[N,H,W,C]`: a uniform class per pixel."""
    k = noise.keys(seed, ids, noise.PRIOR)
    return F.one_hot(noise.integers(k, 0, (height, width), c), c).double()


def draw(probs: torch.Tensor, chain_keys: torch.Tensor, step: int, index_state: bool):
    """The next one-hot state from `probs` `[N,H,W,C]`: with one uniform a
    pixel, the first class whose cumulative probability passes
    `u * total` (index state, C >= 8); else the Gumbel-max draw with one
    Gumbel variate per class."""
    n, h, w, c = probs.shape
    if index_state:
        u = noise.uniforms(chain_keys, step, (h, w))
        cdf = torch.cumsum(probs, dim=-1)
        idx = (cdf <= u[..., None] * cdf[..., -1:]).sum(dim=-1).clamp_max(c - 1)
    else:
        g = noise.gumbels(chain_keys, step, (h, w, c))
        idx = torch.argmax(torch.log(probs.clamp_min(1e-12)) + g, dim=-1)
    return F.one_hot(idx, c).double()
