"""Noise schedules for categorical diffusion (port of `ccdm_tpu/core/schedules.py`).

Same quirks as the reference: linear betas over `[start, end]`; the cosine
schedule overrides its `s` argument with 0.008 and clips betas at 0.999.
Values are computed in float64 numpy and stored as float32 tensors. The
`alphas_eff` / `cumalphas_prev` fields bake in the t==1 boundary
(`alphas_eff[0] = 0`, `cumalphas_prev[0] = 1`), so the sampler gathers
instead of masking.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class Schedule(NamedTuple):
    """Schedule constants, each a float32 tensor of shape `[T]`.

    Position `i` holds the value for the 1-based timestep `t = i + 1`.
    """

    betas: torch.Tensor
    alphas: torch.Tensor
    cumalphas: torch.Tensor
    # alphas with the t==1 boundary baked in: alphas_eff[0] == 0
    alphas_eff: torch.Tensor
    # cumalpha_{t-1} as the posterior at timestep t uses it: cumalphas_prev[0] == 1
    cumalphas_prev: torch.Tensor

    @property
    def time_steps(self) -> int:
        return self.betas.shape[0]


def _finalize(betas: np.ndarray, cumalphas: np.ndarray, device=None) -> Schedule:
    alphas = 1.0 - betas
    alphas_eff = alphas.copy()
    alphas_eff[0] = 0.0
    cumalphas_prev = np.concatenate([[1.0], cumalphas[:-1]])
    return Schedule(*(torch.tensor(v, dtype=torch.float32, device=device)
                      for v in (betas, alphas, cumalphas, alphas_eff, cumalphas_prev)))


def linear_schedule(time_steps: int, start: float = 1e-2, end: float = 0.2,
                    device=None) -> Schedule:
    """Linear beta schedule."""
    betas = np.linspace(start, end, time_steps, dtype=np.float64)
    return _finalize(betas, np.cumprod(1.0 - betas), device)


def cosine_schedule(time_steps: int, s: float = 8e-3, device=None) -> Schedule:
    """Cosine schedule; `s` is ignored and 0.008 used, as the reference does."""
    del s
    s = 0.008
    t = np.arange(time_steps, dtype=np.float64)
    cumalphas = np.cos(((t / time_steps + s) / (1 + s)) * (math.pi / 2)) ** 2

    def f(u: float) -> float:
        return math.cos((u + s) / (1.0 + s) * math.pi / 2) ** 2

    betas = np.array(
        [min(1.0 - f((i + 1) / time_steps) / f(i / time_steps), 0.999)
         for i in range(time_steps)],
        dtype=np.float64,
    )
    return _finalize(betas, cumalphas, device)


_SCHEDULES = {
    "linear": linear_schedule,
    "cosine": cosine_schedule,
}


def make_schedule(name: str, time_steps: int, params: Optional[dict] = None,
                  device=None) -> Schedule:
    """Build a schedule by name, with optional keyword `params`."""
    try:
        fn = _SCHEDULES[name]
    except KeyError as e:
        raise ValueError(f"unknown beta schedule {name!r}; options: {sorted(_SCHEDULES)}") from e
    return fn(time_steps, **(params or {}), device=device)
