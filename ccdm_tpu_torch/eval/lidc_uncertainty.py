"""LIDC uncertainty evaluation (port of `ccdm_tpu/eval/lidc_uncertainty.py`).

Only `make_prob_sampler` is ported: the batched multi-sample generation
that the LIDC harness and the benchmark call. The metrics and the harness
around it are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ccdm_tpu_torch.diffusion.sampling import SamplerConfig, ancestral_sampler, sample_prior
from ccdm_tpu_torch.models.builder import DenoisingModel


def make_prob_sampler(model: DenoisingModel, num_samples: int,
                      num_steps: Optional[int] = None):
    """`(net, images [B,H,W,Ci], generator) -> probs [B,S,H,W,C]`.

    Each image is repeated S times, image-major (as `jnp.repeat`), the prior
    is drawn, and the ancestral sampler runs under `torch.inference_mode()`
    with the model's `step_T_sample` mode for the final step ("confidence"
    yields probability maps). `net` is the module holding the weights (the
    JAX version's `params`).

    For the tests, `prior` `[B·S,H,W,C]` and `gumbel` `[K,B·S,H,W,C]`
    inject the noise that the JAX sampler drew; otherwise both come from
    `generator`.
    """
    cfg = SamplerConfig(num_steps=num_steps or model.time_steps,
                        step_T_sample=model.step_T_sample)
    c = model.diffusion.num_classes

    def run(net, images: torch.Tensor, generator: Optional[torch.Generator] = None, *,
            prior: Optional[torch.Tensor] = None,
            gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = images.shape
        with torch.inference_mode():
            cond = images.repeat_interleave(num_samples, dim=0)
            xt = (sample_prior(b * num_samples, h, w, c, generator, images.device)
                  if prior is None else prior)
            out = ancestral_sampler(model.diffusion, model.denoise_fn(net, cond), xt,
                                    cfg, generator, gumbel=gumbel)
        return out.reshape(b, num_samples, h, w, c)

    return run
