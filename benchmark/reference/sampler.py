"""The reverse chain of CCDM's sampler, step by step, on the reference UNet.

For each chain element (an image, one of its samples) the prior x_T and
every draw come from the element's own noise stream (`noise.py`), so a
subset of a sampler call's chains can be followed alone: element
`image_index * samples + sample` of the call.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from benchmark.reference import noise
from benchmark.reference.diffusion import Diffusion, draw, prior_draw


def run_chains(unet: Callable, diff: Diffusion, seed: int, ids: torch.Tensor,
               images: torch.Tensor, features: Optional[torch.Tensor], *,
               vote: str, encoder_reuse: int = 1) -> torch.Tensor:
    """The final maps `[N,H,W,C]` of the chains `ids` (`[N]` element ids),
    each conditioned on its row of `images` `[N,H,W,Ci]` (and `features`):
    T steps from t = T down to 1, the last step's posterior resolved by
    `vote` ("confidence": the probabilities; "majority": their argmax, one
    hot). With `encoder_reuse` R > 1 the encoder runs on steps k with
    k % R == 0 and its activations are reused, with the current time
    embedding, on the steps between."""
    n, h, w, _ = images.shape
    c = diff.num_classes
    x = prior_draw(seed, ids, h, w, c)
    chain = noise.keys(seed, ids, noise.CHAIN)
    skips = None
    for k, t in enumerate(range(diff.time_steps, 0, -1)):
        tt = torch.full((n,), t, dtype=torch.int64, device=images.device)
        if encoder_reuse == 1 or k % encoder_reuse == 0:
            emb, skips = unet.encode(x.float(), images, tt, features)
        else:
            emb = unet.time_embedding(tt)
        probs = diff.posterior(x, unet.decode(emb, skips), t)
        if t > 1:
            x = draw(probs, chain, k, c >= 8)
    if vote == "confidence":
        return probs.clamp_min(1e-12)
    return torch.nn.functional.one_hot(probs.argmax(-1), c).double()
