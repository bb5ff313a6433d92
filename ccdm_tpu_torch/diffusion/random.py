"""Per-element noise streams: the port's counterpart of the JAX package's
`jax.random.fold_in` discipline (`ccdm_tpu/eval/lidc_uncertainty.py:97-102`,
`ccdm_tpu/diffusion/sampling.py:165-169,250-254,306-312`).

A counter-based generator, Threefry-2x32 with 20 rounds (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011; JAX's own
generator), written as integer tensor ops: each 32-bit word lives in an
int64 tensor and is masked back to 32 bits after every add and shift, so
the arithmetic is exact and the same bits come out on the CPU and on the
card.

Every draw is a pure function of (seed, stream, element id, step, position):

- `element_keys(seed, ids, stream)` hashes the run's seed, the stream
  (`PRIOR` or `CHAIN`) and each element's global id (`index * S + sample`
  in the samplers) into one 64-bit key per element;
- `bits(keys, step, n)` gives word `i` of an element's step `step` as word
  `i % 2` of `threefry(key, (i // 2, step))`.

An element's draws therefore depend neither on its position in the batch
nor on the batch's size. Uniforms carry 24 random mantissa bits.
"""

from __future__ import annotations

import math

import torch

PRIOR, CHAIN = 0, 1  # the streams: the x_T prior and the reverse chain's draws

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # the key schedule's constant


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key, x0: torch.Tensor, x1):
    """Threefry-2x32-20 of the counter `(x0, x1)` under the key `(k0, k1)`.

    Every argument holds unsigned 32-bit values in int64 tensors (or Python
    ints), broadcast against each other; returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def seed_words(seed: int) -> torch.Tensor:
    """The seed's low and high 32-bit words, an int64 tensor `[2]`: the form
    a served sampler takes its seed in (`utils/serving.py`)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")
    return torch.tensor([seed & _MASK, seed >> 32], dtype=torch.int64)


def element_keys(seed, ids: torch.Tensor, stream: int) -> torch.Tensor:
    """One key per element, `[N, 2]` int64: the seed's two words as the key,
    `(id, stream)` as the counter. `seed` is an int in [0, 2^64) or its
    `seed_words`, an int64 tensor `[2]` on the ids' device."""
    if isinstance(seed, torch.Tensor):
        if seed.shape != (2,) or seed.dtype != torch.int64:
            raise ValueError(f"seed words must be int64 [2], got {seed.dtype} "
                             f"{tuple(seed.shape)}")
        key = (seed[0], seed[1])
    else:
        key = tuple(seed_words(seed).tolist())
    ids = ids.to(torch.int64).reshape(-1)
    y0, y1 = threefry2x32(key, ids & _MASK, stream)
    return torch.stack([y0, y1], dim=-1)


def bits(keys: torch.Tensor, step, n: int) -> torch.Tensor:
    """`[N, n]` random 32-bit words (in int64) of step `step` (an int, or a
    0-d int64 tensor on the keys' device, as a served program is given it)
    of each element's stream."""
    pairs = torch.arange((n + 1) // 2, dtype=torch.int64, device=keys.device)
    if not isinstance(step, torch.Tensor):
        step = int(step)
    y0, y1 = threefry2x32((keys[:, :1], keys[:, 1:]), pairs, step)
    return torch.stack([y0, y1], dim=-1).reshape(keys.shape[0], -1)[:, :n]


def uniform(keys: torch.Tensor, step: int, shape) -> torch.Tensor:
    """Uniforms on `[0, 1)` with 24 random bits, float32 `[N, *shape]`."""
    words = bits(keys, step, math.prod(shape))
    u = (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(keys.shape[0], *shape)


def gumbel(keys: torch.Tensor, step: int, shape) -> torch.Tensor:
    """Standard Gumbel noise `[N, *shape]`, formed as
    `categorical.gumbel_noise` forms it: `-log(-log(u))` with `u` clamped
    to `[tiny, 1)`."""
    u = uniform(keys, step, shape).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def randint(keys: torch.Tensor, step: int, shape, high: int) -> torch.Tensor:
    """Integers in `[0, high)`, int64 `[N, *shape]`: `(word * high) >> 32`
    (bias below `high / 2^32`)."""
    words = bits(keys, step, math.prod(shape))
    return ((words * int(high)) >> 32).reshape(keys.shape[0], *shape)
