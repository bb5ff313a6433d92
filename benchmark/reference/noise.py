"""The sampler's noise, worked out from the run's seed alone.

The sampler under test draws every random number from a counter-based
generator, Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011), keyed per chain element:

- an element's key is `threefry(seed words, (element id, stream))`, with
  stream 0 for the prior x_T and 1 for the reverse chain, and the element
  id `image index * samples + sample`;
- word i of an element's step k is word `i % 2` of `threefry(key, (i // 2, k))`;
- a uniform is `(word >> 8) / 2^24`; a Gumbel draw `-log(-log(max(u, tiny)))`;
  an integer in [0, n) is `(word * n) >> 32`.

Written here from that description, with each 32-bit word held in an int64
tensor, so that the reference draws the same numbers on any device.
"""

from __future__ import annotations

import torch

PRIOR, CHAIN = 0, 1
MASK = (1 << 32) - 1
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry(k0, k1, c0, c1):
    """Threefry-2x32-20 of the counter (c0, c1) under the key (k0, k1)."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0, x1 = (c0 + k0) & MASK, (c1 + k1) & MASK
    for block in range(5):
        for r in ROTATIONS[4 * (block % 2):4 * (block % 2) + 4]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def keys(seed: int, ids: torch.Tensor, stream: int) -> torch.Tensor:
    """`[N, 2]` element keys of the element ids `ids` in `stream`."""
    ids = ids.to(torch.int64)
    k0, k1 = threefry(seed & MASK, seed >> 32, ids & MASK, stream)
    return torch.stack([k0, k1], dim=1)


def words(element_keys: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """`[N, n]` 32-bit words of step `step` of each element's stream."""
    pairs = torch.arange((n + 1) // 2, dtype=torch.int64, device=element_keys.device)
    y0, y1 = threefry(element_keys[:, :1], element_keys[:, 1:], pairs, step)
    return torch.stack([y0, y1], dim=2).reshape(len(element_keys), -1)[:, :n]


def uniforms(element_keys, step, shape):
    n = 1
    for s in shape:
        n *= s
    u = (words(element_keys, step, n) >> 8).double() / float(1 << 24)
    return u.reshape(len(element_keys), *shape)


def gumbels(element_keys, step, shape):
    u = uniforms(element_keys, step, shape).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def integers(element_keys, step, shape, high: int):
    n = 1
    for s in shape:
        n *= s
    return ((words(element_keys, step, n) * high) >> 32).reshape(len(element_keys), *shape)
