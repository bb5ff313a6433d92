"""Seeded weights for a module's state dict, drawn on its device.

One normal draw of every value at once from a `torch.Generator` on the
device, cut into the entries in state-dict order and scaled: matrices and
kernels by 1/sqrt(fan in), norm scales around 1, other vectors (biases,
norm shifts) by 0.1, DINO's class token and position table by 0.02. No
entry starts at zero, so the layers that the reference code initialises
to zero (the blocks' output convs and projections, the output head) also
carry signal. The program and the reference are handed the same dict.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _scale(name: str, shape) -> tuple:
    """`(mean, std)` of the entry `name` of `shape`."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("cls_token", "pos_embed"):
        return 0.0, 0.02
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "weight":
        return 1.0, 0.1
    return 0.0, 0.1


def draw_like(tensors: Dict[str, torch.Tensor], seed: int, device,
              dtype=None) -> Dict[str, torch.Tensor]:
    """`{name: tensor}` for every entry of `tensors` (name -> tensor), each
    in its own dtype (or `dtype`), drawn from `seed`. Entries with the same
    names and shapes get the same values."""
    shapes = [(name, tuple(t.shape), dtype or t.dtype) for name, t in tensors.items()]
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, dt in shapes:
        n = math.prod(shape)
        mean, std = _scale(name, shape)
        out[name] = (flat[at:at + n].view(shape) * std + mean).to(dt)
        at += n
    return out


def draw(module: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """`draw_like` for every parameter of `module`."""
    return draw_like(dict(module.named_parameters()), seed, device)


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `module`'s parameters in place (every one of them)."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"weights for {len(weights)} entries, module has {len(params)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
