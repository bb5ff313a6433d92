"""DINO's ViT (Caron et al., "Emerging properties in self-supervised vision
transformers", ICCV 2021) as the key-facet feature extractor of CCDM's
Cityscapes model, in plain float32 PyTorch.

Patch embedding: a `patch x patch` conv of stride `stride` (VALID); a class
token; the 224-pixel position table resized bicubically to the token grid
with DINO's scale factor `(grid + 0.1) / side`; pre-LN blocks (LayerNorm
eps 1e-6, qkv packed as (3, heads, dh), softmax(q k^T / sqrt(dh)), exact
GELU MLP). The feature is the keys of block `source_layer`, the class token
dropped, channels ordered `dh_index * heads + head`, on the token grid
`[B, gh, gw, D]`. Weights: a state dict under timm's names.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def key_features(weights: Dict[str, torch.Tensor], images: torch.Tensor, *, heads: int,
                 patch: int, stride: int, source_layer: int) -> torch.Tensor:
    """`images` `[B,H,W,3]` -> block `source_layer`'s keys `[B,gh,gw,D]`."""
    w = {k: v.float() for k, v in weights.items()}
    b, h, wd, _ = images.shape
    x = F.conv2d(images.float().permute(0, 3, 1, 2), w["patch_embed.proj.weight"],
                 w["patch_embed.proj.bias"], stride=stride)
    gh, gw = x.shape[2:]
    d = x.shape[1]
    x = torch.cat([w["cls_token"].expand(b, 1, d), x.flatten(2).transpose(1, 2)], dim=1)
    pos = w["pos_embed"]
    side = int(round(math.sqrt(pos.shape[1] - 1)))
    grid = pos[:, 1:].reshape(1, side, side, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + 0.1) / side, (gw + 0.1) / side),
                         mode="bicubic", align_corners=False)
    assert grid.shape[2:] == (gh, gw), grid.shape
    x = x + torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)
    dh = d // heads
    for i in range(source_layer + 1):
        p = f"blocks.{i}."
        y = F.layer_norm(x, (d,), w[p + "norm1.weight"], w[p + "norm1.bias"], eps=1e-6)
        q, k, v = F.linear(y, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"]).reshape(
            b, -1, 3, heads, dh).unbind(2)                                     # [B,T,heads,dh]
        if i == source_layer:
            return k[:, 1:].transpose(2, 3).reshape(b, gh, gw, d)
        a = torch.softmax(torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh), dim=-1)
        x = x + F.linear(torch.einsum("bhts,bshd->bthd", a, v).reshape(b, -1, d),
                         w[p + "attn.proj.weight"], w[p + "attn.proj.bias"])
        y = F.layer_norm(x, (d,), w[p + "norm2.weight"], w[p + "norm2.bias"], eps=1e-6)
        x = x + F.linear(F.gelu(F.linear(y, w[p + "mlp.fc1.weight"], w[p + "mlp.fc1.bias"])),
                         w[p + "mlp.fc2.weight"], w[p + "mlp.fc2.bias"])
    raise ValueError(f"source layer {source_layer} past the blocks")
