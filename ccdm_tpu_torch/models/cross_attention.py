"""Latent-diffusion-style spatial transformer, self and cross attention
(port of `ccdm_tpu/models/cross_attention.py`).

As in the JAX package it is a module on offer, wired into no UNet: the
reference instantiates none either (its context is always None).

Each block: LayerNorm -> self-attention -> residual, LayerNorm ->
cross-attention (over `context`, or over x itself without one) ->
residual, LayerNorm -> GEGLU feed-forward -> residual. The transformer
wraps its blocks in a GroupNorm and a 1x1 in-projection, and a zero-init
1x1 out-projection plus the input as residual.

- The GroupNorm is the port's `GroupNorm32` (`ops.group_norm`: the
  hand-written kernel on the card, its plain version on the CPU), with fp32
  statistics, as the JAX module's `GroupNorm32`.
- Attention computes its logits with an fp32 accumulation and its softmax in
  fp32, then casts to the module's dtype, as the JAX package's einsums do
  (`preferred_element_type=float32`); it is `torch.matmul`, as the JAX
  package computes it outside any Pallas kernel.
- LayerNorm's epsilon is flax's 1e-6; GEGLU's gate is flax's `nn.gelu`, the
  tanh approximation.

Activations are NCHW at the transformer's boundary, as in the port's UNet
blocks, and `[B, T, D]` tokens inside; `context` is `[B, S, context_dim]`.
`models.convert.flax_spatial_transformer_to_state_dict` loads the JAX
module's parameters with `strict=True`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import GroupNorm32, zero_init


class CrossAttention(nn.Module):
    """Multi-head attention whose keys and values come from `context` (or
    from x without one)."""

    def __init__(self, query_dim: int, num_heads: int = 8, head_dim: int = 64,
                 context_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = nn.Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = nn.Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.Linear(inner, query_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, t, _ = x.shape
        heads, dh = self.num_heads, self.head_dim

        def split(a):  # [B, T, heads*dh] -> [B, heads, T, dh]
            return a.reshape(a.shape[0], a.shape[1], heads, dh).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)   # [B, heads, T, dh]
        return self.to_out(out.transpose(1, 2).reshape(b, t, heads * dh))


class GEGLU(nn.Module):
    def __init__(self, dim: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, mlp_mult: int = 4,
                 context_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn1 = CrossAttention(dim, num_heads, head_dim, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn2 = CrossAttention(dim, num_heads, head_dim, context_dim, dtype=dtype)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.ff_geglu = GEGLU(dim, dim * mlp_mult, dtype=dtype)
        self.ff_out = nn.Linear(dim * mlp_mult, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class SpatialTransformer(nn.Module):
    """A transformer over the flattened spatial tokens of an NCHW map, with
    1x1 conv projections in and out (see the module docstring)."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, depth: int = 1,
                 context_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm32(channels)
        self.proj_in = nn.Conv2d(channels, inner, 1, dtype=dtype)
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(inner, num_heads, head_dim, context_dim=context_dim,
                                  dtype=dtype) for _ in range(depth))
        self.proj_out = zero_init(nn.Conv2d(inner, channels, 1, dtype=dtype))
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        inner = y.shape[1]
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, inner)
        for block in self.blocks:
            y = block(y, context)
        y = y.reshape(b, h, w, inner).permute(0, 3, 1, 2)
        return self.proj_out(y) + x
