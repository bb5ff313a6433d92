"""UNet building blocks (port of `ccdm_tpu/models/layers.py`).

Activations inside the UNet are indexed `[B, C, H, W]` (attention tokens
`[B, C, T]`), laid out NCHW or channels-last as the UNet's forward chose
(`models/unet.py`). The torso runs in the compute dtype (bf16 on
the card); GroupNorm parameters are fp32 and its statistics and normalise
run in fp32 (the JAX package's `norm_fp32`, either value: see
`GroupNorm32`).

Submodule names follow the reference torch UNet (`in_layers.0/2`,
`emb_layers.1`, `out_layers.0/3`, `skip_connection`, `norm`, `qkv`,
`proj_out`, `op`, `conv`), so `models.convert.flax_params_to_state_dict`
loads with `strict=True`. Where the forward fuses GroupNorm and SiLU into
one kernel call, the SiLU module still holds its index, so the keys keep
their positions.

Every GroupNorm goes through `ops.group_norm.group_norm` and every
attention through `ops.flash_attention.flash_attention`: the hand-written
kernels on the card, their plain versions on the CPU. With `quant` (the
`quantized_inference` mode) the ResBlock's convs and the resampling convs
are `ops.quant.QuantConv2d`s, as the JAX package's `quant` flag makes them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.ops.flash_attention import flash_attention
from ccdm_tpu_torch.ops.group_norm import group_norm
from ccdm_tpu_torch.ops.quant import QuantConv2d


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding `[B] -> [B, dim]`, cos first (as the
    reference concatenates `[cos, sin]`)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_count(channels: int) -> int:
    """Largest divisor of `channels` that is <= 32 (exactly 32 for every
    real config; narrower for test configs)."""
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return groups


def zero_init(module: nn.Module) -> nn.Module:
    """Mark a module whose parameters start at zero (the reference's
    `zero_module`); `models.builder.init_weights_` honours the mark."""
    module.zero_init = True
    return module


class GroupNorm32(nn.Module):
    """GroupNorm with the largest group count <= 32 dividing C, eps 1e-5,
    fp32 parameters and statistics; output in the input dtype. `silu=True`
    fuses the following SiLU into the same kernel.

    This is the JAX package's norm under either value of `norm_fp32`
    (`ccdm_tpu/models/layers.py:GroupNorm32`): with `norm_fp32: false` it
    hands flax's `nn.GroupNorm` the activations' dtype, but flax computes
    the statistics and the normalise in fp32 whatever that dtype and casts
    only the result, so the two values give the same bits (bf16 included),
    and the port has one norm for both."""

    def __init__(self, channels: int):
        super().__init__()
        self.groups = group_count(channels)
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))

    def forward(self, x: torch.Tensor, silu: bool = False,
                add: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`add` `[B, C]` in x's dtype is added to x (rounded to its dtype)
        before the statistics, inside the same kernel."""
        return group_norm(x, self.weight, self.bias, self.groups, 1e-5, silu, add)


def conv3x3(in_ch: int, out_ch: int, dtype, stride: int = 1, quant: bool = False) -> nn.Conv2d:
    """3x3 conv with torch-style padding 1; the int8 `QuantConv2d` (fp32
    weights) when `quant`."""
    if quant:
        return QuantConv2d(in_ch, out_ch, 3, stride=stride, padding=1)
    return nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, dtype=dtype)


def conv1x1(in_ch: int, out_ch: int, dtype, quant: bool = False) -> nn.Conv2d:
    if quant:
        return QuantConv2d(in_ch, out_ch, 1)
    return nn.Conv2d(in_ch, out_ch, 1, dtype=dtype)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """2x nearest upsample + 3x3 conv."""

    def __init__(self, channels: int, out_channels: int, dtype, quant: bool = False):
        super().__init__()
        self.conv = conv3x3(channels, out_channels, dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1."""

    def __init__(self, channels: int, out_channels: int, dtype, quant: bool = False):
        super().__init__()
        self.op = conv3x3(channels, out_channels, dtype, stride=2, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Dropout(nn.Dropout):
    """`nn.Dropout` whose kept units are drawn (`keep`) apart from where
    they are applied (`forward`). A ResBlock that `use_checkpoint`
    rematerialises is handed the units drawn in front of it, so its forward
    recomputed in the backward applies the same ones without restoring a
    generator's state, which no CUDA graph capture permits
    (`models/unet.TimestepBlock`). The kept units are scaled by 1/(1-p) and
    rounded to the input's dtype once, as `F.dropout` rounds them."""

    def keep(self, shape, device) -> Optional[torch.Tensor]:
        """The kept units of an output of `shape` (bool), drawn from the
        default generator; None where nothing drops (eval mode, or p 0)."""
        if not self.training or self.p == 0:
            return None
        return torch.rand(shape, device=device) >= self.p

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if keep is None:
            keep = self.keep(x.shape, x.device)
            if keep is None:
                return x
        return x * keep * (1.0 / (1.0 - self.p) if self.p < 1 else 0.0)


class ResBlock(nn.Module):
    """Timestep-conditioned residual block: `norm→SiLU→conv3x3`, add the
    projected time embedding (or FiLM it with `use_scale_shift_norm`), then
    `norm→SiLU→dropout→zero-conv3x3`, plus a 1x1 skip projection when the
    channel count changes. `quant`: its three convs are int8 `QuantConv2d`s.
    `keep`: the dropout's kept units (`dropout_keep`), drawn inside when not
    given."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dropout: float = 0.0, use_scale_shift_norm: bool = False,
                 dtype=torch.bfloat16, quant: bool = False):
        super().__init__()
        self.use_scale_shift_norm, self.out_channels = use_scale_shift_norm, out_channels
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(), conv3x3(channels, out_channels, dtype, quant=quant))
        emb_width = 2 * out_channels if use_scale_shift_norm else out_channels
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, emb_width, dtype=dtype))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), Dropout(dropout),
            zero_init(conv3x3(out_channels, out_channels, dtype, quant=quant)))
        self.skip_connection = (conv1x1(channels, out_channels, dtype, quant=quant)
                                if channels != out_channels else nn.Identity())

    def dropout_keep(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The dropout's kept units for input `x` (None where nothing drops)."""
        return self.out_layers[2].keep((x.shape[0], self.out_channels, *x.shape[2:]), x.device)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        norm_in, _, conv_in = self.in_layers
        h = conv_in(norm_in(x, silu=True))
        emb_out = self.emb_layers(emb).to(h.dtype)  # [B, C] or [B, 2C]
        norm_out, _, dropout, conv_out = self.out_layers
        if self.use_scale_shift_norm:
            scale, shift = emb_out[:, :, None, None].chunk(2, dim=1)
            h = F.silu(norm_out(h) * (1 + scale) + shift)
        else:
            # h + emb_out, GroupNorm and SiLU in one kernel call
            h = norm_out(h, silu=True, add=emb_out)
        h = conv_out(dropout(h, keep))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over the H·W tokens: pre-norm, fused qkv 1x1
    projection, per-head attention through the kernel, zero-init output
    projection, residual add. The qkv channels are ordered
    (heads, [q|k|v], dh), the reference's legacy packing.

    In a channels-last torso (`channels_last`, the UNet's choice; not read
    from x's strides, which a `torch.export` trace does not always give as
    the card does) the 1x1 projections are batched matrix products over the
    same `Conv1d` weights: the qkv product writes the `[B, 3C, T]` layout
    the attention kernel reads, and the output projection writes
    token-major `[B, T, C]` with the residual and its bias added, so the
    block's output is channels-last again and no layout transpose runs."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 dtype=torch.bfloat16):
        super().__init__()
        if num_head_channels == -1:
            self.num_heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"channels {channels} not divisible by "
                                 f"num_head_channels {num_head_channels}")
            self.num_heads = channels // num_head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1, dtype=dtype)
        self.proj_out = zero_init(nn.Conv1d(channels, channels, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
        b, c, h, w = x.shape
        dh = c // self.num_heads
        tokens = x.reshape(b, c, h * w)
        if channels_last:
            qkv = torch.baddbmm(self.qkv.bias[:, None], self.qkv.weight[:, :, 0].expand(b, -1, -1),
                                self.norm(tokens))
        else:
            qkv = self.qkv(self.norm(tokens))
        qkv = qkv.reshape(b * self.num_heads, 3 * dh, h * w)
        out = flash_attention(qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:])
        out = out.reshape(b, c, h * w)
        if channels_last:  # [B, T, C]: tokens + bias + out^T W^T
            out = torch.baddbmm(tokens.transpose(1, 2) + self.proj_out.bias,
                                out.transpose(1, 2),
                                self.proj_out.weight[:, :, 0].t().expand(b, -1, -1))
            return out.transpose(1, 2).reshape(b, c, h, w)
        return (tokens + self.proj_out(out)).reshape(b, c, h, w)
