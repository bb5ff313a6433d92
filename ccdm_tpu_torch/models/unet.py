"""The image-conditioned diffusion UNet (port of `ccdm_tpu/models/unet.py`).

At its boundary the UNet keeps the JAX layout: `x` `[B,H,W,C]`, `condition`
`[B,H,W,Ci]`, and `diffusion_out` `[B,H,W,C]`. Inside, activations are
indexed `[B, C, H, W]` and laid out as the float convs' weights are
(`UNetModel.channels_last`). The samplers and the served artifact hold a
float UNet's weights channels-last (`lay_out_weights`), so its inference
forwards keep the activations channels-last (NHWC in memory) from the
input concat to the head: cuDNN's NHWC convs and K2's NHWC paths read and
write them with no layout transpose, and `diffusion_out` is a contiguous
NHWC tensor. A UNet as built, so the trainer's (K2's backward takes
NCHW), and a `quantize_convs` UNet (K3 takes NCHW) run NCHW.

Structure: input = concat([x_t one-hot, condition]); sinusoidal timestep
embedding -> 2-layer SiLU MLP; encoder of `num_res_blocks` ResBlocks per
level (+ attention where the downsample rate `ds` is in
`attention_resolutions`) with a Downsample between levels; middle
Res+Attn+Res; decoder mirroring it with skip concats; fp32 head
GroupNorm -> SiLU -> zero-init 3x3 conv -> softmax over classes, and an
optional CE-logits head with its own norm.

Module names are the reference torch UNet's (`time_embed.0/2`,
`input_blocks.i.j`, `middle_block.k`, `output_blocks.j.k`, `out.0/2`,
`out_ce.0/2`); `input_blocks[i]` is the JAX module's `block_idx` i.

DINO conditioning: a `[B, H/stride, W/stride, Cf]` feature map is
concatenated in front of input block `feature_cond_block_idx` when that
block runs at `ds == feature_cond_stride` (Flax infers the wider input, a
torch module is told `feature_channels`). Encoder reuse: `return_skips`
returns the encoder's activations (`in_conv`'s output and every input
block's), and `cached_skips` replays them, running only the middle and the
decoder with the current step's time embedding. `quantize_convs` (the
`quantized_inference` mode) makes exactly the JAX package's sites int8
`QuantConv2d`s: the input conv, every ResBlock's two 3x3 convs and 1x1 skip,
and every Downsample and Upsample conv; the fp32 heads, attention's qkv and
projection and the time MLP stay float. `remat_resblocks` and
`remat_attention` rematerialise the blocks in training (`TimestepBlock`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ccdm_tpu_torch.models.layers import (
    AttentionBlock,
    Downsample,
    GroupNorm32,
    ResBlock,
    Upsample,
    conv3x3,
    timestep_embedding,
    zero_init,
)


def default_channel_mult(image_size: int) -> Tuple[float, ...]:
    """Channel-multiplier table by image size."""
    table = {
        512: (0.5, 1, 1, 2, 2, 4, 4),
        256: (1, 1, 2, 2, 4, 4),
        128: (1, 1, 2, 3, 4),
        64: (1, 2, 3, 4),
    }
    if image_size not in table:
        raise ValueError(f"unsupported image size: {image_size}")
    return table[image_size]


def _cat_channels(parts, channels_last: bool) -> torch.Tensor:
    """`torch.cat(parts, dim=1)` in the torso's layout: channels-last where
    `channels_last` (cat alone falls back to NCHW when an input's layout
    reads as ambiguous, as a batch-1 tensor's may)."""
    if not channels_last:
        return torch.cat(parts, dim=1)
    b, _, *spatial = parts[0].shape
    out = torch.empty((b, sum(p.shape[1] for p in parts), *spatial), dtype=parts[0].dtype,
                      device=parts[0].device, memory_format=torch.channels_last)
    return torch.cat(parts, dim=1, out=out)


def _remat(fn, *args):
    """`fn(*args)` with its activations dropped after the forward and
    recomputed in the backward (`nn.remat`). No generator's state is stashed
    or restored, which a CUDA graph capture would refuse: a rematerialised
    ResBlock is handed its dropout's kept units instead."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class TimestepBlock(nn.Sequential):
    """A container whose ResBlocks also take the time embedding.

    `remat_resblocks` and `remat_attention` (the UNet's `use_checkpoint`
    and `remat_attention` keys) rematerialise each ResBlock and each
    AttentionBlock call in it, the boundary of the JAX package's `nn.remat`
    (`ccdm_tpu/models/unet.py:98-113`), only where autograd records a
    training forward: sampling, evaluation and `torch.export` run the
    blocks as they are."""

    remat_resblocks = False
    remat_attention = False

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                channels_last: bool = False) -> torch.Tensor:
        """`channels_last`: the torso's layout, which the attention blocks
        follow (`UNetModel.channels_last`)."""
        remat = self.training and torch.is_grad_enabled()
        for layer in self:
            if isinstance(layer, ResBlock):
                if remat and self.remat_resblocks:
                    x = _remat(layer, x, emb, layer.dropout_keep(x))
                else:
                    x = layer(x, emb)
            elif isinstance(layer, AttentionBlock):
                if remat and self.remat_attention:
                    x = _remat(layer, x, channels_last)
                else:
                    x = layer(x, channels_last)
            else:
                x = layer(x)
        return x


class UNetModel(nn.Module):
    """See the module docstring. `forward` returns
    `{"diffusion_out": probs [B,H,W,C], "logits": [B,H,W,C-1] or None}`."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int],
                 channel_mult: Sequence[float], dropout: float = 0.0,
                 num_heads: int = 1, num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False, softmax_output: bool = True,
                 ce_head: bool = False, feature_cond_block_idx: int = -1,
                 feature_cond_stride: int = 8, feature_channels: int = 0,
                 dtype=torch.bfloat16, quantize_convs: bool = False,
                 remat_resblocks: bool = False, remat_attention: bool = True):
        super().__init__()
        self.dtype = dtype
        self.quantize_convs = q = quantize_convs
        self.softmax_output = softmax_output
        # the input block the feature map is concatenated in front of, if any
        self.feature_block: Optional[int] = None
        mc = model_channels
        time_dim = mc * 4
        self.time_embed = nn.Sequential(
            nn.Linear(mc, time_dim, dtype=dtype), nn.SiLU(),
            nn.Linear(time_dim, time_dim, dtype=dtype))

        def res(in_ch, out_ch):
            return ResBlock(in_ch, time_dim, out_ch, dropout, use_scale_shift_norm, dtype, q)

        def attn(ch):
            return AttentionBlock(ch, num_heads, num_head_channels, dtype)

        ch = int(channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList([TimestepBlock(conv3x3(in_channels, ch, dtype, quant=q))])
        skip_chs = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out_ch = int(mult * mc)
                in_ch = ch
                if (feature_channels and len(self.input_blocks) == feature_cond_block_idx
                        and ds == feature_cond_stride):
                    self.feature_block = feature_cond_block_idx
                    in_ch += feature_channels
                layers = [res(in_ch, out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepBlock(*layers))
                skip_chs.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepBlock(Downsample(ch, ch, dtype, q)))
                skip_chs.append(ch)
                ds *= 2

        self.middle_block = TimestepBlock(res(ch, ch), attn(ch), res(ch, ch))

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                out_ch = int(mult * mc)
                layers = [res(ch + skip_chs.pop(), out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, ch, dtype, q))
                    ds //= 2
                self.output_blocks.append(TimestepBlock(*layers))
        assert not skip_chs

        # heads run in fp32 (the JAX package's fp32 islands)
        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(), zero_init(conv3x3(ch, out_channels, torch.float32)))
        self.out_ce = (nn.Sequential(
            GroupNorm32(ch), nn.SiLU(),
            zero_init(conv3x3(ch, out_channels - 1, torch.float32))) if ce_head else None)
        for block in self.modules():
            if isinstance(block, TimestepBlock):
                block.remat_resblocks, block.remat_attention = remat_resblocks, remat_attention
        # the float 2-d convs (not the int8 `QuantConv2d`s): the weights
        # `lay_out_weights` converts
        self._float_convs = [m for m in self.modules() if type(m) is nn.Conv2d]

    @property
    def channels_last(self) -> bool:
        """Whether forwards hold their activations channels-last, as read
        from the float convs' weights (`lay_out_weights`; the input conv's,
        whose 3x3 kernel over two or more channels tells the layouts apart).
        A `quantize_convs` UNet runs NCHW, as K3 takes it."""
        return not self.quantize_convs and self.input_blocks[0][0].weight.is_contiguous(
            memory_format=torch.channels_last)

    def lay_out_weights(self, channels_last: bool) -> None:
        """Hold the float convs' weights channels-last, so that forwards run
        the inference torso channels-last (the samplers and the served
        artifact ask for it: `eval/lidc_uncertainty.py`), or contiguous, so
        that they run NCHW (as built, and as training needs: K2's backward
        takes NCHW). Converted in place (`.data`: parameters, optimizers and
        state dicts keep their tensors; no second copy is kept). A
        `quantize_convs` UNet stays NCHW."""
        fmt = (torch.channels_last if channels_last and not self.quantize_convs
               else torch.contiguous_format)
        for c in self._float_convs:
            if not c.weight.is_contiguous(memory_format=fmt):
                c.weight.data = c.weight.data.contiguous(memory_format=fmt)

    def forward(self, x: torch.Tensor, condition: torch.Tensor, t: torch.Tensor,
                feature_condition: Optional[torch.Tensor] = None, *,
                cached_skips: Optional[Tuple[torch.Tensor, ...]] = None,
                return_skips: bool = False) -> dict:
        """`feature_condition` `[B,h,w,Cf]` is the DINO map; `cached_skips`
        (a `return_skips` result) skips the encoder; `return_skips` adds
        `"skips"` to the result."""
        cl = self.channels_last
        emb = self.time_embed(
            timestep_embedding(t, self.time_embed[0].in_features).to(self.dtype))
        if cached_skips is not None:
            skips = list(cached_skips)
            h = skips[-1]
        else:
            if (feature_condition is None) != (self.feature_block is None):
                raise ValueError("feature_condition must be given exactly when the UNet "
                                 "was built with a feature concat")
            # NHWC in: a channels-last view as it is, or made dense NCHW
            h = torch.cat([x, condition], dim=-1).to(self.dtype).permute(0, 3, 1, 2)
            if not cl:
                h = h.contiguous()
            skips = []
            for i, block in enumerate(self.input_blocks):
                if i == self.feature_block:
                    h = _cat_channels([h, feature_condition.to(self.dtype).permute(0, 3, 1, 2)],
                                      cl)
                h = block(h, emb, cl)
                skips.append(h)
        encoder_skips = tuple(skips) if return_skips else None
        h = self.middle_block(h, emb, cl)
        for block in self.output_blocks:
            h = block(_cat_channels([h, skips.pop()], cl), emb, cl)

        h = h.float()
        norm, _, conv = self.out
        # [B,H,W,C]: contiguous where the torso is channels-last
        out = conv(norm(h, silu=True)).permute(0, 2, 3, 1)
        if self.softmax_output:
            out = torch.softmax(out, dim=-1)
        ret = {"diffusion_out": out, "logits": None}
        if return_skips:
            ret["skips"] = encoder_skips
        if self.out_ce is not None:
            norm, _, conv = self.out_ce
            ret["logits"] = conv(norm(h, silu=True)).permute(0, 2, 3, 1)
        return ret


def create_unet(
    image_size: int,
    base_channels: int,
    out_channels: int,
    in_channels: Optional[int] = None,
    num_res_blocks: int = 2,
    channel_mult: Optional[Sequence[float]] = None,
    attention_resolutions: Sequence[int] = (32, 16, 8),
    num_heads: int = 1,
    num_head_channels: int = -1,
    use_scale_shift_norm: bool = False,
    dropout: float = 0.0,
    softmax_output: bool = True,
    ce_head: bool = False,
    feature_cond_block_idx: int = -1,
    feature_cond_stride: int = 8,
    feature_channels: int = 0,
    dtype=torch.bfloat16,
    quantize_convs: bool = False,
    remat_resblocks: bool = False,
    remat_attention: bool = True,
) -> UNetModel:
    """Factory with the JAX `create_unet`'s arguments. `in_channels`
    defaults to `out_channels + 1` (the one-hot state plus one image
    channel) and `feature_channels` to 0 (no feature concat); Flax infers
    both, a torch module must be told."""
    if channel_mult is None:
        channel_mult = default_channel_mult(image_size)
    return UNetModel(
        in_channels=out_channels + 1 if in_channels is None else in_channels,
        model_channels=base_channels,
        out_channels=out_channels,
        num_res_blocks=num_res_blocks,
        attention_resolutions=tuple(attention_resolutions),
        channel_mult=tuple(channel_mult),
        dropout=dropout,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        use_scale_shift_norm=use_scale_shift_norm,
        softmax_output=softmax_output,
        ce_head=ce_head,
        feature_cond_block_idx=feature_cond_block_idx,
        feature_cond_stride=feature_cond_stride,
        feature_channels=feature_channels,
        dtype=dtype,
        quantize_convs=quantize_convs,
        remat_resblocks=remat_resblocks,
        remat_attention=remat_attention,
    )
