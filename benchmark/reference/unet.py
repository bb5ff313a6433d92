"""The conditional UNet of CCDM as plain float32 PyTorch.

The "openai" UNet of Dhariwal and Nichol (guided diffusion) as the CCDM
reference code (LarsDoorenbos/ccdm-stochastic-segmentation) configures it:
input concat([x_t one-hot, image]); sinusoidal time embedding ([cos, sin],
max period 10000) through Linear-SiLU-Linear; an encoder of
`num_res_blocks` ResBlocks a level, with self-attention where the
downsampling rate is in `attention_resolutions` and a stride-2 conv between
levels; a middle Res-Attn-Res; a decoder of `num_res_blocks + 1` ResBlocks a
level on the skip concats, with a nearest 2x upsample and a conv at the end
of each level but the first; then GroupNorm-SiLU-conv3x3 and a softmax over
the classes. GroupNorm takes the largest group count up to 32 that divides
the channels, eps 1e-5. A ResBlock is
`skip(x) + conv(SiLU(GN(conv(SiLU(GN(x))) + Linear(SiLU(emb)))))`; attention
is single-scale softmax(q k^T / sqrt(dh)) v over the H*W tokens, the qkv
channels packed per head as [q | k | v]. With DINO conditioning a feature
map is concatenated in front of input block `feature_block` (at stride 8).

Weights come in as a state dict under the reference code's module names
(`input_blocks.i.j...`); nothing here reads the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

CHANNEL_MULT = {128: (1, 1, 2, 3, 4), 256: (1, 1, 2, 2, 4, 4)}


def groups(channels: int) -> int:
    g = min(32, channels)
    while channels % g:
        g -= 1
    return g


def layout(image_size: int, base: int, channel_mult: Optional[Sequence[int]],
           num_res_blocks: int, attention_resolutions: Sequence[int],
           feature_block: int = -1, feature_channels: int = 0) -> Dict:
    """The UNet's blocks as data: each input, middle and output block a list
    of `(kind, in_channels, out_channels)` layers, kind one of "conv_in",
    "res", "attn", "down", "up"."""
    mult = tuple(channel_mult or CHANNEL_MULT[image_size])
    ch = mult[0] * base
    inputs: List[list] = [[("conv_in", None, ch)]]
    skips = [ch]
    ds = 1
    for level, m in enumerate(mult):
        for _ in range(num_res_blocks):
            cin = ch + (feature_channels if len(inputs) == feature_block and ds == 8 else 0)
            block = [("res", cin, m * base)]
            ch = m * base
            if ds in attention_resolutions:
                block.append(("attn", ch, ch))
            inputs.append(block)
            skips.append(ch)
        if level != len(mult) - 1:
            inputs.append([("down", ch, ch)])
            skips.append(ch)
            ds *= 2
    middle = [("res", ch, ch), ("attn", ch, ch), ("res", ch, ch)]
    outputs = []
    for level, m in reversed(list(enumerate(mult))):
        for i in range(num_res_blocks + 1):
            block = [("res", ch + skips.pop(), m * base)]
            ch = m * base
            if ds in attention_resolutions:
                block.append(("attn", ch, ch))
            if level and i == num_res_blocks:
                block.append(("up", ch, ch))
                ds //= 2
            outputs.append(block)
    return {"inputs": inputs, "middle": middle, "outputs": outputs, "out_channels": ch}


class UNet:
    """`UNet(config, weights)(x, image, t, features=None) -> p0 [B,H,W,C]`,
    float32, NHWC at the boundary. `config` is the benchmark's configuration
    dict (its `unet_openai` group and class count)."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], dtype=torch.float32):
        u = cfg["unet_openai"]
        fce = cfg.get("feature_cond_encoder") or {}
        dino = fce.get("type") == "dino"
        self.head_channels = int(u["num_head_channels"])
        self.base = int(u["base_channels"])
        self.feature_block = int(fce["target_layer"]) if dino else -1
        self.layout = layout(int(u["image_size"]), self.base, u.get("channel_mult"),
                             int(u.get("num_res_blocks", 2)), u["attention_resolutions"],
                             self.feature_block, int(fce.get("channels", 0)) if dino else 0)
        self.w = {k: v.to(dtype) for k, v in weights.items()}
        self.dtype = dtype

    # the layers ------------------------------------------------------------
    def conv(self, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, groups(x.shape[1]), self.w[name + ".weight"],
                            self.w[name + ".bias"], eps=1e-5)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.w[name + ".weight"], self.w[name + ".bias"])

    def res(self, name: str, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv(name + ".in_layers.2", F.silu(self.norm(name + ".in_layers.0", x)))
        h = h + self.linear(name + ".emb_layers.1", F.silu(emb))[:, :, None, None]
        h = self.conv(name + ".out_layers.3", F.silu(self.norm(name + ".out_layers.0", h)))
        skip = (self.conv(name + ".skip_connection", x)
                if name + ".skip_connection.weight" in self.w else x)
        return skip + h

    def attn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        heads, dh = c // self.head_channels, self.head_channels
        tokens = x.reshape(b, c, hh * ww)
        qkv = F.conv1d(self.norm(name + ".norm", tokens), self.w[name + ".qkv.weight"],
                       self.w[name + ".qkv.bias"])
        q, k, v = qkv.reshape(b, heads, 3, dh, hh * ww).unbind(2)      # [B,heads,dh,T]
        weights = torch.softmax(torch.einsum("bndt,bnds->bnts", q, k) / math.sqrt(dh), -1)
        out = torch.einsum("bnts,bnds->bndt", weights, v).reshape(b, c, hh * ww)
        out = F.conv1d(out, self.w[name + ".proj_out.weight"], self.w[name + ".proj_out.bias"])
        return (tokens + out).reshape(b, c, hh, ww)

    def block(self, name: str, layers, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for j, (kind, _, _) in enumerate(layers):
            sub = f"{name}.{j}"
            if kind == "conv_in":
                h = self.conv(sub, h)
            elif kind == "res":
                h = self.res(sub, h, emb)
            elif kind == "attn":
                h = self.attn(sub, h)
            elif kind == "down":
                h = self.conv(sub + ".op", h, stride=2)
            else:
                h = self.conv(sub + ".conv", F.interpolate(h, scale_factor=2, mode="nearest"))
        return h

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        half = self.base // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
        args = t.double()[:, None] * freqs[None].double()
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=1).to(self.dtype)
        return self.linear("time_embed.2", F.silu(self.linear("time_embed.0", emb)))

    # the network -----------------------------------------------------------
    def encode(self, x, image, t, features=None):
        """`(emb, skips)`: the time embedding and every input block's output."""
        emb = self.time_embedding(t)
        h = torch.cat([x, image], dim=-1).to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for i, layers in enumerate(self.layout["inputs"]):
            if i == self.feature_block:
                h = torch.cat([h, features.to(self.dtype).permute(0, 3, 1, 2)], dim=1)
            h = self.block(f"input_blocks.{i}", layers, h, emb)
            skips.append(h)
        return emb, skips

    def decode(self, emb, skips):
        skips = list(skips)
        h = self.block("middle_block", self.layout["middle"], skips[-1], emb)
        for j, layers in enumerate(self.layout["outputs"]):
            h = self.block(f"output_blocks.{j}", layers, torch.cat([h, skips.pop()], 1), emb)
        h = F.silu(self.norm("out.0", h))
        logits = F.conv2d(h, self.w["out.2.weight"], self.w["out.2.bias"], padding=1)
        return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)

    def __call__(self, x, image, t, features=None):
        return self.decode(*self.encode(x, image, t, features))
