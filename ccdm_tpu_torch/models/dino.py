"""DINO ViT feature extractor (port of `ccdm_tpu/models/dino.py`).

The encoder of the Cityscapes configuration: a DINO ViT (dino_vits8: 384
channels, 6 heads, 12 blocks) whose chosen facet at a chosen block, folded
back to the token grid `[B, H/stride, W/stride, D]`, is concatenated into
the UNet. fp32 throughout, as the JAX encoder.

Numerics follow the JAX module: LayerNorm eps 1e-6, exact-erf GELU, qkv
packed as `(3, heads, dh)`, the patch conv VALID with stride `stride`
(`1 + (H - p) // s` tokens a side), the position embedding resized with
torch's bicubic sampling (a = -0.75) and DINO's `+0.1` scale nudge, and
facets flattened head-minor (`channel = d * heads + head`), the order the
Cityscapes UNet weights expect. Attention inside the ViT is plain
`torch.matmul` and an fp32 softmax: the JAX package computes it with
`einsum`, outside any Pallas kernel.

Module names are those of the DINO/timm `VisionTransformer`
(`patch_embed.proj`, `cls_token`, `pos_embed`, `blocks.N.norm1`,
`blocks.N.attn.qkv`, `blocks.N.attn.proj`, `blocks.N.norm2`,
`blocks.N.mlp.fc1`, `blocks.N.mlp.fc2`), so an upstream checkpoint loads
once its unused final `norm.*` and `head.*` entries are dropped.

Not ported: the facets of several blocks at once, log-binned descriptors
and saliency maps.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VIT_CONFIGS = {
    "dino_vits8": dict(embed_dim=384, depth=12, num_heads=6, patch_size=8),
    "dino_vitb8": dict(embed_dim=768, depth=12, num_heads=12, patch_size=8),
    "dino_vits16": dict(embed_dim=384, depth=12, num_heads=6, patch_size=16),
    "dino_vitb16": dict(embed_dim=768, depth=12, num_heads=12, patch_size=16),
}

_CUBIC_A = -0.75  # torch's bicubic kernel coefficient (Keys, a = -0.75)


def _torch_bicubic_matrix(in_size: int, out_size: int, src_scale: float) -> np.ndarray:
    """Interpolation weights `[out, in]` of torch's `F.interpolate(mode=
    'bicubic', align_corners=False, recompute_scale_factor=False)`: source
    coordinate `(dst + 0.5) * src_scale - 0.5`, 4-tap Keys kernel, taps
    clamped at the edges, no antialiasing."""
    a = _CUBIC_A
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * src_scale - 0.5
        f = np.floor(src)
        t = src - f
        coeffs = (
            ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
            ((a + 2) * t - (a + 3)) * t * t + 1,
            ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1,
            ((a * (2 - t) - 5 * a) * (2 - t) + 8 * a) * (2 - t) - 4 * a,
        )
        for tap, c in zip((-1, 0, 1, 2), coeffs):
            idx = int(np.clip(f + tap, 0, in_size - 1))
            w[i, idx] += c
    return w.astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic-resize the (non-cls) position embeddings `[1, 1 + N, D]`, N a
    square grid, to a `grid_hw` token grid, with DINO's `+0.1` nudge of the
    scale factor."""
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    n = patch_pe.shape[1]
    side = int(round(math.sqrt(n)))
    if side * side != n:
        raise ValueError(f"non-square pretrain grid of {n} positions")
    h, w = grid_hw
    if (h, w) == (side, side):
        return pos_embed
    grid = patch_pe.reshape(1, side, side, -1)

    def matrix(out):  # torch is handed scale (g + 0.1) / side and samples at its inverse
        return torch.from_numpy(_torch_bicubic_matrix(side, out, side / (out + 0.1))).to(
            pos_embed.device)

    grid = torch.einsum("hs,bstd->bhtd", matrix(h), grid)
    grid = torch.einsum("wt,bhtd->bhwd", matrix(w), grid)
    return torch.cat([cls_pe, grid.reshape(1, h * w, -1)], dim=1)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample of NHWC `x` to `size` with half-pixel centres: on
    upsampling, `jax.image.resize(..., "bilinear")` samples the same way
    (its edge renormalisation equals torch's clamped source coordinate).
    Downsampling, where JAX antialiases, is not ported."""
    h, w = x.shape[1:3]
    if (h, w) == tuple(size):
        return x
    if size[0] < h or size[1] < w:
        raise NotImplementedError(f"bilinear downsampling {(h, w)} -> {tuple(size)}")
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    """Pre-LN transformer block; `forward` returns (output, facets)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor):
        b, t, d = x.shape
        heads = self.num_heads
        dh = d // heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(b, t, 3, heads, dh)
        q, k, v = qkv.unbind(dim=2)                              # [B,T,H,dh]
        logits = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(dh)
        attn = torch.softmax(logits.float(), dim=-1)             # [B,H,T,T]
        out = torch.matmul(attn, v.transpose(1, 2)).transpose(1, 2).reshape(b, t, d)
        x = x + self.attn.proj(out)
        x = x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))  # exact erf GELU

        def flat(z):  # [B,T,heads,dh] -> [B,T,dh*heads], head-minor
            return z.transpose(2, 3).reshape(b, t, d)

        return x, {"query": flat(q), "key": flat(k), "value": flat(v), "token": x,
                   "attn": attn}


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=stride)


class DinoViT(nn.Module):
    """DINO ViT returning the facet of a chosen block as a feature map."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int, patch_size: int,
                 stride: int, source_layer: int = 11, facet: str = "key",
                 pretrain_size: int = 224):
        super().__init__()
        if not (patch_size % stride == 0 and stride <= patch_size):
            raise ValueError(f"stride {stride} must divide patch {patch_size}")
        if not 0 <= source_layer < depth:
            raise ValueError(f"source layer {source_layer} out of range for depth {depth}")
        self.embed_dim = embed_dim
        self.patch_size, self.stride = patch_size, stride
        self.source_layer, self.facet = source_layer, facet
        self.patch_embed = _PatchEmbed(embed_dim, patch_size, stride)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + (pretrain_size // patch_size) ** 2, embed_dim))
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads) for _ in range(depth))

    def forward(self, images: torch.Tensor, facet: Optional[str] = None) -> torch.Tensor:
        """`images` `[B,H,W,3]`, ImageNet-normalised. Returns block
        `source_layer`'s facet: `[B,h',w',D]` for "key", "query", "value" or
        "token", the post-softmax attention `[B, heads, 1+h'w', 1+h'w']` for
        "attn"."""
        facet = facet or self.facet
        b, h, w, _ = images.shape
        gh = 1 + (h - self.patch_size) // self.stride
        gw = 1 + (w - self.patch_size) // self.stride
        x = self.patch_embed.proj(images.float().permute(0, 3, 1, 2))  # [B,D,gh,gw]
        x = x.flatten(2).transpose(1, 2)                                # [B,gh*gw,D]
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, (gh, gw))
        for block in self.blocks[:self.source_layer + 1]:  # later blocks feed nothing
            x, facets = block(x)
        if facet == "attn":
            return facets["attn"]
        # drop cls and fold back to the token grid
        return facets[facet][:, 1:].reshape(b, gh, gw, self.embed_dim)


@torch.no_grad()
def init_vit_weights_(vit: DinoViT, generator: torch.Generator) -> DinoViT:
    """Random weights from `generator` (a CPU generator), as the JAX module
    initialises them: conv and linear weights ~ N(0, 1/fan_in), biases 0,
    LayerNorm 1/0, `cls_token` 0, `pos_embed` ~ N(0, 0.02^2)."""
    for module in vit.modules():
        if isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(math.prod(w.shape[1:])))
            module.bias.zero_()
    vit.cls_token.zero_()
    vit.pos_embed.copy_(torch.randn(vit.pos_embed.shape, generator=generator) * 0.02)
    return vit


def _unflatten(flat) -> Dict[str, Any]:
    """`{"a/b/c": array}` (a converted `.npz`) -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key in flat:
        *parents, leaf = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(flat[key])
    return tree


class DinoFeatureEncoder:
    """The configured encoder (`feature_cond_encoder` params): its `init`
    makes the `DinoViT` holding the weights, and a call maps images through
    it to the UNet's feature map. Frozen by default (`train: no`): the map
    is computed without autograd, the JAX `stop_gradient`; with `train:
    yes` the weights require gradients and the map carries them."""

    def __init__(self, fce_params: dict):
        name = fce_params.get("model", "dino_vits8")
        # `vit_config` overrides the named architecture (tiny test encoders)
        cfg = fce_params.get("vit_config") or VIT_CONFIGS[name]
        self.name = name
        self.cfg = dict(cfg)
        self.stride = int(fce_params.get("output_stride", 8))
        self.source_layer = int(fce_params.get("source_layer", 11))
        self.facet = str(fce_params.get("facet", "key"))
        self.channels = cfg["embed_dim"]
        self.trainable = bool(fce_params.get("train", False))

    def init(self, generator: Optional[torch.Generator] = None, device=None) -> DinoViT:
        """The ViT on `device` (default: the CUDA card; the CPU only when
        asked for with `device="cpu"`), weights drawn from `generator`
        (default: seed 7, the JAX package's encoder key)."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("DinoFeatureEncoder.init: no CUDA device; the encoder "
                                   "builds on the card unless the caller passes device='cpu'")
            device = "cuda"
        cfg = self.cfg
        with torch.device("meta"):
            vit = DinoViT(cfg["embed_dim"], cfg["depth"], cfg["num_heads"], cfg["patch_size"],
                          self.stride, self.source_layer, self.facet,
                          int(cfg.get("pretrain_size", 224)))
        vit = vit.to_empty(device=torch.device(device))
        init_vit_weights_(vit, generator or torch.Generator().manual_seed(7))
        return vit.eval().requires_grad_(self.trainable)

    @staticmethod
    def load_pretrained(vit: DinoViT, npz_path: str) -> DinoViT:
        """Load converted DINO weights (the `.npz` of
        `scripts/convert_dino_checkpoint.py`) into `vit`."""
        from ccdm_tpu_torch.models.convert import flax_dino_to_state_dict

        with np.load(npz_path) as blob:
            state = flax_dino_to_state_dict(_unflatten(blob))
        vit.load_state_dict(state, strict=True)
        return vit

    def __call__(self, vit: DinoViT, images: torch.Tensor,
                 resize_to: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """`[B,H,W,3]` -> `[B, H/stride, W/stride, D]` (or `resize_to`)."""
        with contextlib.nullcontext() if self.trainable else torch.no_grad():
            feats = vit(images)
            h, w = images.shape[1:3]
            return resize_bilinear(feats, resize_to or (h // self.stride, w // self.stride))
