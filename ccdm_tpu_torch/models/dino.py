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
once its unused final `norm.*` and `head.*` entries are dropped
(`tools/convert_dino_checkpoint.py` writes the `.npz` that `weights:`
names).

The descriptor extras of the reference's `ViTExtractor`, as the JAX
module has them: the facets of several blocks in one pass (`DinoViT`'s
`layers`), log-binned descriptors (`log_bin_descriptors`),
`DinoFeatureEncoder.extract_descriptors` and `extract_saliency_maps`,
which `tools/extract_dino_descriptors.py` calls.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.ops.precision import fp32_precision

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


def _triangle_matrix(in_size: int, out_size: int) -> np.ndarray:
    """`[out, in]` weights of `jax.image.resize(..., "bilinear")` along one
    axis (its `scale_and_translate` with the triangle kernel and
    antialiasing): sample `(o + 0.5) * in / out - 0.5`, the kernel widened
    by `in / out` where that is above 1, each row normalised to sum 1."""
    inv_scale = in_size / out_size
    width = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(in_size)[None]) / width)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC `x` to `size`, as `jax.image.resize(...,
    "bilinear")`. Where both axes grow or keep their size (the evaluator's
    upsampling of its probabilities), `F.interpolate` samples with
    half-pixel centres, as JAX does (its edge renormalisation equals
    torch's clamped source coordinate); where an axis shrinks, JAX
    antialiases with a triangle kernel widened by the scale, and each axis
    takes its weight matrix (`_triangle_matrix`)."""
    h, w = x.shape[1:3]
    size = tuple(int(s) for s in size)
    if (h, w) == size:
        return x
    if min(size) < 1:
        raise ValueError(f"bilinear resize of {(h, w)} to {size}")
    if size[0] >= h and size[1] >= w:
        out = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                            align_corners=False)
        return out.permute(0, 2, 3, 1)
    wh, ww = (torch.from_numpy(_triangle_matrix(n, m)).to(x.device, x.dtype)
              for n, m in ((h, size[0]), (w, size[1])))
    return torch.einsum("qw,bpwc->bpqc", ww, torch.einsum("ph,bhwc->bpwc", wh, x))


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

    def forward(self, images: torch.Tensor, facet: Optional[str] = None,
                layers: Optional[Sequence[int]] = None):
        """`images` `[B,H,W,3]`, ImageNet-normalised. Returns block
        `source_layer`'s facet: `[B,h',w',D]` for "key", "query", "value" or
        "token", the post-softmax attention `[B, heads, 1+h'w', 1+h'w']` for
        "attn". With `layers` (the multi-layer descriptor path), a list of
        that facet at each of those blocks, in their order, from one pass
        that stops at the last of them."""
        facet = facet or self.facet
        capture = tuple(int(l) for l in layers) if layers is not None else (self.source_layer,)
        if not capture or not all(0 <= l < len(self.blocks) for l in capture):
            raise ValueError(f"capture layers {capture} out of range for depth "
                             f"{len(self.blocks)}")
        b, h, w, _ = images.shape
        gh = 1 + (h - self.patch_size) // self.stride
        gw = 1 + (w - self.patch_size) // self.stride
        x = self.patch_embed.proj(images.float().permute(0, 3, 1, 2))  # [B,D,gh,gw]
        x = x.flatten(2).transpose(1, 2)                                # [B,gh*gw,D]
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, (gh, gw))
        grabbed = {}
        for i, block in enumerate(self.blocks[:max(capture) + 1]):  # later blocks feed nothing
            x, facets = block(x)
            if i in capture:
                grabbed[i] = facets[facet]
        if facet == "attn":
            outs = [grabbed[i] for i in capture]
        else:  # drop cls and fold back to the token grid
            outs = [grabbed[i][:, 1:].reshape(b, gh, gw, self.embed_dim) for i in capture]
        return outs if layers is not None else outs[0]


def log_bin_descriptors(feats: torch.Tensor, hierarchy: int = 2) -> torch.Tensor:
    """Log-binned descriptors of a token-grid facet map `[B,gh,gw,D]` ->
    `[B,gh,gw,D*(1+8*hierarchy)]` (the JAX package's `log_bin_descriptors`,
    the reference's `ViTExtractor._log_bin`): level k averages over a 3^k
    window (edges counting only the cells inside, `count_include_pad=False`)
    and is read at the ring of offsets `{-3^k, 0, 3^k}` in each direction,
    row-major, clamped at the edges, the centre only at k = 0. The channels
    are bin-major blocks of D. Gathers over the whole grid, no loop over
    pixels."""
    b, gh, gw, d = feats.shape
    f32 = feats.float()
    nchw = f32.permute(0, 3, 1, 2)
    pools = []
    for k in range(hierarchy):
        win = 3 ** k
        pools.append(f32 if win == 1 else F.avg_pool2d(
            nchw, win, stride=1, padding=win // 2, count_include_pad=False).permute(0, 2, 3, 1))
    ys = torch.arange(gh, device=feats.device)
    xs = torch.arange(gw, device=feats.device)
    parts = []
    for k in range(hierarchy):
        step = 3 ** k
        for di in (-step, 0, step):
            for dj in (-step, 0, step):
                if di == 0 and dj == 0 and k != 0:
                    continue
                iy = (ys + di).clamp(0, gh - 1)
                ix = (xs + dj).clamp(0, gw - 1)
                parts.append(pools[k][:, iy][:, :, ix])
    return torch.cat(parts, dim=-1).to(feats.dtype)


# the heads averaged for saliency (the reference's `dino.py:336`, dino_vits8's)
SALIENCY_HEAD_IDXS = (0, 2, 4, 5)


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

    @torch.no_grad()
    def extract_descriptors(self, vit: DinoViT, images: torch.Tensor, layers=None,
                            facet: Optional[str] = None,
                            resize_shape: Optional[Tuple[int, int]] = None,
                            log_bin: bool = False):
        """The reference's `ViTExtractor.extract_descriptors` (the JAX
        package's method of the same name). `layers` an int (None: the
        configured block) gives one `[B,h',w',D]` map, resized bilinearly
        to `resize_shape` (default `(H//stride, W//stride)`); a list or
        tuple gives one map per block, resized only when `resize_shape` is
        given. `log_bin` applies `log_bin_descriptors` to the token grid
        first. fp32 whatever the process's TF32 settings."""
        facet = facet or self.facet
        if facet not in ("key", "query", "value", "token"):
            raise ValueError(f"{facet} is not a supported facet for descriptors")
        multi = isinstance(layers, (list, tuple))
        capture = tuple(layers) if multi else (
            (self.source_layer,) if layers is None else (int(layers),))
        with fp32_precision():
            grids = vit(images, facet=facet, layers=capture)
            if log_bin:
                grids = [log_bin_descriptors(g) for g in grids]
            h, w = images.shape[1:3]
            target = resize_shape or (h // self.stride, w // self.stride)
            out = [g if multi and resize_shape is None else resize_bilinear(g, target)
                   for g in grids]
        return out if multi else out[0]

    @torch.no_grad()
    def extract_saliency_maps(self, vit: DinoViT, images: torch.Tensor) -> torch.Tensor:
        """The reference's `ViTExtractor.extract_saliency_maps`: the last
        block's attention from the cls token to every patch token, averaged
        over the heads `SALIENCY_HEAD_IDXS`, min-max normalised per image
        (a constant map gives zeros, not NaN). `[B, tokens - 1]`; dino_vits8
        only, whose heads those are."""
        if self.name != "dino_vits8":
            raise ValueError("saliency maps are supported only for dino_vits model_type")
        with fp32_precision():
            attn = vit(images, facet="attn", layers=(len(vit.blocks) - 1,))[0]
        heads = torch.tensor(SALIENCY_HEAD_IDXS, device=attn.device)
        cls_attn = attn[:, heads, 0, 1:].mean(dim=1)
        lo = cls_attn.min(dim=1, keepdim=True).values
        hi = cls_attn.max(dim=1, keepdim=True).values
        return (cls_attn - lo) / (hi - lo).clamp_min(1e-12)
