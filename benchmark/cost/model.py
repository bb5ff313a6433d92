"""What one call of the CCDM UNet (and DINO's ViT) needs, worked out from the
configuration's shapes: model FLOPs, and each GroupNorm, attention and int8
conv site with the least time the card could take for it.

Sites follow the architecture (`benchmark/reference/unet.layout`), never the
program's modules, so a later change that fuses or replaces a kernel leaves
the counts as they are. Bytes count each input read once and each output
written once; GroupNorm's operations are its fp32 work an element.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

from benchmark.cost.peaks import bound_s
from benchmark.reference.unet import layout

BF16, FP32 = 2, 4


class Conv(NamedTuple):
    batch: int
    cin: int
    height: int      # input size
    width: int
    cout: int
    kernel: int
    stride: int
    encoder: bool    # in an input block (skipped by a reuse step)

    @property
    def flops(self) -> float:
        ho, wo = self.height // self.stride, self.width // self.stride
        return 2.0 * self.batch * ho * wo * self.cout * self.cin * self.kernel ** 2


class Norm(NamedTuple):
    shape: tuple     # [B, C, *spatial]
    itemsize: int
    silu: bool
    add: bool
    encoder: bool


class Attention(NamedTuple):
    bh: int
    tokens: int
    dh: int
    encoder: bool

    @property
    def flops(self) -> float:
        return 4.0 * self.bh * self.tokens ** 2 * self.dh


def group_norm_bound_s(site: Norm, backward: bool = False) -> float:
    """The forward reads x, the weight, the bias and the add and writes y;
    the backward reads x, dy, the weight, the bias and the add and writes
    dx, both parameters' gradients and the add's."""
    n, c = math.prod(site.shape), site.shape[1]
    add_bytes = site.shape[0] * c * site.itemsize if site.add else 0
    if backward:
        return bound_s(3 * n * site.itemsize + 4 * 4 * c + 2 * add_bytes,
                       n * (14 + 8 * site.silu + site.add), "float32")
    return bound_s(2 * n * site.itemsize + 2 * 4 * c + add_bytes,
                   n * (6 + 3 * site.silu + site.add), "float32")


def attention_bound_s(site: Attention) -> float:
    """q, k and v read and the output written in bf16; QK^T and PV."""
    return bound_s(4 * site.bh * site.tokens * site.dh * BF16, site.flops, "bfloat16")


def int8_conv_bound_s(site: Conv) -> float:
    """The bf16 input read, the int8 codes and fp32 scales and bias read,
    the bf16 output written; the products on the int8 tensor cores."""
    ho, wo = site.height // site.stride, site.width // site.stride
    nbytes = (site.batch * site.cin * site.height * site.width * BF16
              + site.cout * site.cin * site.kernel ** 2 + 2 * site.cout * FP32
              + site.batch * site.cout * ho * wo * BF16)
    return bound_s(nbytes, site.flops, "int8")


class UNetCost(NamedTuple):
    convs: List[Conv]            # every conv (the int8 sites are these)
    norms: List[Norm]
    attentions: List[Attention]
    other_flops: float           # linears and the attention blocks' 1x1 projections
    other_encoder_flops: float

    def flops(self, encoder: bool = True) -> float:
        """Model FLOPs of one call; `encoder` False: a reuse step's, which
        runs the middle and the decoder only."""
        keep = (lambda s: True) if encoder else (lambda s: not s.encoder)
        return (sum(c.flops for c in self.convs if keep(c))
                + sum(a.flops for a in self.attentions if keep(a))
                + self.other_flops - (0 if encoder else self.other_encoder_flops))


def unet_cost(cfg: Dict, batch: int, height: int, width: int) -> UNetCost:
    """The sites of one UNet call on `[batch, height, width]` inputs under the
    configuration `cfg` (the benchmark's configuration file)."""
    u = cfg["unet_openai"]
    fce = cfg.get("feature_cond_encoder") or {}
    dino = fce.get("type") == "dino"
    c = int(cfg["num_classes"])
    base, dh = int(u["base_channels"]), int(u["num_head_channels"])
    lay = layout(int(u["image_size"]), base, u.get("channel_mult"),
                 int(u.get("num_res_blocks", 2)), u["attention_resolutions"],
                 int(fce["target_layer"]) if dino else -1,
                 int(fce.get("channels", 0)) if dino else 0)
    convs, norms, attns = [], [], []
    other = [0.0, 0.0]
    emb = 4 * base
    other[0] += 2.0 * batch * (base * emb + emb * emb)   # the time MLP
    scale = [1]

    def walk(layers, encoder: bool):
        for kind, cin, cout in layers:
            h, w = height // scale[0], width // scale[0]
            if kind == "conv_in":
                convs.append(Conv(batch, c + int(cfg["image_channels"]), h, w, cout, 3, 1,
                                  encoder))
            elif kind == "res":
                norms.append(Norm((batch, cin, h, w), BF16, True, False, encoder))
                convs.append(Conv(batch, cin, h, w, cout, 3, 1, encoder))
                norms.append(Norm((batch, cout, h, w), BF16, True, True, encoder))
                convs.append(Conv(batch, cout, h, w, cout, 3, 1, encoder))
                if cin != cout:
                    convs.append(Conv(batch, cin, h, w, cout, 1, 1, encoder))
                f = 2.0 * batch * emb * cout
                other[0] += f
                other[1] += f * encoder
            elif kind == "attn":
                t = h * w
                norms.append(Norm((batch, cin, t), BF16, False, False, encoder))
                attns.append(Attention(batch * cin // dh, t, dh, encoder))
                f = 2.0 * batch * t * cin * 4 * cin         # qkv and the output projection
                other[0] += f
                other[1] += f * encoder
            elif kind == "down":
                convs.append(Conv(batch, cin, h, w, cout, 3, 2, encoder))
                scale[0] *= 2
            else:  # "up": a nearest 2x upsample, then the conv at the new size
                scale[0] //= 2
                convs.append(Conv(batch, cin, 2 * h, 2 * w, cout, 3, 1, encoder))

    for block in lay["inputs"]:
        walk(block, True)
    walk(lay["middle"], False)
    for block in lay["outputs"]:
        walk(block, False)
    ch = lay["out_channels"]
    norms.append(Norm((batch, ch, height, width), FP32, True, False, False))
    head = Conv(batch, ch, height, width, c, 3, 1, False)
    other[0] += head.flops                               # the fp32 head is no int8 site
    return UNetCost(convs, norms, attns, other[0], other[1])


def dino_flops(batch: int, height: int, width: int, *, dim: int, patch: int, stride: int,
               source_layer: int) -> float:
    """Model FLOPs of the key facet of block `source_layer`: the patch
    embedding, the blocks before it whole, and its qkv projection."""
    t = (1 + (height - patch) // stride) * (1 + (width - patch) // stride) + 1
    f = 2.0 * batch * (t - 1) * dim * 3 * patch * patch
    block = 2.0 * batch * t * dim * (3 * dim + dim + 8 * dim) + 4.0 * batch * t * t * dim
    return f + source_layer * block + 2.0 * batch * t * dim * 3 * dim


def sampler_call(cfg: Dict, batch: int, height: int, width: int, steps: int,
                 encoder_reuse: int = 1, dino: Optional[Dict] = None) -> Dict[str, float]:
    """One sampler call of `steps` reverse steps at UNet batch `batch`:
    model FLOPs, and the summed bound of its GroupNorm, attention and int8
    conv sites, in seconds. With encoder reuse only every R-th step runs the
    encoder's sites; `dino` (`{"images": n, ...dino_flops keywords}`) adds
    the encoder's FLOPs, once a call."""
    cost = unet_cost(cfg, batch, height, width)
    full = sum(1 for k in range(steps) if encoder_reuse == 1 or k % encoder_reuse == 0)
    reuse = steps - full

    def total(sites, fn):
        return (full * sum(fn(s) for s in sites)
                + reuse * sum(fn(s) for s in sites if not s.encoder))

    out = {
        "flops": full * cost.flops(True) + reuse * cost.flops(False),
        "k2_bound_s": total(cost.norms, group_norm_bound_s),
        "k1_bound_s": total(cost.attentions, attention_bound_s),
        "k3_bound_s": total(cost.convs, int8_conv_bound_s),
        "steps": float(steps),
    }
    if dino:
        d = dict(dino)
        out["flops"] += dino_flops(d.pop("images"), height, width, **d)
    return out

