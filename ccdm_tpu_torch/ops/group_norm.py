"""Fused GroupNorm(+SiLU) (port of `ccdm_tpu/ops/group_norm.py`).

Layout: NCHW, or any `[B, C, *spatial]` — the UNet's layout inside. Stats
and the normalise run in fp32; the output has the input's dtype (fp32 or
bf16); `weight`/`bias` are fp32 `[C]`. An optional `add` `[B, C]` in x's
dtype is added to x first and the sum rounded to x's dtype, as the
ResBlock's `h + emb_out` does; the kernel normalises that sum without a
separate pass.

`group_norm` is the wrapper the model calls. On a CPU tensor it runs the
plain PyTorch version, `torch_group_norm`; on a CUDA tensor it launches the
hand-written kernel (`csrc/group_norm.cu`) or raises. `_plan` picks the
kernel's path from the shape alone:

- "S": slabs of at most `_S_MAX_PACKS` vectors per lane, one warp per
  (sample, group) slab, values in registers;
- "M": slabs that fit the shared memory of a thread-block cluster of up to
  `_M_MAX_CLUSTER` blocks, one bulk copy into shared memory per block;
- "L": larger slabs, partial sums to scratch and a second pass.

S and M run one CUDA kernel per call and read x once; L runs two and reads
it twice. `launches` counts wrapper calls on the card, `path_launches` splits
them by path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ccdm_tpu_torch.ops import _build

launches = 0
path_launches = {"S": 0, "M": 0, "L": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"S": 0, "M": 1, "L": 2}
_THREADS = 256
# Path limits, from timings of every flagship site on the H100 (PERF.md): at
# 16 vectors a lane path S holds 157 registers a thread, one block an SM,
# and ran slower than M; at 128 KB a block, one block an SM, path M ran
# slower than L on 1 MB slabs.
_S_MAX_PACKS = 8                  # vectors per lane that path S keeps in registers
_M_CHUNK_BYTES = 64 * 1024        # shared memory a path-M block holds at most: 3 blocks an SM
_M_MAX_CLUSTER = 8                # the portable cluster size
_LOADS_PER_THREAD = 8             # path L: 16-byte loads each thread makes per block and pass
_MIN_BLOCKS = 4 * 132             # path L: a few blocks per H100 SM when B*G alone is too few


def torch_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5, silu: bool = False,
                     add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU) with flax's numerics: fp32 stats,
    var = max(E[x²] - mean², 0), y = (x - mean) * (rsqrt(var + eps) * w) + b.
    `add` `[B, C]` is added to x in x's dtype first."""
    b, c = x.shape[:2]
    if add is not None:
        x = x + add.reshape(b, c, *([1] * (x.dim() - 2)))
    cpg = c // groups
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    xc = x.float().reshape(b, c, -1)
    mean_c = mean.repeat_interleave(cpg, dim=1)
    mul = rstd.repeat_interleave(cpg, dim=1) * weight.float()[None, :, None]
    y = (xc - mean_c) * mul + bias.float()[None, :, None]
    if silu:
        y = torch.nn.functional.silu(y)
    return y.reshape(x.shape).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs one call: `path` "S", "M" or "L"; `vec` elements
    per load (16 bytes, or 1 where H·W or the address does not allow it);
    `param` packs per lane (S), cluster size (M) or splits per slab (L);
    `chunk` elements per block (M, L)."""

    path: str
    vec: int
    param: int
    chunk: int = 0


def _splits(batch_groups: int, slab: int, itemsize: int) -> int:
    """Path L's chunks per (sample, group) slab: enough that one block reads
    about `_THREADS * _LOADS_PER_THREAD` vectors, and enough blocks to fill
    the card."""
    vec = 16 // itemsize
    splits = math.ceil(slab / (_THREADS * vec * _LOADS_PER_THREAD))
    wanted = math.ceil(_MIN_BLOCKS / batch_groups)
    return max(1, splits, min(wanted, math.ceil(slab / (_THREADS * vec))))


def _plan(shape: Sequence[int], dtype: torch.dtype, groups: int,
          aligned: bool = True) -> Plan:
    """The kernel's path for a contiguous `[B, C, *spatial]` input of `dtype`
    (`aligned`: its address is a multiple of 16 bytes)."""
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    slab = c // groups * hw
    itemsize = dtype.itemsize
    full = 16 // itemsize
    vec = full if aligned and hw % full == 0 else 1
    packs = math.ceil(slab / (32 * vec))
    if packs <= _S_MAX_PACKS:
        return Plan("S", vec, 1 << (packs - 1).bit_length())
    cluster = math.ceil(slab * itemsize / _M_CHUNK_BYTES)
    if cluster <= _M_MAX_CLUSTER:
        return Plan("M", vec, cluster, math.ceil(math.ceil(slab / cluster) / vec) * vec)
    splits = _splits(b * groups, slab, itemsize)
    return Plan("L", vec, splits, math.ceil(math.ceil(slab / splits) / vec) * vec)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5, silu: bool = False,
               add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over `[B, C, *spatial]` with an optional fused SiLU and an
    optional `[B, C]` add in front of it."""
    global launches
    if x.device.type == "cpu":
        return torch_group_norm(x, weight, bias, groups, eps, silu, add)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError(f"group_norm: x must be a non-empty contiguous [B, C, ...] "
                         f"tensor, got shape {tuple(x.shape)} strides {x.stride()}")
    b, c = x.shape[:2]
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm: {c} channels do not split into {groups} groups")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.device != x.device or p.dtype != torch.float32 or p.shape != (c,)
                or not p.is_contiguous()):
            raise ValueError(f"group_norm: {name} must be contiguous float32 [{c}] on "
                             f"{x.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")
    if add is not None and (add.device != x.device or add.dtype != x.dtype
                            or add.shape != (b, c) or not add.is_contiguous()):
        raise ValueError(f"group_norm: add must be contiguous {x.dtype} [{b}, {c}] on "
                         f"{x.device}, got {add.dtype} {tuple(add.shape)} on {add.device}")
    plan = _plan(x.shape, x.dtype, groups, aligned=x.data_ptr() % 16 == 0)
    y = torch.empty_like(x)
    partial = (torch.empty(b * groups * plan.param * 2, dtype=torch.float32, device=x.device)
               if plan.path == "L" else None)
    status = _build.library().ccdm_group_norm(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if add is None else add.data_ptr(),
        None if partial is None else partial.data_ptr(), _DTYPE_CODES[x.dtype], b, c,
        x.numel() // (b * c), groups, _PATH_CODES[plan.path], plan.vec, plan.param,
        plan.chunk, float(eps), int(silu), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "group_norm")
    launches += 1
    path_launches[plan.path] += 1
    return y
