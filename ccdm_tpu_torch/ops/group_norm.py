"""Fused GroupNorm(+SiLU) (port of `ccdm_tpu/ops/group_norm.py`).

Layout: NCHW, or any `[B, C, *spatial]` — the UNet's layout inside. Stats
and the normalise run in fp32; the output has the input's dtype (fp32 or
bf16); `weight`/`bias` are fp32 `[C]`.

`group_norm` is the wrapper the model calls. On a CPU tensor it runs the
plain PyTorch version, `torch_group_norm`; on a CUDA tensor it launches the
hand-written kernel (`csrc/group_norm.cu`) or raises. `launches` counts the
wrapper's kernel launches, one per GroupNorm call on the card; each runs the
kernel's two CUDA launches, `gn_partial_stats` then `gn_apply`.
"""

from __future__ import annotations

import math

import torch

from ccdm_tpu_torch.ops import _build

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
_LOADS_PER_THREAD = 8     # 16-byte loads each thread makes per block and pass
_MIN_BLOCKS = 4 * 132     # a few blocks per H100 SM when B*G alone is too few


def torch_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU) with flax's numerics: fp32 stats,
    var = max(E[x²] - mean², 0), y = (x - mean) * (rsqrt(var + eps) * w) + b."""
    b, c = x.shape[:2]
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


def _splits(batch_groups: int, slab: int, itemsize: int) -> int:
    """Chunks per (sample, group) slab: enough that one block reads about
    `_THREADS * _LOADS_PER_THREAD` vectors, and enough blocks to fill the card."""
    vec = 16 // itemsize
    splits = math.ceil(slab / (_THREADS * vec * _LOADS_PER_THREAD))
    wanted = math.ceil(_MIN_BLOCKS / batch_groups)
    return max(1, splits, min(wanted, math.ceil(slab / (_THREADS * vec))))


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """GroupNorm over `[B, C, *spatial]` with an optional fused SiLU."""
    global launches
    if x.device.type == "cpu":
        return torch_group_norm(x, weight, bias, groups, eps, silu)
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
    hw = x.numel() // (b * c)
    splits = _splits(b * groups, (c // groups) * hw, x.element_size())
    y = torch.empty_like(x)
    partial = torch.empty(b * groups * splits * 2, dtype=torch.float32, device=x.device)
    status = _build.library().ccdm_group_norm(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        partial.data_ptr(), _DTYPE_CODES[x.dtype], b, c, hw, groups, splits,
        float(eps), int(silu), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "group_norm")
    launches += 1
    return y
