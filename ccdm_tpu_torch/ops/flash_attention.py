"""Self-attention without a T x T tensor in device memory (port of
`ccdm_tpu/ops/flash_attention.py`, forward only).

Layout: q, k, v are `[BH, dh, T]` — batch*heads, head channels, tokens —
with unit stride along T. These are the views the UNet's legacy qkv split
gives (`qkv.reshape(B*heads, 3*dh, T)` sliced in three), so no transpose
runs before or after the kernel. The output is `[BH, dh, T]` contiguous,
i.e. `[B, C, T]` for the output projection. (The JAX package's layout is
`[B, T, H, dh]`; the tests transpose between the two.)

`flash_attention` is the wrapper the model calls. On CPU tensors it runs the
plain PyTorch version, `dense_attention`; on CUDA tensors it launches the
hand-written kernel (`csrc/flash_attention.cu`, dh 32 or 64) or raises.
`_path` picks the kernel's path: "mma" (bf16 on the tensor cores, 16-byte
async loads), "mma_scalar" (the same with element loads, for views whose
rows are not 16-byte aligned) or "simt" (fp32 on the FMA pipes).
`launches` counts the kernel launches, `path_launches` splits them by path.
"""

from __future__ import annotations

import math

import torch

from ccdm_tpu_torch.ops import _build

launches = 0
path_launches = {"mma": 0, "mma_scalar": 0, "simt": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"simt": 0, "mma": 1, "mma_scalar": 2}
_HEAD_DIMS = (32, 64)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with the JAX parity path's numerics: q and k each
    scaled by 1/dh^(1/4) in the input dtype, fp32 logits and softmax,
    probabilities cast to the input dtype, fp32 product with v."""
    dh = q.shape[1]
    scale = 1.0 / math.sqrt(math.sqrt(dh))
    logits = torch.einsum("bdt,bds->bts", (q * scale).float(), (k * scale).float())
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bts,bds->bdt", weights.float(), v.float()).to(q.dtype)


def _path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel's path for these views: the async loads move 8 tokens at a
    time, so they need T % 8 == 0 and 16-byte aligned rows."""
    if q.dtype == torch.float32:
        return "simt"
    t = q.shape[2]
    aligned = t % 8 == 0 and all(
        x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0
        for x in (q, k, v))
    return "mma" if aligned else "mma_scalar"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(qᵀk / sqrt(dh)) applied to v, `[BH, dh, T]` in and out."""
    global launches
    if q.device.type == "cpu":
        return dense_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"flash_attention: {name} must match q's device, dtype and "
                             f"shape {tuple(q.shape)}, got {x.device} {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.dim() != 3 or x.stride(2) != 1:
            raise ValueError(f"flash_attention: {name} must be [BH, dh, T] with unit "
                             f"stride along T, got strides {x.stride()}")
    bh, dh, t = q.shape
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {_HEAD_DIMS}")
    if bh == 0 or t == 0:
        raise ValueError(f"flash_attention: empty input {tuple(q.shape)}")
    path = _path(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    scale = (1.0 / math.sqrt(math.sqrt(dh))) ** 2  # the TPU kernel's constant
    status = _build.library().ccdm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], _PATH_CODES[path], bh, t, dh, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention")
    launches += 1
    path_launches[path] += 1
    return out
