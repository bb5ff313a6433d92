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

Training: where autograd needs the result's gradient, `flash_attention`
goes through `FlashAttentionFunction`. Its forward is the kernel (or the
plain version on the CPU); its backward is `attention_backward`, the JAX
package's own custom-VJP math (`_flash_vjp_bwd`: `_bwd_dense` up to
`BWD_DENSE_MAX_ELEMENTS` logits per head, `_bwd_streaming` over query blocks
of `BWD_BLOCK_Q` above), written in PyTorch in this layout. That backward is
XLA code in the JAX package, not a Pallas kernel, so its port is PyTorch
matrix products too. It saves the q, k, v views it was given, not copies.
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


# Above this many logits per (batch, head), T x T, the backward streams
# query blocks instead of holding the whole T x T matrix (the JAX package's
# constants).
BWD_DENSE_MAX_ELEMENTS = 1024 * 1024
BWD_BLOCK_Q = 512


def _bwd_block(qf, kf, vf, gf, s):
    """One query block of the backward, all fp32 `[BH, dh, Tq|T]`: with
    A = softmax(s q^T k), dV = A^T g, dS = A * (g^T v - rowsum(A * g^T v)),
    dQ = s dS k, dK = s dS^T q. Returns (dq, dk, dv) of this block."""
    a = torch.softmax(torch.einsum("bdt,bds->bts", qf, kf) * s, dim=-1)
    dv = torch.einsum("bts,bdt->bds", a, gf)
    da = torch.einsum("bdt,bds->bts", gf, vf)
    ds = a * (da - (da * a).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bts,bds->bdt", ds, kf) * s
    dk = torch.einsum("bts,bdt->bds", ds, qf) * s
    return dq, dk, dv


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor):
    """(dq, dk, dv) of `flash_attention(q, k, v)` for the output gradient
    `g`, all `[BH, dh, T]`, in fp32 throughout with the combined scale
    1/sqrt(dh), cast to the inputs' dtype: one block when T^2 <=
    `BWD_DENSE_MAX_ELEMENTS` (`_bwd_dense`), else query blocks of
    `BWD_BLOCK_Q` with dK and dV summed over the blocks in order
    (`_bwd_streaming`)."""
    dh, t = q.shape[1], q.shape[2]
    s = 1.0 / math.sqrt(dh)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    if t * t <= BWD_DENSE_MAX_ELEMENTS:
        dq, dk, dv = _bwd_block(qf, kf, vf, gf, s)
    else:
        dq = torch.empty_like(qf)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        for start in range(0, t, BWD_BLOCK_Q):
            part = slice(start, start + BWD_BLOCK_Q)
            dq_i, dk_i, dv_i = _bwd_block(qf[:, :, part], kf, vf, gf[:, :, part], s)
            dq[:, :, part] = dq_i
            dk += dk_i
            dv += dv_i
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """`flash_attention` under autograd: the forward kernel (or plain
    version), then `attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _flash_attention_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return attention_backward(*ctx.saved_tensors, g)


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
    """softmax(qᵀk / sqrt(dh)) applied to v, `[BH, dh, T]` in and out;
    differentiable through `FlashAttentionFunction` where autograd records.
    While `torch.export` traces, the registered op `ccdm::flash_attention`
    stands in its place."""
    if torch.compiler.is_exporting():
        return torch.ops.ccdm.flash_attention(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v)
    return _flash_attention_forward(q, k, v)


def _flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """The forward alone: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
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
    with torch.cuda.device(q.device):  # launch on q's card, not the current one
        status = _build.library().ccdm_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], _PATH_CODES[path], bh, t, dh, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention")
    launches += 1
    path_launches[path] += 1
    return out


# The forward as a registered op for `torch.export` (see `ops/group_norm.py`):
# the plain version on CPU tensors, the kernel on CUDA tensors, both
# writing a contiguous `[BH, dh, T]`; the path, which reads the views'
# addresses, is chosen in the real implementation.
@torch.library.custom_op("ccdm::flash_attention", mutates_args=(), device_types="cpu")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return dense_attention(q, k, v)


@_flash_attention_op.register_kernel("cuda")
def _flash_attention_op_cuda(q, k, v):
    return _flash_attention_forward(q, k, v)


@_flash_attention_op.register_fake
def _flash_attention_op_fake(q, k, v):
    return q.new_empty(q.shape)
