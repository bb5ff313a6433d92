"""Port parity: the attention wrapper's plain path against the JAX package's
Pallas flash attention (interpret mode) and its dense reference.

The JAX layout is `[B, T, H, dh]`; the port's is `[B*H, dh, T]` (the views
the UNet's qkv split gives). `_to_port` / `_from_port` convert.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.ops.flash_attention import dense_attention as jax_dense
from ccdm_tpu.ops.flash_attention import flash_attention as jax_flash
from ccdm_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)


def _to_port(x):
    b, t, h, dh = x.shape
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 2, 3, 1).reshape(b * h, dh, t)))


def _from_port(y, b, h):
    bh, dh, t = y.shape
    return y.float().numpy().reshape(b, h, dh, t).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("t", [256, 320])  # 320: ragged against 128-query blocks
def test_plain_path_matches_jax(t):
    b, h, dh = 2, 4, 32
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3))
    before = fa.launches
    ours = _from_port(fa.flash_attention(_to_port(q), _to_port(k), _to_port(v)), b, h)
    assert fa.launches == before  # CPU tensors never reach the kernel
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    # the JAX package holds its kernel to the dense path at 2e-5 in fp32
    np.testing.assert_allclose(
        ours, np.asarray(jax_flash(qj, kj, vj, block_q=128, interpret=True)),
        atol=2e-5, rtol=0)
    np.testing.assert_allclose(ours, np.asarray(jax_dense(qj, kj, vj)), atol=2e-5, rtol=0)


def test_plain_path_bf16_no_worse_than_dense():
    """bf16: the port is at least as close to the fp32 truth as the JAX
    dense bf16 path, with the JAX package's 1e-3 margin."""
    b, t, h, dh = 1, 128, 2, 32
    q = jax.random.normal(jax.random.PRNGKey(1), (b, t, h, dh), jnp.bfloat16)
    qf = q.astype(jnp.float32)
    truth = np.asarray(jax_dense(qf, qf, qf))
    qt = _to_port(np.asarray(qf)).to(torch.bfloat16)
    ours = _from_port(fa.flash_attention(qt, qt, qt), b, h)
    dense = np.asarray(jax_dense(q, q, q), np.float32)
    err_ours = np.abs(ours - truth).max()
    err_dense = np.abs(dense - truth).max()
    assert err_ours <= err_dense + 1e-3, (err_ours, err_dense)


def test_strided_qkv_views_match_contiguous():
    """The UNet hands over q, k, v as slices of one packed qkv tensor."""
    bh, dh, t = 6, 8, 40
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (bh, 3 * dh, t)).astype(np.float32))
    q, k, v = qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]
    strided = fa.flash_attention(q, k, v)
    dense = fa.dense_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(strided, dense, rtol=0, atol=0)


@pytest.mark.parametrize("t,dtype,path", [
    (256, torch.bfloat16, "mma"),
    (64, torch.bfloat16, "mma"),
    (2048, torch.bfloat16, "mma"),
    (70, torch.bfloat16, "mma_scalar"),   # rows 140 bytes apart: element loads
    (256, torch.float32, "simt"),
])
def test_path_for_packed_qkv_views(t, dtype, path):
    dh = 32
    qkv = torch.zeros(4, 3 * dh, t, dtype=dtype)
    assert fa._path(qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]) == path


def test_wrapper_rejects_unknown_devices():
    x = torch.empty(2, 32, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(x, x, x)
