"""Port parity of the attention backward: the port's autograd Function (the
plain forward on the CPU, `attention_backward` behind it) against `jax.vjp`
of the JAX package's `flash_attention` with the Pallas kernel in interpret
mode, whose custom VJP is the math the port copies: dense at small T, the
query-block streaming branch at T = 1088 (two full blocks of 512 and a
padded tail of 64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.ops.flash_attention import BWD_BLOCK_Q, BWD_DENSE_MAX_ELEMENTS
from ccdm_tpu.ops.flash_attention import flash_attention as jax_flash
from ccdm_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)


def _to_port(x):
    """[B, T, H, dh] -> [B*H, dh, T]."""
    b, t, h, dh = x.shape
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))).reshape(
        b * h, dh, t)


def _from_port(x, b, h):
    bh, dh, t = x.shape
    return np.transpose(x.reshape(b, h, dh, t).numpy(), (0, 3, 1, 2))


@pytest.mark.parametrize("b,t,h,dh", [(2, 64, 3, 32), (1, 200, 2, 16), (1, 1088, 2, 32)])
def test_backward_matches_jax_vjp(b, t, h, dh):
    assert (t * t > BWD_DENSE_MAX_ELEMENTS) == (t == 1088)
    assert fa.BWD_DENSE_MAX_ELEMENTS == BWD_DENSE_MAX_ELEMENTS and fa.BWD_BLOCK_Q == BWD_BLOCK_Q
    rng = np.random.default_rng(t)
    q, k, v, g = (rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, None, True),
                       *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))

    qkv = torch.cat([_to_port(x) for x in (q, k, v)], dim=1).requires_grad_()
    ours = fa.flash_attention(qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:])
    assert ours.grad_fn.name() == "FlashAttentionFunctionBackward"
    np.testing.assert_allclose(_from_port(ours.detach(), b, h), np.asarray(out), atol=2e-5)
    ours.backward(_to_port(g))
    for i, name in enumerate(("dq", "dk", "dv")):
        got = _from_port(qkv.grad[:, i * dh:(i + 1) * dh], b, h)
        want = np.asarray(ref[i])
        # fp32 throughout on both sides; sums over T in other orders
        err = np.abs(got - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err, np.abs(want).max())


def test_backward_keeps_the_input_dtype_and_saves_views():
    qkv = torch.randn(4, 96, 64, dtype=torch.bfloat16, requires_grad=True)
    q, k, v = qkv[:, :32], qkv[:, 32:64], qkv[:, 64:]
    out = fa.flash_attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    assert all(s.data_ptr() == x.data_ptr() for s, x in zip(saved, (q, k, v)))
    out.float().sum().backward()
    assert qkv.grad.dtype == torch.bfloat16 and bool(torch.isfinite(qkv.grad).all())
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
