"""Port parity: the GroupNorm(+SiLU) wrapper's plain path against the JAX
package's Pallas kernel (interpret mode) and its XLA reference.

On the CPU the wrapper runs `torch_group_norm`, the same function that
`chip_smoke.py` and `test_torch_kernels_gpu.py` hold the CUDA kernel
against on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.ops.group_norm import pallas_group_norm, xla_group_norm
from ccdm_tpu_torch.ops import group_norm as gn

torch.set_num_threads(2)


def _inputs(c, seed, shape=(2, 8, 8), dtype=np.float32):
    rng = np.random.default_rng(seed)
    b, h, w = shape
    x = (rng.standard_normal((b, h, w, c)) * 3 + 1).astype(dtype)
    scale = (rng.standard_normal(c) + 1).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    return x, scale, bias


def _port(x_nhwc, scale, bias, groups, silu, dtype=torch.float32):
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x_nhwc, -1, 1))).to(dtype)
    y = gn.group_norm(x, torch.from_numpy(scale), torch.from_numpy(bias), groups, silu=silu)
    return np.moveaxis(y.float().numpy(), 1, -1)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("c,groups", [(32, 32), (64, 32), (96, 32), (16, 8)])
def test_plain_path_matches_jax(c, groups, silu):
    x, scale, bias = _inputs(c, seed=c + groups)
    before = gn.launches
    ours = _port(x, scale, bias, groups, silu)
    assert gn.launches == before  # CPU tensors never reach the kernel
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups)
    pallas = np.asarray(pallas_group_norm(*args, silu=silu, interpret=True))
    xla = np.asarray(xla_group_norm(*args, silu=silu))
    # fp32 stats over 64..192 values of scale ~3: the tests of the Pallas
    # kernel hold it to flax at 2e-5, and the port is held to the same
    np.testing.assert_allclose(ours, pallas, atol=2e-5, rtol=0)
    np.testing.assert_allclose(ours, xla, atol=2e-5, rtol=0)


def test_plain_path_bf16():
    x, scale, bias = _inputs(32, seed=7, shape=(2, 16, 16))
    x_bf16 = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ours = _port(x_bf16, scale, bias, 32, True, dtype=torch.bfloat16)
    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias), 32)
    ref = np.asarray(pallas_group_norm(*args, silu=True, interpret=True), np.float32)
    # both compute in fp32 from the same bf16 input and round to bf16; the
    # bound is the one the JAX package holds its kernel to in bf16
    np.testing.assert_allclose(ours, ref, atol=3e-2, rtol=0)


def test_wrapper_rejects_unknown_devices():
    x = torch.empty(1, 4, 2, 2, device="meta")
    w = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gn.group_norm(x, w, w, 4)


def test_splits_cover_the_card():
    # flagship first decoder level, [128,64,128,128] bf16: 2 chunks of 16384
    # elements per (sample, group) slab, 8192 blocks
    assert gn._splits(128 * 32, 2 * 128 * 128, 2) == 2
    # a single small sample is spread over more blocks
    assert gn._splits(32, 64 * 64, 4) == 4
    assert gn._splits(1, 8, 4) == 1
