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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_path_with_add_matches_jax(dtype):
    """`group_norm(h, ..., add=e)` is GroupNorm(h + e) with the sum in h's
    dtype, as the ResBlock's unfused `h + emb_out` computes it in JAX."""
    c, groups = 64, 32
    h, scale, bias = _inputs(c, seed=11, shape=(2, 8, 8))
    e = np.random.default_rng(12).standard_normal((2, c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    hj, ej = jnp.asarray(h, jdt), jnp.asarray(e, jdt)
    ref = np.asarray(xla_group_norm(hj + ej[:, None, None, :], jnp.asarray(scale),
                                    jnp.asarray(bias), groups, silu=True), np.float32)
    tdt = getattr(torch, dtype)
    ht = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(hj.astype(jnp.float32)), -1, 1))).to(tdt)
    et = torch.from_numpy(np.array(ej.astype(jnp.float32))).to(tdt)
    before = gn.launches
    y = gn.group_norm(ht, torch.from_numpy(scale), torch.from_numpy(bias), groups,
                      silu=True, add=et)
    assert gn.launches == before
    ours = np.moveaxis(y.float().numpy(), 1, -1)
    # the bounds of test_plain_path_matches_jax (fp32) and test_plain_path_bf16
    np.testing.assert_allclose(ours, ref, atol=2e-5 if dtype == "float32" else 3e-2, rtol=0)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("shape,dtype,plan", [
    # the flagship UNet's 66 GroupNorm sites at B = 8 images x 16 samples, by
    # (C, *spatial); attention pre-norms are [B, C, T]
    ((128, 96, 256), BF16, gn.Plan("S", 8, 4)),
    ((128, 128, 64), BF16, gn.Plan("S", 8, 1)),
    ((128, 64, 128, 128), BF16, gn.Plan("M", 8, 1, 32768)),
    ((128, 96, 64, 64), BF16, gn.Plan("M", 8, 1, 12288)),
    ((128, 160, 32, 32), BF16, gn.Plan("M", 8, 1, 5120)),
    ((128, 32, 128, 128), BF16, gn.Plan("M", 8, 1, 16384)),
    ((128, 128, 32, 32), BF16, gn.Plan("M", 8, 1, 4096)),
    ((128, 64, 64, 64), BF16, gn.Plan("M", 8, 1, 8192)),
    ((128, 32, 128, 128), F32, gn.Plan("M", 4, 1, 16384)),   # the fp32 head
    ((128, 224, 16, 16), BF16, gn.Plan("S", 8, 8)),
    ((128, 192, 16, 16), BF16, gn.Plan("S", 8, 8)),
    ((128, 96, 32, 32), BF16, gn.Plan("M", 8, 1, 3072)),
    ((128, 160, 16, 16), BF16, gn.Plan("S", 8, 8)),
    ((128, 32, 64, 64), BF16, gn.Plan("M", 8, 1, 4096)),
    ((128, 64, 32, 32), BF16, gn.Plan("S", 8, 8)),
    ((128, 256, 8, 8), BF16, gn.Plan("S", 8, 2)),
    ((128, 224, 8, 8), BF16, gn.Plan("S", 8, 2)),
    ((128, 96, 16, 16), BF16, gn.Plan("S", 8, 4)),
    ((128, 32, 32, 32), BF16, gn.Plan("S", 8, 4)),
    ((128, 64, 16, 16), BF16, gn.Plan("S", 8, 2)),
    ((128, 128, 8, 8), BF16, gn.Plan("S", 8, 1)),
    ((128, 96, 8, 8), BF16, gn.Plan("S", 8, 1)),
    # H*W = 169: no 16-byte vectors, element loads
    ((128, 96, 13, 13), F32, gn.Plan("M", 1, 1, 507)),
    ((128, 32, 13, 13), F32, gn.Plan("S", 1, 8)),
    # 256 and 512 KB slabs over clusters of 4 and 8 blocks
    ((16, 64, 256, 256), BF16, gn.Plan("M", 8, 4, 32768)),
    ((16, 64, 256, 512), BF16, gn.Plan("M", 8, 8, 32768)),
    # the Cityscapes torso's largest level (1 MB slabs) and fp32 head (2 MB):
    # beyond a cluster of 8 blocks of 64 KB
    ((16, 128, 256, 512), BF16, gn.Plan("L", 8, 32, 16384)),
    ((16, 128, 256, 512), F32, gn.Plan("L", 4, 64, 8192)),
])
def test_plan_per_shape(shape, dtype, plan):
    got = gn._plan(shape, dtype, 32)
    assert got == plan
    slab = shape[1] // 32 * int(np.prod(shape[2:]))
    if got.path == "S":
        assert got.param * 32 * got.vec >= slab and got.param <= gn._S_MAX_PACKS
    else:
        assert got.param * got.chunk >= slab and got.chunk % got.vec == 0
    if got.path == "M":
        assert got.chunk * dtype.itemsize <= gn._M_CHUNK_BYTES
        assert 1 <= got.param <= gn._M_MAX_CLUSTER
    # an address that is not 16-byte aligned takes element loads
    assert gn._plan(shape, dtype, 32, aligned=False).vec == 1


def test_splits_cover_the_card():
    # flagship first decoder level, [128,64,128,128] bf16: 2 chunks of 16384
    # elements per (sample, group) slab, 8192 blocks
    assert gn._splits(128 * 32, 2 * 128 * 128, 2) == 2
    # a single small sample is spread over more blocks
    assert gn._splits(32, 64 * 64, 4) == 4
    assert gn._splits(1, 8, 4) == 1


def _channels_last(x):
    return x.movedim(1, -1).contiguous().movedim(-1, 1)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,groups,add", [
    ((2, 64, 8, 8), 32, False),
    ((2, 96, 5, 7), 32, True),    # 3 channels a group
    ((3, 48, 16), 24, True),      # attention tokens [B, C, T]
])
def test_plain_path_on_channels_last_equals_it_on_the_nchw_copy(shape, groups, add, dtype):
    """A channels-last input gives the values of its NCHW copy, in its own
    layout (the strides `torch.empty_like` gives it)."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(shape, generator=gen) * 3 + 1).to(dtype)
    w, b = torch.randn(shape[1], generator=gen) + 1, torch.randn(shape[1], generator=gen)
    e = torch.randn(shape[:2], generator=gen).to(dtype) if add else None
    xc = _channels_last(x)
    assert gn.channels_last(xc) and not gn.channels_last(x)
    ours = gn.group_norm(xc, w, b, groups, silu=True, add=e)
    ref = gn.group_norm(x, w, b, groups, silu=True, add=e)
    assert ours.stride() == xc.stride() and ref.is_contiguous()
    assert torch.equal(ours, ref)


def test_the_autograd_path_refuses_a_channels_last_input():
    """K2's backward takes NCHW only: a channels-last x that autograd would
    record raises instead of computing."""
    x = _channels_last(torch.randn(2, 64, 4, 4)).requires_grad_()
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="autograd path takes contiguous"):
        gn.group_norm(x, w, b, 32)
    with torch.no_grad():  # nothing records: the forward alone takes it
        assert gn.group_norm(x, w, b, 32).stride() == x.stride()


H100_SMEM_PER_SM = 228 * 1024  # of which each block reserves 1 KB


@pytest.mark.parametrize("shape,dtype,plan", [
    # channels-last, the flagship's sites at B = 8 x 16: a sample's pixels
    # over a tile of channels, in one block ...
    ((128, 96, 16, 16), BF16, gn.Plan("M", 8, 1, 256, "nhwc", 48)),       # two tiles a sample
    ((128, 96, 256), BF16, gn.Plan("M", 8, 1, 256, "nhwc", 48)),          # attention tokens
    ((128, 256, 8, 8), BF16, gn.Plan("M", 8, 1, 64, "nhwc", 128)),
    ((128, 128, 32, 32), BF16, gn.Plan("M", 8, 1, 1024, "nhwc", 32)),
    ((2, 512, 8, 16), BF16, gn.Plan("M", 8, 1, 128, "nhwc", 32)),         # few units: still one
    # ... in a cluster of blocks of 32 KB ...
    ((128, 32, 64, 64), BF16, gn.Plan("M", 8, 8, 512, "nhwc", 32)),       # rows whole pixels
    ((128, 160, 32, 32), BF16, gn.Plan("M", 8, 6, 171, "nhwc", 80)),      # 5 channels a group
    # ... or of blocks of 64 KB, up to 16 (the non-portable cluster size)
    ((128, 32, 128, 128), BF16, gn.Plan("M", 8, 16, 1024, "nhwc", 32)),
    ((128, 64, 128, 128), BF16, gn.Plan("M", 8, 16, 1024, "nhwc", 32)),   # two tiles a sample
    ((128, 32, 128, 128), F32, gn.Plan("M", 4, 16, 1024, "nhwc", 16)),    # the fp32 head
    ((128, 96, 64, 64), BF16, gn.Plan("M", 8, 7, 586, "nhwc", 48)),       # 3 channels a group
    # Cityscapes' at 2 x 1: the DINO concat (20 channels a group) and the
    # pre-norm at ds 8, and path L for its 8-64 MB samples
    ((2, 640, 32, 64), BF16, gn.Plan("M", 8, 6, 342, "nhwc", 40)),
    ((2, 256, 2048), BF16, gn.Plan("M", 8, 8, 256, "nhwc", 64)),
    ((2, 128, 256, 512), BF16, gn.Plan("L", 8, 8, 497, "nhwc", 128, 264, 497)),
    ((2, 256, 256, 512), BF16, gn.Plan("L", 8, 8, 497, "nhwc", 256, 264, 256)),
    ((2, 128, 256, 512), F32, gn.Plan("L", 4, 8, 497, "nhwc", 128, 264, 256)),
    ((2, 128, 128, 256), BF16, gn.Plan("M", 8, 16, 2048, "nhwc", 16)),     # 8 MB: 32-byte rows
    # 12 channels: no 16-byte vectors, element loads; a small unit in one
    # block
    ((3, 12, 5, 7), BF16, gn.Plan("M", 1, 1, 35, "nhwc", 12)),
])
def test_plan_nhwc_per_shape(shape, dtype, plan):
    groups = 4 if shape[1] == 12 else 32
    got = gn._plan(shape, dtype, groups, nhwc=True)
    assert got == plan
    b, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    cpg = c // groups
    # a tile is whole groups and whole vectors, no more vectors than threads
    assert c % got.tile == 0 and got.tile % cpg == 0 and got.tile % got.vec == 0
    assert got.tile // got.vec <= gn._THREADS and got.tile // cpg <= gn._MAX_TILE_GROUPS
    if got.path == "M":
        assert got.param * got.chunk >= hw > (got.param - 1) * got.chunk
        assert 1 <= got.param <= gn._MN_MAX_CLUSTER
        assert got.tile <= gn._MN_MAX_TILE and got.tile // got.vec <= 32
        # the rows, the warps' sums (2 x 8 warps x 128 floats): three blocks an SM
        smem = got.chunk * got.tile * dtype.itemsize + 2 * 8 * gn._MN_MAX_TILE * 4
        assert got.chunk * got.tile * dtype.itemsize <= gn._M_CHUNK_BYTES
        assert 3 * (smem + 1024) <= H100_SMEM_PER_SM
    else:
        assert got.splits % got.param == 0 and got.splits * got.chunk >= hw
        assert got.apply >= 1
    # the contiguous plan of the same shape is NCHW's, unchanged
    assert gn._plan(shape, dtype, groups).layout == "nchw"
    # an address that is not 16-byte aligned takes element loads
    assert gn._plan(shape, dtype, groups, aligned=False, nhwc=True).vec == 1
