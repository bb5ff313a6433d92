"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips when no CUDA device is present (decided inside
the fixture, never at import). The file imports no jax, so it runs on a
machine without it; there, skip the repository's jax-pinning conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import math

import pytest
import torch

from ccdm_tpu_torch.ops import flash_attention as fa
from ccdm_tpu_torch.ops import group_norm as gn

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    # fp32 comparisons must be fp32 products, not TF32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def bf16_within(out, ref, atol=3e-2):
    """|out - ref| <= atol, or one bf16 ulp of ref: both round an fp32 value
    to bf16, and where the two fp32 values straddle a rounding boundary they
    land one ulp apart (2^-5 = 0.031 at |y| in [4, 8))."""
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    return bool(((out - ref).abs() <= torch.maximum(torch.full_like(ref, atol), ulp)).all())


@pytest.mark.parametrize("shape,dtype,groups,silu", [
    ((4, 32, 64, 64), torch.bfloat16, 32, True),
    ((2, 64, 32, 32), torch.float32, 32, True),
    ((8, 256, 8, 8), torch.bfloat16, 32, False),
    ((3, 96, 13, 13), torch.float32, 32, False),   # H*W odd: scalar loads
    ((2, 16, 7, 5), torch.bfloat16, 8, True),
    ((2, 48, 16), torch.float32, 24, False),       # attention tokens [B, C, T]
])
def test_group_norm_kernel_matches_plain(cuda, shape, dtype, groups, silu):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3 + 1).to(dtype)
    w = torch.randn(shape[1], generator=cuda, device="cuda") + 1
    b = torch.randn(shape[1], generator=cuda, device="cuda")
    before = gn.launches
    out = gn.group_norm(x, w, b, groups, silu=silu)
    torch.cuda.synchronize()
    assert gn.launches == before + 1
    ref = gn.torch_group_norm(x, w, b, groups, silu=silu)
    assert out.dtype == dtype and out.shape == x.shape
    if dtype == torch.float32:
        # fp32 stats of the same values summed in another order: the bound
        # the CPU tests hold the plain path to against JAX
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    else:
        assert bf16_within(out.float(), ref.float())


@pytest.mark.parametrize("bh,t,dh,dtype", [
    (16, 256, 32, torch.float32),
    (8, 320, 64, torch.float32),    # ragged key and query tails
    (12, 70, 32, torch.float32),
    (2, 2048, 32, torch.float32),   # many K/V tiles
    (16, 256, 32, torch.bfloat16),
    (6, 64, 64, torch.bfloat16),
])
def test_attention_kernel_matches_plain(cuda, bh, t, dh, dtype):
    qkv = torch.randn(bh, 3 * dh, t, generator=cuda, device="cuda").to(dtype)
    q, k, v = qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.shape == (bh, dh, t) and out.is_contiguous()
    ref = fa.dense_attention(q, k, v)
    if dtype == torch.float32:
        # the JAX package's bound for its kernel against the dense path
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    else:
        truth = fa.dense_attention(q.float(), k.float(), v.float())
        err_kernel = (out.float() - truth).abs().max().item()
        err_plain = (ref.float() - truth).abs().max().item()
        assert err_kernel <= err_plain + 1e-3, (err_kernel, err_plain)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 16, 24, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(x, x, x)
    y = torch.randn(2, 8, 4, 4, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm(y, torch.ones(8, device="cuda"), torch.zeros(8, device="cuda"), 4)
    with pytest.raises(ValueError, match="groups"):
        z = torch.randn(2, 10, 4, device="cuda")
        gn.group_norm(z, torch.ones(10, device="cuda"), torch.zeros(10, device="cuda"), 4)


def test_unet_forward_on_card_matches_cpu(cuda):
    """A small fp32 UNet: kernels on the card against the plain path on the
    CPU, same weights and inputs. Convolutions sum in another order on each
    device, hence 1e-4 on softmax outputs."""
    from ccdm_tpu_torch.models.builder import build_model

    params = {"compute_dtype": "float32", "unet_openai": {
        "base_channels": 32, "image_size": 32, "channel_mult": [1, 2],
        "attention_resolutions": [1, 2], "num_head_channels": 32}}
    cpu = build_model(params, 2, 1, 32)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for p in cpu.unet.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    card = build_model(params, 2, 1, 32, device="cuda")
    card.unet.load_state_dict(cpu.unet.state_dict())
    gen = torch.Generator().manual_seed(2)
    xt = torch.nn.functional.one_hot(torch.randint(0, 2, (2, 32, 32), generator=gen), 2).float()
    cond = torch.randn(2, 32, 32, 1, generator=gen)
    t = torch.tensor([1, 180])
    with torch.no_grad():
        ref = cpu.unet(xt, cond, t)["diffusion_out"]
        out = card.unet(xt.cuda(), cond.cuda(), t.cuda())["diffusion_out"]
    assert math.isfinite(float(out.sum()))
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)
