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
from ccdm_tpu_torch.ops import quant

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


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("shape,dtype,groups,silu,path", [
    ((4, 64, 32, 32), BF16, 32, True, "S"),      # 8 vectors a lane: S's limit
    ((2, 32, 32, 32), F32, 32, True, "S"),
    ((4, 32, 64, 64), BF16, 32, True, "M"),      # 16 vectors a lane: past S
    ((2, 64, 32, 32), F32, 32, True, "M"),
    ((8, 256, 8, 8), BF16, 32, False, "S"),
    ((3, 32, 13, 13), F32, 32, False, "S"),      # H*W = 169: element loads
    ((3, 96, 13, 13), F32, 32, False, "M"),
    ((2, 16, 7, 5), BF16, 8, True, "S"),
    ((2, 48, 16), F32, 24, False, "S"),          # attention tokens [B, C, T]
    ((4, 64, 128, 128), BF16, 32, True, "M"),    # the flagship's largest slab, cluster 1
    ((3, 32, 128, 128), F32, 32, True, "M"),     # the fp32 head, cluster 1
    ((2, 96, 13, 169), F32, 32, True, "M"),      # ragged, element loads into shared memory
    ((2, 64, 256, 256), BF16, 32, True, "M"),    # 256 KB slabs: a cluster of 4
    ((2, 64, 256, 512), BF16, 32, False, "M"),   # 512 KB slabs: a cluster of 8
    ((2, 128, 256, 512), BF16, 32, True, "L"),   # 1 MB slabs: two passes
    ((2, 128, 256, 512), F32, 32, True, "L"),    # 2 MB slabs
    # the Cityscapes sampler's sites (2 images x 1 vote, 256x512, base 128)
    ((2, 256, 256, 512), BF16, 32, True, "L"),   # level-0 skip concat, 2 MB slabs
    ((2, 384, 128, 256), BF16, 32, True, "L"),   # level-1 skip concat, 768 KB slabs
    ((2, 128, 128, 256), BF16, 32, True, "M"),   # level 1: a cluster of 4
    ((2, 640, 32, 64), BF16, 32, True, "M"),     # the DINO concat: 20 channels a group
    ((2, 768, 32, 64), BF16, 32, True, "M"),     # ds-8 skip concat: 24 channels a group
    ((2, 256, 2048), BF16, 32, False, "M"),      # attention pre-norm at ds 8: 16384-element slabs
    ((2, 512, 8, 16), BF16, 32, True, "S"),      # ds 32
])
def test_group_norm_kernel_matches_plain(cuda, shape, dtype, groups, silu, path, add):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3 + 1).to(dtype)
    w = torch.randn(shape[1], generator=cuda, device="cuda") + 1
    b = torch.randn(shape[1], generator=cuda, device="cuda")
    e = (torch.randn(shape[:2], generator=cuda, device="cuda").to(dtype) if add else None)
    assert gn._plan(shape, dtype, groups).path == path
    before, before_path = gn.launches, gn.path_launches[path]
    out = gn.group_norm(x, w, b, groups, silu=silu, add=e)
    torch.cuda.synchronize()
    assert gn.launches == before + 1 and gn.path_launches[path] == before_path + 1
    ref = gn.torch_group_norm(x, w, b, groups, silu=silu, add=e)
    assert out.dtype == dtype and out.shape == x.shape
    if dtype == torch.float32:
        # fp32 stats of the same values summed in another order: the bound
        # the CPU tests hold the plain path to against JAX
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    else:
        assert bf16_within(out.float(), ref.float())


def _channels_last(x):
    """x `[B, C, *spatial]` with its channels innermost in memory."""
    return x.movedim(1, -1).contiguous().movedim(-1, 1)


def _check_nhwc(x, w, b, groups, silu, e, path):
    """The channels-last kernel on x against the plain version: the path,
    the launch counts, the output's layout, the bound of
    `test_group_norm_kernel_matches_plain`, and the same bits again."""
    assert gn.channels_last(x)
    plan = gn._plan(x.shape, x.dtype, groups, aligned=x.data_ptr() % 16 == 0, nhwc=True)
    assert (plan.layout, plan.path) == ("nhwc", path)
    before = gn.launches, gn.path_launches[path], dict(gn.layout_launches)
    out = gn.group_norm(x, w, b, groups, silu=silu, add=e)
    torch.cuda.synchronize()
    assert (gn.launches, gn.path_launches[path]) == (before[0] + 1, before[1] + 1)
    assert gn.layout_launches == {"nchw": before[2]["nchw"], "nhwc": before[2]["nhwc"] + 1}
    ref = gn.torch_group_norm(x, w, b, groups, silu=silu, add=e)
    assert out.dtype == x.dtype and out.shape == x.shape and out.stride() == x.stride()
    if x.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    else:
        assert bf16_within(out.float(), ref.float())
    assert torch.equal(out, gn.group_norm(x, w, b, groups, silu=silu, add=e))


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("shape,dtype,groups,silu,path", [
    ((4, 32, 64, 64), BF16, 32, True, "M"),       # 1 channel a group
    ((4, 64, 128, 128), BF16, 32, True, "M"),     # the flagship's largest: 2 a group
    ((4, 32, 128, 128), F32, 32, True, "M"),      # the fp32 head: tiles of 16 channels
    ((8, 96, 16, 16), BF16, 32, True, "M"),       # 3 a group: vectors span two groups
    ((8, 96, 256), BF16, 32, False, "M"),         # attention tokens [B, C, T], 3 a group
    ((4, 128, 32, 32), BF16, 32, True, "M"),      # 4
    ((4, 160, 16, 16), BF16, 32, True, "M"),      # 5
    ((4, 192, 16, 16), F32, 32, True, "M"),       # 6
    ((4, 224, 8, 8), BF16, 32, True, "M"),        # 7
    ((2, 256, 2048), BF16, 32, False, "M"),       # 8: the Cityscapes pre-norm at ds 8
    ((2, 384, 128, 256), BF16, 32, True, "L"),    # 12: the level-1 skip concat
    ((2, 512, 8, 16), BF16, 32, True, "M"),       # 16: ds 32
    ((2, 640, 32, 64), BF16, 32, True, "M"),      # 20: the DINO concat
    ((2, 768, 32, 64), BF16, 32, True, "M"),      # 24: the ds-8 skip concat
    ((2, 1024, 8, 16), BF16, 32, True, "M"),      # 32: 1024 channels
    ((2, 128, 128, 256), BF16, 32, True, "M"),    # Cityscapes level 1: 8 MB, 32-byte rows
    ((2, 128, 256, 512), BF16, 32, True, "L"),    # Cityscapes level 0
    ((2, 256, 256, 512), BF16, 32, True, "L"),    # its skip concat
    ((2, 128, 256, 512), F32, 32, True, "L"),     # its fp32 head
    ((3, 12, 5, 7), BF16, 4, True, "M"),          # 12 channels: element loads
    ((3, 30, 9, 9), F32, 10, False, "M"),         # 30 channels: element loads
    ((2, 36, 300, 300), BF16, 12, True, "L"),     # path L in element loads
])
def test_group_norm_nhwc_kernel_matches_plain(cuda, shape, dtype, groups, silu, path, add):
    x = _channels_last((torch.randn(shape, generator=cuda, device="cuda") * 3 + 1).to(dtype))
    w = torch.randn(shape[1], generator=cuda, device="cuda") + 1
    b = torch.randn(shape[1], generator=cuda, device="cuda")
    e = torch.randn(shape[:2], generator=cuda, device="cuda").to(dtype) if add else None
    _check_nhwc(x, w, b, groups, silu, e, path)


def test_group_norm_nhwc_misaligned_input_takes_element_loads(cuda):
    """A channels-last view 2 bytes into its storage cannot take 16-byte loads."""
    base = torch.randn(2 * 64 * 16 * 16 + 1, generator=cuda, device="cuda").to(BF16)
    x = base[1:].view(2, 16, 16, 64).permute(0, 3, 1, 2)
    assert x.data_ptr() % 16 and gn._plan(x.shape, BF16, 32, False, nhwc=True).vec == 1
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    _check_nhwc(x, w, b, 32, True, None, "M")


def _inference_sites(params, classes, channels, hw, features, batch):
    """(shape at `batch`, dtype, groups, SiLU, has the add, channels-last)
    -> GroupNorm calls of one inference forward of the config's UNet, from
    hooks on a batch-1 forward on the card."""
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.models.layers import GroupNorm32

    model = build_model(params, classes, channels, min(hw), device="cuda")
    model.unet.lay_out_weights(True)  # as the samplers lay it out
    calls = {}

    def on_norm(mod, args, kwargs):
        add = kwargs.get("add", args[2] if len(args) > 2 else None)
        silu = kwargs.get("silu", args[1] if len(args) > 1 else False)
        key = ((batch, *args[0].shape[1:]), args[0].dtype, mod.groups, bool(silu),
               add is not None, gn.channels_last(args[0]))
        calls[key] = calls.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(on_norm, with_kwargs=True)
             for m in model.unet.modules() if isinstance(m, GroupNorm32)]
    feats = (torch.zeros(1, hw[0] // 8, hw[1] // 8, features, device="cuda")
             if features else None)
    with torch.inference_mode():
        model.unet(torch.zeros(1, *hw, classes, device="cuda"),
                   torch.zeros(1, *hw, channels, device="cuda"),
                   torch.tensor([5], device="cuda"), feats)
    for h in hooks:
        h.remove()
    return calls


def _site_configs():
    from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS, FLAGSHIP_PARAMS

    return {"flagship": (FLAGSHIP_PARAMS, 2, 1, (128, 128), 0, 128),
            "cityscapes": (CITYSCAPES_EVAL_PARAMS, 20, 3, (256, 512), 384, 2)}


@pytest.mark.parametrize("config", ["flagship", "cityscapes"])
def test_group_norm_nhwc_kernel_matches_plain_at_every_inference_site(cuda, config):
    """Every GroupNorm site of the config's inference forward at the
    benchmark's batch (flagship 8 x 16, Cityscapes 2 x 1), channels-last,
    in bf16 and fp32, with and without SiLU and the add."""
    params, classes, channels, hw, features, batch = _site_configs()[config]
    sites = _inference_sites(params, classes, channels, hw, features, batch)
    assert sum(sites.values()) == {"flagship": 66, "cityscapes": 81}[config]
    shapes = sorted({(k[0], k[2]) for k in sites if k[5]})
    assert shapes
    for shape, groups in shapes:
        c = shape[1]
        for dtype in (BF16, F32):
            x = _channels_last(
                (torch.randn(shape, generator=cuda, device="cuda") * 3 + 1).to(dtype))
            w = torch.randn(c, generator=cuda, device="cuda") + 1
            b = torch.randn(c, generator=cuda, device="cuda")
            path = gn._plan(shape, dtype, groups, nhwc=True).path
            for silu, add in ((False, False), (True, True)):
                e = torch.randn(shape[:2], generator=cuda, device="cuda").to(dtype) if add else None
                _check_nhwc(x, w, b, groups, silu, e, path)
            del x


def _close_to_max(out, ref, rel):
    """|out - ref| <= rel x the largest |ref| of the tensor."""
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rel * ref.float().abs().max().item(), (err, ref.float().abs().max().item())


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("shape,dtype,silu,path", [
    ((16, 256, 8, 8), BF16, True, "S"),       # the 8x8 decoder concat
    ((16, 96, 16, 16), BF16, True, "S"),      # 3 channels a group
    ((16, 128, 4, 8), BF16, True, "S"),       # ds 32 of the Cityscapes trainer: H*W = 32
    ((16, 64, 32, 64), BF16, True, "S"),      # a team of 8 warps
    ((16, 448, 16, 32), BF16, True, "M"),     # the DINO concat: 14 channels a block
    ((16, 64, 128, 128), BF16, True, "M"),    # the flagship's largest slab: a cluster of 4
    ((16, 32, 128, 128), F32, True, "M"),     # the flagship's fp32 head: a cluster of 4
    ((16, 128, 256), BF16, False, "S"),       # an attention pre-norm [B, C, T]
    ((3, 32, 13, 13), F32, True, "S"),        # H*W = 169: element loads in registers
    ((3, 96, 13, 13), F32, True, "S"),        # the same, 3 channels a group
    ((2, 96, 39, 39), F32, True, "M"),        # H*W = 1521: element loads into shared memory
    ((16, 3840, 5, 13), BF16, True, "M"),     # H*W = 65: two tiles a channel, 121 a block
    ((2, 64000, 5, 13), BF16, True, "L"),     # the same on path L
    ((16, 768, 4, 8), BF16, True, "M"),       # 24 channels a group: a cluster of 1
    ((4, 96, 96, 96), BF16, True, "M"),       # a cluster of 4, its boundaries inside channels
    ((16, 32, 128, 256), F32, True, "M"),     # the Cityscapes fp32 head: a cluster of 8
    ((16, 64, 128, 256), BF16, True, "M"),    # the Cityscapes level-0 concat: a cluster of 8
    ((2, 128, 256, 512), BF16, True, "L"),    # path L: 1 MB slabs
    ((2, 128, 256, 512), F32, False, "L"),    # path L: 2 MB slabs
])
def test_group_norm_backward_kernel_matches_plain(cuda, shape, dtype, silu, path, add):
    """dx and dadd in x's dtype, dweight and dbias fp32: fp32 sums of the
    same values in another order. fp32: within 1e-4 of each tensor's
    largest magnitude (the fp32 gradient bound of the train-step parity
    tests); bf16 outputs: within 1e-2 of it (a bf16 rounding of sums that
    differ in their last fp32 bits); dadd against the scale of the terms
    it sums."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3 + 1).to(dtype)
    dy = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    w = torch.randn(shape[1], generator=cuda, device="cuda") + 1
    b = torch.randn(shape[1], generator=cuda, device="cuda")
    e = torch.randn(shape[:2], generator=cuda, device="cuda").to(dtype) if add else None
    assert gn._plan_backward(shape, dtype, 32).path == path
    before_path = gn.path_launches_bwd[path]
    before = gn.launches_bwd
    out = gn.group_norm_backward(dy, x, w, b, 32, silu=silu, add=e)
    torch.cuda.synchronize()
    assert gn.launches_bwd == before + 1 and gn.path_launches_bwd[path] == before_path + 1
    ref = gn.torch_group_norm_backward(dy, x, w, b, 32, silu=silu, add=e)
    low = 1e-4 if dtype == F32 else 1e-2
    _close_to_max(out[0], ref[0], low)
    _close_to_max(out[1], ref[1], 1e-4)
    _close_to_max(out[2], ref[2], 1e-4)
    assert out[0].dtype == dtype and out[1].dtype == out[2].dtype == F32
    if add:
        # dadd sums dx over a channel's positions; with one channel a group it
        # is 0 in exact arithmetic, so its scale is that of the summed terms
        scale = ref[0].float().abs().reshape(*shape[:2], -1).sum(-1).max().item()
        err = (out[3].float() - ref[3].float()).abs().max().item()
        assert err <= low * scale, (err, scale)
    else:
        assert out[3] is None
    # fixed-order sums: a second run gives the same bits
    again = gn.group_norm_backward(dy, x, w, b, 32, silu=silu, add=e)
    for first, second in zip(out, again):
        if first is not None:
            assert torch.equal(first, second)


def test_group_norm_autograd_on_card_matches_cpu(cuda):
    """`group_norm` under autograd on the card (forward and backward
    kernels) against the same on the CPU (plain versions), fp32."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 64, 16, 16, generator=gen) * 2
    e = torch.randn(4, 64, generator=gen)
    w, b = torch.randn(64, generator=gen) + 1, torch.randn(64, generator=gen)
    dy = torch.randn(4, 64, 16, 16, generator=gen)
    grads = []
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev, copy=True).requires_grad_() for t in (x, w, b, e)]
        gn.group_norm(leaves[0], leaves[1], leaves[2], 32, silu=True, add=leaves[3]).backward(
            dy.to(dev))
        grads.append([t.grad.cpu() for t in leaves])
    for ours, ref in zip(grads[1], grads[0]):
        _close_to_max(ours, ref, 1e-4)


def test_attention_backward_on_card_matches_autograd(cuda):
    """The autograd Function (kernel forward, the JAX package's backward math)
    against autograd through the plain `dense_attention`, fp32."""
    qkv = torch.randn(8, 96, 256, generator=cuda, device="cuda")
    g = torch.randn(8, 32, 256, generator=cuda, device="cuda")
    grads = []
    for fn in (fa.flash_attention, fa.dense_attention):
        leaf = qkv.clone().requires_grad_()
        fn(leaf[:, :32], leaf[:, 32:64], leaf[:, 64:]).backward(g)
        grads.append(leaf.grad)
    _close_to_max(grads[0], grads[1], 1e-4)


def test_group_norm_misaligned_input_takes_element_loads(cuda):
    """A view that starts 2 bytes into its storage cannot take 16-byte loads."""
    base = torch.randn(2 * 32 * 64 + 1, generator=cuda, device="cuda").to(BF16)
    x = base[1:].view(2, 32, 8, 8)
    assert x.data_ptr() % 16 and gn._plan(x.shape, BF16, 32, aligned=False).vec == 1
    w, b = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    out = gn.group_norm(x, w, b, 32, silu=True)
    assert bf16_within(out.float(), gn.torch_group_norm(x, w, b, 32, silu=True).float())


@pytest.mark.parametrize("shape,path", [
    ((4, 64, 16, 16), "S"),
    ((16, 2688, 96), "M"),  # H*W = 96 in element loads: two tiles a channel
])
def test_group_norm_backward_misaligned_dy_takes_element_loads(cuda, shape, path):
    """A dy view that starts 2 bytes into its storage: the backward plans
    element loads and agrees with the plain version."""
    x = torch.randn(shape, generator=cuda, device="cuda").to(BF16)
    base = torch.randn(x.numel() + 1, generator=cuda, device="cuda").to(BF16)
    dy = base[1:].view(x.shape)
    plan = gn._plan_backward(x.shape, BF16, 32, aligned=False)
    assert dy.data_ptr() % 16 and plan.vec == 1 and plan.path == path
    c = shape[1]
    w, b = torch.randn(c, generator=cuda, device="cuda") + 1, torch.zeros(c, device="cuda")
    out = gn.group_norm_backward(dy, x, w, b, 32, silu=True)
    ref = gn.torch_group_norm_backward(dy, x, w, b, 32, silu=True)
    for ours, want in zip(out[:3], ref[:3]):
        _close_to_max(ours, want, 1e-2 if ours.dtype == BF16 else 1e-4)


@pytest.mark.parametrize("bh,t,dh,dtype", [
    (16, 256, 32, F32),
    (8, 320, 64, F32),    # ragged key and query tails
    (12, 70, 32, F32),
    (2, 2048, 32, F32),   # many K/V tiles
    *[(bh, t, dh, BF16) for t, bh in ((64, 24), (70, 12), (256, 16), (320, 8), (2048, 2))
      for dh in (32, 64)],
    # the Cityscapes sampler's sites: 2 images x 8, 16 and 16 heads
    (16, 2048, 32, BF16), (32, 512, 32, BF16), (32, 128, 32, BF16),
    (16, 128, 32, F32),   # the fp32 card-vs-CPU run at 64x128: ds 8
])
def test_attention_kernel_matches_plain(cuda, bh, t, dh, dtype):
    # the model's layout: q, k, v are views of one packed [BH, 3*dh, T]
    qkv = torch.randn(bh, 3 * dh, t, generator=cuda, device="cuda").to(dtype)
    q, k, v = qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]
    path = fa._path(q, k, v)
    assert path == ("simt" if dtype == F32 else "mma" if t % 8 == 0 else "mma_scalar")
    before, before_path = fa.launches, fa.path_launches[path]
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and fa.path_launches[path] == before_path + 1
    assert out.shape == (bh, dh, t) and out.is_contiguous()
    _check_attention(out, q, k, v)


def _check_attention(out, q, k, v):
    ref = fa.dense_attention(q, k, v)
    if q.dtype == torch.float32:
        # the JAX package's bound for its kernel against the dense path
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    else:
        truth = fa.dense_attention(q.float(), k.float(), v.float())
        err_kernel = (out.float() - truth).abs().max().item()
        err_plain = (ref.float() - truth).abs().max().item()
        assert err_kernel <= err_plain + 1e-3, (err_kernel, err_plain)


def test_attention_misaligned_view_takes_element_loads(cuda):
    """q, k, v that start 2 bytes past a 16-byte boundary, T % 8 == 0."""
    bh, dh, t = 6, 32, 128
    base = torch.randn(bh * 3 * dh * t + 1, generator=cuda, device="cuda").to(BF16)
    qkv = base[1:].view(bh, 3 * dh, t)
    q, k, v = qkv[:, :dh], qkv[:, dh:2 * dh], qkv[:, 2 * dh:]
    assert fa._path(q, k, v) == "mma_scalar"
    _check_attention(fa.flash_attention(q, k, v), q, k, v)


@pytest.mark.parametrize("bh,t,dh", [(3, 64, 32), (2, 192, 64), (2, 136, 32)])
def test_attention_qk_fragments_match_einsum(cuda, bh, t, dh):
    """The tensor-core fragment mapping alone: the kernel's tiles and
    ldmatrix/mma fragments give q^T k as torch.einsum does (fp32 sums of bf16
    products, in another order: 1e-4 relative to |logit| <= ~30)."""
    from ccdm_tpu_torch.ops import _build

    qkv = torch.randn(bh, 3 * dh, t, generator=cuda, device="cuda").to(BF16)
    q, k = qkv[:, :dh], qkv[:, dh:2 * dh]
    out = torch.full((bh, t, t), float("nan"), device="cuda")
    status = _build.library().ccdm_attention_logits(
        q.data_ptr(), k.data_ptr(), out.data_ptr(), bh, t, dh, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), torch.cuda.current_stream().cuda_stream)
    _build.check(status, "attention_logits")
    torch.cuda.synchronize()
    ref = torch.einsum("bdt,bds->bts", q.float(), k.float())
    torch.testing.assert_close(out, ref, atol=1e-4 * float(ref.abs().max()), rtol=0)


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
    cpu = build_model(params, 2, 1, 32, device="cpu")
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


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("b,cin,h,w,cout,k,stride", [
    (2, 3, 128, 128, 32, 3, 1),     # the flagship in_conv: K = 27
    (2, 23, 64, 128, 128, 3, 1),    # the Cityscapes in_conv: K = 207
    (2, 32, 64, 64, 32, 3, 2),      # a Downsample
    (2, 64, 32, 32, 96, 1, 1),      # a 1x1 skip
    (2, 640, 32, 64, 256, 3, 1),    # the DINO concat's in_conv: 20 chunks of 32 channels
    (3, 40, 13, 21, 20, 3, 1),      # ragged H, W, Cin and Cout
    (2, 32, 13, 17, 48, 3, 2),      # stride 2 on odd H and W
    (2, 64, 7, 5, 64, 3, 1),        # W < 8: an 8 x 8 tile, mostly masked
    (1, 32, 16, 16, 100, 1, 1),     # Cout past one 64-channel block, ragged
    # the ring path (output rows of 32 pixels and up)
    (2, 32, 37, 77, 48, 3, 1),      # ragged H and W: element loads, a second column tile
    (2, 32, 40, 64, 40, 3, 1),      # 16-byte loads, ragged Cout, strips of ragged length
    (1, 3, 96, 160, 32, 3, 1),      # K = 27 on 128-pixel tiles, the second one ragged
    (2, 128, 32, 256, 128, 3, 1),   # 128 output channels a block (the Cityscapes level 0)
    (2, 64, 64, 128, 32, 3, 2),     # stride 2: even and odd columns apart in the ring
    (2, 32, 33, 67, 40, 3, 2),      # stride 2 on odd H and W, element loads
    (2, 256, 40, 64, 64, 1, 1),     # a 1x1 on the ring
    # the tile path with K split over blocks (int32 atomics, then the epilogue)
    (2, 512, 8, 16, 512, 3, 1),     # the deep Cityscapes site: 16 ranges of 32 channels
    (2, 1024, 4, 8, 512, 1, 1),     # a deep 1x1
])
def test_quant_conv_kernel_equals_plain(cuda, dtype, static, b, cin, h, w, cout, k, stride):
    """Exact integer products: the kernel equals its plain version bit for
    bit, and a second call the first; the launch goes down the planned path."""
    x = (torch.randn(b, cin, h, w, generator=cuda, device="cuda") * 2).to(dtype)
    weight = torch.randn(cout, cin, k, k, generator=cuda, device="cuda") * 0.1
    bias = torch.randn(cout, generator=cuda, device="cuda") * 0.1
    w_q, s_w = quant.weight_codes(weight)
    # a calibrated scale below the input's absmax saturates codes at +-127
    s_x = (quant.static_act_scale(x.abs().amax() * 0.7) if static
           else quant.dynamic_act_scale(x))
    before, paths = quant.launches, dict(quant.path_launches)
    out = quant.quant_conv(x, w_q, s_w, bias, s_x, k, stride, (k - 1) // 2)
    torch.cuda.synchronize()
    assert quant.launches == before + 1 and out.dtype == dtype
    path = quant._plan_conv(x.shape, cout, k, stride, dtype).path
    assert quant.path_launches[path] == paths[path] + 1
    ref = quant.quant_conv_plain(x, w_q, s_w, bias, s_x, k, stride, (k - 1) // 2)
    assert out.shape == ref.shape
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())
    assert torch.equal(quant.quant_conv(x, w_q, s_w, bias, s_x, k, stride, (k - 1) // 2), out)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_quant_conv_ring_on_a_view_off_16_bytes(cuda, dtype, k, stride):
    """x 2 or 4 bytes past a 16-byte boundary: the ring loads elements, and
    still equals the plain version bit for bit."""
    b, cin, h, w, cout = 2, 32, 36, 64, 32
    storage = (torch.randn(b * cin * h * w + 1, generator=cuda, device="cuda") * 2).to(dtype)
    x = storage[1:].view(b, cin, h, w)
    assert x.data_ptr() % 16 and quant._plan_conv(x.shape, cout, k, stride, dtype,
                                                  aligned=False).path == "ring"
    w_q, s_w = quant.weight_codes(torch.randn(cout, cin, k, k, generator=cuda,
                                              device="cuda") * 0.1)
    bias = torch.randn(cout, generator=cuda, device="cuda") * 0.1
    s_x = quant.dynamic_act_scale(x)
    out = quant.quant_conv(x, w_q, s_w, bias, s_x, k, stride, (k - 1) // 2)
    ref = quant.quant_conv_plain(x, w_q, s_w, bias, s_x, k, stride, (k - 1) // 2)
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())


def test_scales_and_weight_codes_on_the_card_equal_the_cpus(cuda):
    """The scales' divisions by 127 round once on the card too (PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, an ulp
    off the JAX package's scale for many values): static and dynamic
    scales, the weight scales and the weight codes equal the CPU's."""
    absmax = torch.rand(4096, generator=cuda, device="cuda") * 10
    assert torch.equal(quant.static_act_scale(absmax).cpu(),
                       quant.static_act_scale(absmax.cpu()))
    for i in range(64):
        x = (torch.randn(2, 8, 5, 5, generator=cuda, device="cuda") * (i + 1)).to(
            BF16 if i % 2 else F32)
        assert torch.equal(quant.dynamic_act_scale(x).cpu(), quant.dynamic_act_scale(x.cpu()))
    weight = torch.randn(512, 32, 3, 3, generator=cuda, device="cuda") * 0.1
    for ours, ref in zip(quant.weight_codes(weight), quant.weight_codes(weight.cpu())):
        assert torch.equal(ours.cpu(), ref)


def test_quant_conv_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 8, 6, 6, device="cuda")
    w_q, s_w = quant.weight_codes(torch.randn(4, 8, 3, 3, device="cuda"))
    bias, s_x = torch.zeros(4, device="cuda"), quant.dynamic_act_scale(x)
    with pytest.raises(ValueError, match="contiguous"):
        quant.quant_conv(x.transpose(2, 3), w_q, s_w, bias, s_x, 3, 1, 1)
    with pytest.raises(ValueError, match="kernel 5"):
        quant.quant_conv(x, w_q, s_w, bias, s_x, 5, 1, 2)
    with pytest.raises(ValueError, match="s_x"):
        quant.quant_conv(x, w_q, s_w, bias, s_x.cpu(), 3, 1, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant.quant_conv(x.half(), w_q, s_w, bias, s_x, 3, 1, 1)


def test_an_fp32_train_step_on_the_card_stays_fp32_under_pytorchs_tf32_default(cuda):
    """PyTorch runs cuDNN's fp32 convolutions in TF32 by default, and the
    LIDC gate's model trained that way lost 0.086 GED_16 (PERF.md). The
    train step turns TF32 off for its duration, so under the default an
    fp32 step's gradients on the card equal the CPU's within 1e-4 of each
    tensor's largest (TF32 in the output head's convolution moves them by
    ~1e-3); tensors whose gradient is rounding noise (under 1e-5 of the
    tree's largest) are held to 1e-6 of it."""
    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.train.optimizer import Optimizer
    from ccdm_tpu_torch.train.state import create_train_state, master_params
    from ccdm_tpu_torch.train.step import make_train_step

    params = dict(DEMO_TRAIN_PARAMS, compute_dtype="float32")
    cpu = build_model(params, 2, 1, 128, device="cpu")
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in cpu.unet.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    card = build_model(params, 2, 1, 128)
    card.unet.load_state_dict(cpu.unet.state_dict())
    b, hw = 2, 32
    batch = {"image": torch.randn(b, hw, hw, 1, generator=gen),
             "x0": torch.nn.functional.one_hot(torch.randint(0, 2, (b, hw, hw), generator=gen),
                                               2).float()}
    t = torch.tensor([3, 170])
    xt = torch.nn.functional.one_hot(torch.randint(0, 2, (b, hw, hw), generator=gen), 2).float()
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as the trainer runs
    results = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        state = create_train_state(master_params(model.unet), Optimizer("Adam", lambda s: 0.0))
        grads = {}
        state.apply_gradients = lambda g, grads=grads: grads.update(
            {k: v.float().cpu() for k, v in g.items()}) or 0.0
        m = make_train_step(model, torch.ones(2, device=dev))(
            state, model.unet, {k: v.to(dev) for k, v in batch.items()}, 0, t=t.to(dev),
            xt=xt.to(dev))
        results.append((float(m["loss"]), grads))
    assert torch.backends.cudnn.allow_tf32  # restored after the step
    (ref_loss, ref), (loss, grads) = results
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    top = max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        diff = (grads[name] - g).abs()
        if name.endswith("qkv.bias"):  # the key rows' gradients are rounding noise
            keys = (torch.arange(g.numel()) // 32) % 3 == 1
            assert float(diff[keys].max()) <= 1e-6 * top, name
            diff, g = diff[~keys], g[~keys]
        err, peak = float(diff.max()), float(g.abs().max())
        if peak < 1e-5 * top:
            assert err <= 1e-6 * top, name
        else:
            assert err <= 1e-4 * peak, (name, err / peak)


def test_wrappers_launch_on_their_tensors_card(cuda):
    """Tensors on cuda:1 while the current device is 0: each wrapper (K1,
    K2's forward and backward, K3) launches on cuda:1, reads that card's
    attributes and streams, and agrees with its plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.set_device(0)
    x = torch.randn(4, 64, 32, 32, generator=gen, device=dev).to(BF16)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(BF16)
    w = torch.randn(64, generator=gen, device=dev) + 1
    b = torch.randn(64, generator=gen, device=dev)
    e = torch.randn(4, 64, generator=gen, device=dev).to(BF16)
    assert bf16_within(gn.group_norm(x, w, b, 32, silu=True, add=e).float(),
                       gn.torch_group_norm(x, w, b, 32, silu=True, add=e).float())
    out = gn.group_norm_backward(dy, x, w, b, 32, silu=True, add=e)
    ref = gn.torch_group_norm_backward(dy, x, w, b, 32, silu=True, add=e)
    for got, want, rel in zip(out[:3], ref[:3], (1e-2, 1e-4, 1e-4)):
        assert got.device == dev
        _close_to_max(got, want, rel)
    qkv = torch.randn(8, 96, 256, generator=gen, device=dev).to(BF16)
    q, k, v = qkv[:, :32], qkv[:, 32:64], qkv[:, 64:]
    attn = fa.flash_attention(q, k, v)
    assert attn.device == dev
    _check_attention(attn, q, k, v)
    xq = torch.randn(2, 64, 32, 32, generator=gen, device=dev).to(BF16)
    w_q, s_w = quant.weight_codes(torch.randn(96, 64, 3, 3, generator=gen, device=dev) * 0.1)
    bias = torch.randn(96, generator=gen, device=dev) * 0.1
    s_x = quant.dynamic_act_scale(xq)
    conv = quant.quant_conv(xq, w_q, s_w, bias, s_x, 3, 1, 1)
    assert conv.device == dev
    assert torch.equal(conv, quant.quant_conv_plain(xq, w_q, s_w, bias, s_x, 3, 1, 1))
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0


def test_registered_ops_launch_the_kernels_and_pass_opcheck(cuda):
    """The ops a served graph calls (`ccdm::*`): on CUDA tensors each
    launches its kernel (counted), bit for bit the eager wrapper's output,
    and its fake implementation matches the kernel's output metadata."""
    x = torch.randn(4, 64, 32, 32, generator=cuda, device="cuda").to(BF16)
    w = torch.rand(64, generator=cuda, device="cuda")
    b = torch.randn(64, generator=cuda, device="cuda")
    add = torch.randn(4, 64, generator=cuda, device="cuda").to(BF16)
    qkv = torch.randn(8, 96, 256, generator=cuda, device="cuda").to(BF16)
    q, k, v = qkv[:, :32], qkv[:, 32:64], qkv[:, 64:]
    w_q, s_w = quant.weight_codes(torch.randn(32, 64, 3, 3, generator=cuda, device="cuda"))
    s_x = quant.dynamic_act_scale(x)
    cases = [
        (gn, torch.ops.ccdm.group_norm.default, (x, w, b, add, 32, 1e-5, True),
         lambda: gn.group_norm(x, w, b, 32, 1e-5, True, add)),
        (fa, torch.ops.ccdm.flash_attention.default, (q, k, v),
         lambda: fa.flash_attention(q, k, v)),
        (quant, torch.ops.ccdm.quant_conv.default, (x, w_q, s_w, b[:32], s_x, 3, 2, 1),
         lambda: quant.quant_conv(x, w_q, s_w, b[:32], s_x, 3, 2, 1)),
    ]
    with torch.inference_mode():
        for module, op, args, wrapper in cases:
            before = module.launches
            out = op(*args)
            assert module.launches == before + 1
            assert torch.equal(out, wrapper()) and out.is_contiguous()
    for _, op, args, _ in cases:
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


def test_native_counts_build_on_the_cards_host(cuda, tmp_path, monkeypatch):
    """The confusion counts' library, built afresh by the card machine's own
    C++ compiler, counts two Cityscapes-size label maps as NumPy does."""
    import numpy as np

    from ccdm_tpu_torch import native

    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libccdm_native.so")
    monkeypatch.setattr(native, "_lib", None)
    rng = np.random.default_rng(0)
    gt, pred = (rng.integers(0, 34, (1024, 2048), dtype=np.uint8) for _ in range(2))
    cm = native.add_to_confusion_matrix(gt, pred, 256)
    assert (tmp_path / "libccdm_native.so").is_file()
    np.testing.assert_array_equal(cm, native.add_to_confusion_matrix_numpy(gt, pred, 256))


def test_dino_descriptors_on_the_card_equal_the_cpus(cuda):
    """Multi-layer key facets, log-binned descriptors and the saliency map of
    a small ViT on the card against the same calls on the CPU, fp32."""
    from ccdm_tpu_torch.models.dino import DinoFeatureEncoder

    enc = DinoFeatureEncoder({"model": "dino_vits8", "output_stride": 4, "source_layer": 2,
                              "vit_config": dict(embed_dim=96, depth=3, num_heads=6,
                                                 patch_size=8, pretrain_size=64)})
    cpu = enc.init(torch.Generator().manual_seed(1), device="cpu")
    card = enc.init(torch.Generator().manual_seed(1), device="cuda")
    images = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(2))
    for kwargs in ({"layers": [0, 2]}, {"log_bin": True}, {"resize_shape": (5, 7)}):
        ours = enc.extract_descriptors(card, images.cuda(), **kwargs)
        ref = enc.extract_descriptors(cpu, images, **kwargs)
        for o, r in zip(ours if isinstance(ours, list) else [ours],
                        ref if isinstance(ref, list) else [ref]):
            assert float((o.cpu() - r).abs().max()) <= 1e-4 * float(r.abs().max())
    sal = enc.extract_saliency_maps(card, images.cuda()).cpu()
    assert float((sal - enc.extract_saliency_maps(cpu, images)).abs().max()) <= 1e-4


def _graph_setup(seed: int = 3):
    """A bf16 UNet at smoke size (32x32, base 32, attention at ds 2 with
    32-channel heads) on the card, its fp32 masters, and 4 batches of 4."""
    from ccdm_tpu_torch import DEMO_TRAIN_PARAMS
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.train.state import master_params

    params = dict(DEMO_TRAIN_PARAMS, unet_openai=dict(
        DEMO_TRAIN_PARAMS["unet_openai"], channel_mult=[1, 2], attention_resolutions=[2]))
    model = build_model(params, 2, 1, 32, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [{"image": torch.randn(4, 32, 32, 1, generator=gen, device="cuda"),
                "x0": torch.nn.functional.one_hot(
                    torch.randint(0, 2, (4, 32, 32), generator=gen, device="cuda"), 2).float()}
               for _ in range(4)]
    return params, model, master_params(model.unet), batches


def _graph_run(params, model, masters, batches, graphed: bool):
    import copy

    from ccdm_tpu_torch.train.optimizer import build_optimizer
    from ccdm_tpu_torch.train.state import create_train_state
    from ccdm_tpu_torch.train.step import GraphedTrainStep, make_multi_step, make_train_step

    net = copy.deepcopy(model.unet)
    tx, schedule = build_optimizer(params, steps_per_epoch=100)
    state = create_train_state({k: v.clone() for k, v in masters.items()}, tx, 0.999)
    step = make_train_step(model, torch.ones(2, device="cuda"), schedule)
    if graphed:
        step = GraphedTrainStep(step)
    multi = make_multi_step(step)
    before = (gn.launches, gn.launches_bwd, fa.launches)
    metrics = [multi(state, net, batches[i:i + 2], 11) for i in (0, 2)]
    metrics.append(step(state, net, batches[0], 11))
    launches = tuple(a - b for a, b in zip((gn.launches, gn.launches_bwd, fa.launches), before))
    return step, state, net, metrics, launches


def test_graphed_train_step_is_bit_equal_to_the_eager_step(cuda):
    params, model, masters, batches = _graph_setup()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = _graph_run(params, model, masters, batches, graphed=False)
        graph = _graph_run(params, model, masters, batches, graphed=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    step = graph[0]
    assert (step.eager_steps, step.captures, step.replays) == (2, 1, 3)
    (_, e_state, e_net, e_metrics, e_launches), (_, g_state, g_net, g_metrics, g_launches) = \
        eager, graph
    # the wrappers count each replay's launches, and none at the capture
    assert g_launches == e_launches and e_launches[0] > 0
    assert g_state.step == e_state.step == 5
    assert g_state.opt_state["count"] == e_state.opt_state["count"] == 5
    for a, b in ((e_state.params, g_state.params), (e_state.ema_params, g_state.ema_params),
                 (e_state.opt_state["mu"], g_state.opt_state["mu"]),
                 (e_state.opt_state["nu"], g_state.opt_state["nu"]),
                 (dict(e_net.named_parameters()), dict(g_net.named_parameters()))):
        assert all(torch.equal(a[k], b[k]) for k in a)
    # each launch's metrics are its own, not overwritten by a later replay
    for a, b in zip(e_metrics, g_metrics):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k], k
    assert not torch.equal(g_metrics[1]["loss"], g_metrics[2]["loss"])


def test_a_capture_that_meets_a_host_sync_raises(cuda):
    from ccdm_tpu_torch.train.step import capture_graph

    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA graph capture of the probe failed"):
        capture_graph(lambda: float(x.sum()), torch.cuda.Stream(),
                      torch.cuda.graph_pool_handle(), [], "the probe")
    assert float(x.sum()) == 4  # the card still works


def test_a_capture_survives_a_dead_cycle_that_holds_a_graph(cuda):
    import gc

    from ccdm_tpu_torch.train.step import capture_graph

    x = torch.ones(4, device="cuda")
    stream = torch.cuda.Stream()
    old, _ = capture_graph(lambda: x * 2, stream, torch.cuda.graph_pool_handle(), [], "the old")
    holder = [old]
    del old

    def work():
        # the old graph's last reference into a young cycle, unreachable at
        # once: a collection, were the collector on, would free it here
        cycle = [holder.pop()]
        cycle.append(cycle)
        del cycle
        return [[x + i] for i in range(64)][-1][0] * 3

    threshold = gc.get_threshold()
    gc.set_threshold(1)  # a young collection at every allocation
    try:
        graph, y = capture_graph(work, stream, torch.cuda.graph_pool_handle(), [], "the new")
    finally:
        gc.set_threshold(*threshold)
    assert gc.isenabled()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 192.0))


def test_the_graphs_group_norm_counter_is_its_own_and_zero_after_a_replay(cuda):
    params, model, masters, batches = _graph_setup(seed=4)
    step, state, net, *_ = _graph_run(params, model, masters, batches, graphed=True)
    device = torch.device("cuda", torch.cuda.current_device())
    # the graph's counter: its capture stream's, which no launch outside it uses
    counter = gn._counters[device.index, step.stream.cuda_stream]
    assert counter.data_ptr() != gn._counter(device, torch.cuda.current_stream()).data_ptr()
    x = batches[1]["image"].permute(0, 3, 1, 2).repeat(1, 32, 1, 1).contiguous()
    x.requires_grad_()
    other = torch.cuda.Stream()
    other.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(other):  # a replay on a stream other than the capture's
        step(state, net, batches[1], 11)
    # meanwhile an eager GroupNorm backward on the current stream
    gn.group_norm(x, torch.ones(32, device="cuda"), torch.zeros(32, device="cuda"),
                  32).sum().backward()
    torch.cuda.synchronize()
    assert step.replays == 4 and int(counter.item()) == 0
    assert all(int(c.item()) == 0 for c in gn._counters.values())


@pytest.mark.parametrize("kind", ["Adam", "AdamW", "SGD"])
def test_the_optimizers_device_scalars_keep_the_host_scalar_updates_bits(cuda, kind):
    """The update with device scalars (what a CUDA graph replays) against
    the same update with the learning rate and bias corrections as host
    scalars, the op sequence the port ran before its step was a graph: bit
    for bit on the card, over 5 updates."""
    from ccdm_tpu_torch.train.optimizer import Optimizer

    shapes = [(64, 32, 3, 3), (32,), (256, 96), (7,)]
    p0 = {str(i): torch.randn(s, generator=cuda, device="cuda") * 0.05
          for i, s in enumerate(shapes)}
    grads = [{k: torch.randn(v.shape, generator=cuda, device="cuda") * 10.0 ** -e
              for k, v in p0.items()} for e in range(1, 6)]
    tx = Optimizer(kind, lambda c: 1e-4 * (1 - c / 1000), weight_decay=0.01)
    ours = {k: v.clone() for k, v in p0.items()}
    state = tx.init(ours)
    ref = {k: v.clone() for k, v in p0.items()}
    moments = tx.init(ref)
    for count, g in enumerate(grads):
        tx.update(g, state, ours)
        names = list(ref)
        p, gl = [ref[k] for k in names], [g[k] for k in names]
        lr = tx.schedule(count)
        if kind == "SGD":
            trace = [moments["trace"][k] for k in names]
            gl = torch._foreach_add(gl, p, alpha=tx.weight_decay)
            torch._foreach_mul_(trace, tx.momentum)
            torch._foreach_add_(trace, gl)
            torch._foreach_add_(p, trace, alpha=-lr)
            continue
        mu, nu = [moments["mu"][k] for k in names], [moments["nu"][k] for k in names]
        torch._foreach_mul_(mu, tx.b1)
        torch._foreach_add_(mu, gl, alpha=1.0 - tx.b1)
        torch._foreach_mul_(nu, tx.b2)
        torch._foreach_addcmul_(nu, gl, gl, value=1.0 - tx.b2)
        denom = torch._foreach_div(nu, 1.0 - tx.b2 ** (count + 1))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, tx.eps)
        step = torch._foreach_div(mu, 1.0 - tx.b1 ** (count + 1))
        torch._foreach_div_(step, denom)
        if kind == "AdamW":
            torch._foreach_add_(step, p, alpha=tx.weight_decay)
        torch._foreach_add_(p, step, alpha=-lr)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)


# the graphed sampler (diffusion/sampling.GraphedSampler) against its eager
# loop, under cuDNN's deterministic algorithms: bit for bit
SAMPLER_T = 8


def _sampler_model(c: int, seed: int, **params):
    """A bf16 UNet at smoke size (32x32, base 32, attention at ds 2 with
    32-channel heads, T 8) on the card, its zero leaves redrawn."""
    from ccdm_tpu_torch import FLAGSHIP_PARAMS
    from ccdm_tpu_torch.models.builder import build_model

    p = dict(FLAGSHIP_PARAMS, time_steps=SAMPLER_T, step_T_sample="confidence", **params,
             unet_openai=dict(FLAGSHIP_PARAMS["unet_openai"], channel_mult=[1, 2],
                              attention_resolutions=[2]))
    model = build_model(p, c, 1, 32, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for q in model.unet.parameters():
            if not q.any():
                q.copy_(torch.randn(q.shape, generator=gen) * 0.05)
    return model


def _sampler_images(b: int, seed: int = 1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(b, 32, 32, 1, generator=gen, device="cuda")


def _launches():
    return (gn.launches, fa.launches, quant.launches, dict(gn.path_launches),
            dict(quant.path_launches), dict(gn.layout_launches))


def _sampled(run, net, images, key: int = 3):
    """`run`'s maps and the launches the wrappers counted for them."""
    before = _launches()
    out = run(net, images, key)
    torch.cuda.synchronize()
    after = _launches()
    counted = tuple(a - b for a, b in zip(after[:3], before[:3])) + tuple(
        {k: a[k] - b[k] for k in a} for a, b in zip(after[3:], before[3:]))
    return out, counted


@pytest.fixture
def deterministic(cuda):
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("c,reuse", [(2, 1), (2, 3), (9, 1), (9, 3)],
                         ids=["onehot", "onehot-r3", "index", "index-r3"])
def test_graphed_sampler_is_bit_equal_to_the_eager_loop(deterministic, c, reuse):
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler

    model = _sampler_model(c, seed=c + reuse)
    images = _sampler_images(2)
    eager = make_prob_sampler(model, 4, encoder_reuse=reuse, graphs=False)
    graphed = make_prob_sampler(model, 4, encoder_reuse=reuse)
    ref, ref_launches = _sampled(eager, model.unet, images)
    first, first_launches = _sampled(graphed, model.unet, images)   # 2 eager steps, capture
    second, second_launches = _sampled(graphed, model.unet, images)  # all replays
    g = graphed.graphed
    assert (g.captures, g.eager_steps, g.replays) == (1, 2, 2 * SAMPLER_T - 2)
    assert len(next(iter(g._cache.values())).graphs) == (2 if reuse == 1 else 3)
    assert torch.equal(first, ref) and torch.equal(second, ref)
    # the wrappers count each replay's launches, none at the capture
    assert first_launches == second_launches == ref_launches and ref_launches[0] > 0
    # the float torso is channels-last: every K2 site took an NHWC path
    assert ref_launches[-1] == {"nchw": 0, "nhwc": ref_launches[0]}
    other, _ = _sampled(graphed, model.unet, images, key=4)
    assert not torch.equal(other, ref)  # the keys reach the graphs' static buffers
    assert torch.equal(other, _sampled(eager, model.unet, images, key=4)[0])


def test_graphed_int8_static_sampler_is_bit_equal_to_the_eager_loop(deterministic):
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler

    model = _sampler_model(2, seed=5, quantized_inference="static")
    images = _sampler_images(2)
    model = quant.calibrate_static_scales(model, model.unet, images)
    eager = make_prob_sampler(model, 4, encoder_reuse=2, graphs=False)
    graphed = make_prob_sampler(model, 4, encoder_reuse=2)
    ref, ref_launches = _sampled(eager, model.unet, images)
    assert ref_launches[2] > 0  # K3 ran
    assert ref_launches[-1] == {"nchw": ref_launches[0], "nhwc": 0}  # an int8 UNet: NCHW
    for _ in range(2):
        out, launches = _sampled(graphed, model.unet, images)
        assert torch.equal(out, ref) and launches == ref_launches
    assert graphed.graphed.captures == 1


@pytest.mark.parametrize("config", ["flagship", "cityscapes"])
def test_a_replayed_step_runs_every_norm_site_channels_last(cuda, config):
    """The graphed sampler at the benchmark's geometry (flagship 8 images x
    16 samples, Cityscapes 2 x 1 with a DINO map): every replayed step runs
    all its K2 sites (66, 81) on the NHWC paths, none on NCHW."""
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.models.builder import build_model

    params, classes, channels, hw, features, batch = _site_configs()[config]
    steps, samples = 3, {"flagship": 16, "cityscapes": 1}[config]
    model = build_model(dict(params, time_steps=steps, step_T_sample="confidence"), classes,
                        channels, min(hw), device="cuda")
    images = torch.randn(batch // samples, *hw, channels, generator=cuda, device="cuda")
    feats = (torch.randn(batch // samples, hw[0] // 8, hw[1] // 8, features, generator=cuda,
                         device="cuda") if features else None)
    run = make_prob_sampler(model, samples,
                            feature_fn=(lambda net, im: feats) if features else None)
    run(model.unet, images, 1)  # eager steps and the capture
    before = dict(gn.layout_launches)
    run(model.unet, images, 2)
    torch.cuda.synchronize()
    assert run.graphed.replays == steps + (steps - 2)
    sites = {"flagship": 66, "cityscapes": 81}[config]
    assert {k: v - before[k] for k, v in gn.layout_launches.items()} == {
        "nchw": 0, "nhwc": sites * steps}


def test_graphed_sampler_captures_a_short_batch_as_a_second_key(deterministic):
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler

    model = _sampler_model(2, seed=7)
    images = _sampler_images(2)
    eager = make_prob_sampler(model, 4, graphs=False)
    graphed = make_prob_sampler(model, 4)
    assert torch.equal(_sampled(graphed, model.unet, images)[0],
                       _sampled(eager, model.unet, images)[0])
    short = images[:1].clone()
    out, launches = _sampled(graphed, model.unet, short)
    ref, ref_launches = _sampled(eager, model.unet, short)
    assert graphed.graphed.captures == 2 and len(graphed.graphed._cache) == 2
    assert torch.equal(out, ref) and launches == ref_launches
    again, _ = _sampled(graphed, model.unet, images)  # the first key, replayed
    assert graphed.graphed.captures == 2
    assert torch.equal(again, _sampled(eager, model.unet, images)[0])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_graphed_sampler_follows_a_weight_written_in_place(deterministic, int8):
    """A weight written in place between calls (as the trainer writes its
    EMA for validation) is a new key: the next call captures anew and its
    maps are the eager loop's on the new weights; int8 codes follow."""
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler

    model = _sampler_model(2, seed=9, **({"quantized_inference": True} if int8 else {}))
    images = _sampler_images(2)
    eager = make_prob_sampler(model, 4, graphs=False)
    graphed = make_prob_sampler(model, 4)
    before, _ = _sampled(graphed, model.unet, images)
    site = (quant.quant_sites(model.unet)[0][1] if int8 else
            next(m for m in model.unet.modules() if isinstance(m, torch.nn.Conv2d)))
    codes = site.w_q.clone() if int8 else None
    with torch.no_grad():
        site.weight.mul_(-2.0)
    after, _ = _sampled(graphed, model.unet, images)
    ref, _ = _sampled(eager, model.unet, images)
    assert torch.equal(after, ref) and not torch.equal(after, before)
    assert graphed.graphed.captures == 2 and len(graphed.graphed._cache) == 1
    if int8:
        assert not torch.equal(site.w_q, codes)


def test_a_sampler_capture_that_fails_raises_and_keeps_no_graphs(deterministic):
    """A host sync inside the step (here a hook reading a value) breaks the
    capture: the call raises naming the step, nothing runs eagerly in its
    place, and the next call captures afresh."""
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler

    model = _sampler_model(2, seed=11)
    images = _sampler_images(2)
    graphed = make_prob_sampler(model, 4)
    def read_a_value(mod, args):
        float(args[0].sum())

    hook = model.unet.register_forward_pre_hook(read_a_value)
    with pytest.raises(RuntimeError, match="CUDA graph capture of the sampler's drawing step"):
        graphed(model.unet, images, 3)
    hook.remove()
    assert not graphed.graphed._cache and graphed.graphed.captures == 0
    out, _ = _sampled(graphed, model.unet, images)
    ref, _ = _sampled(make_prob_sampler(model, 4, graphs=False), model.unet, images)
    assert torch.equal(out, ref) and graphed.graphed.captures == 1


# the served sampler's graphs (utils/serving.py), against its step loop and
# the sampler, under cuDNN's deterministic algorithms: bit for bit
@pytest.mark.parametrize("c,int8", [(2, False), (9, False), (2, True)],
                         ids=["onehot", "index", "int8-static"])
def test_served_graphs_equal_the_served_loop_and_the_sampler(deterministic, c, int8):
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.utils.serving import export_sampler, load_sampler

    model = _sampler_model(c, seed=21 + c,
                           **({"quantized_inference": "static"} if int8 else {}))
    images = _sampler_images(2)
    if int8:
        model = quant.calibrate_static_scales(model, model.unet, images)
    ref, ref_launches = _sampled(make_prob_sampler(model, 3, graphs=False), model.unet,
                                 images, key=5)
    serve = load_sampler(export_sampler(model, model.unet, (32, 32, 1), num_samples=3,
                                        batch_size=2))
    seed = random.seed_words(5).cuda()
    served = [_sampled(lambda net, x, key: serve(x, seed), None, images) for _ in range(2)]
    g = serve.graphed
    assert (g.captures, g.eager_steps, g.replays) == (1, 2, 2 * SAMPLER_T - 2)
    for out, launches in served:  # a first call (2 eager steps, the capture), then replays
        assert torch.equal(out, ref)
        assert launches[:3] == ref_launches[:3] and ref_launches[0] > 0
    assert torch.equal(serve(images, seed, graphs=False), ref)
    other = serve(images, random.seed_words(6).cuda())
    assert not torch.equal(other, ref)  # the seed reaches the graph's static buffer
    assert torch.equal(other, serve(images, random.seed_words(6).cuda(), graphs=False))


def test_a_served_capture_that_fails_raises_and_keeps_no_graph(deterministic):
    """A host sync inside the served step breaks its capture: the call
    raises naming the step, nothing runs eagerly in its place, and the next
    call captures afresh."""
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.utils.serving import export_sampler, load_sampler

    model = _sampler_model(2, seed=31)
    images = _sampler_images(2)
    serve = load_sampler(export_sampler(model, model.unet, (32, 32, 1), num_samples=2,
                                        batch_size=2))
    seed = random.seed_words(3).cuda()
    g = serve.graphed
    step = g.step
    g.step = lambda x, *args: step(x, *args) if float(x.sum()) == float(x.sum()) else None
    with pytest.raises(RuntimeError, match="CUDA graph capture of the served sampler's step"):
        serve(images, seed)
    assert g.graph is None and g.captures == 0
    g.step = step
    g.body = None  # the body holds the step it was made with
    assert torch.equal(serve(images, seed), serve(images, seed, graphs=False))
    assert g.captures == 1


def test_graphed_train_step_with_remat_equals_the_plain_eager_step(cuda):
    """`use_checkpoint` and `remat_attention` on, dropout 0.1: the graphed
    step (rematerialised blocks recomputed inside the captured backward,
    the dropout's kept units drawn in front of each ResBlock) gives the
    eager step's states and metrics with both keys off, bit for bit."""
    params, model, masters, batches = _graph_setup()
    unet = dict(params["unet_openai"], dropout=0.1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name, keys in (("plain", {"use_checkpoint": False, "remat_attention": False}),
                           ("remat", {"use_checkpoint": True, "remat_attention": True})):
            from ccdm_tpu_torch.models.builder import build_model

            p = dict(params, unet_openai=dict(unet, **keys))
            m = build_model(p, 2, 1, 32, generator=torch.Generator().manual_seed(3))
            runs[name] = _graph_run(p, m, masters, batches, graphed=name == "remat")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (_, e_state, _, e_metrics, e_launches), (step, g_state, _, g_metrics, g_launches) = \
        runs["plain"], runs["remat"]
    assert (step.eager_steps, step.captures, step.replays) == (2, 1, 3)
    for a, b in ((e_state.params, g_state.params), (e_state.opt_state["mu"],
                                                    g_state.opt_state["mu"])):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(e_metrics, g_metrics):
        assert all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a)
    # every norm and attention forward but the head's runs twice a step
    assert g_launches[1] == e_launches[1] and g_launches[0] > e_launches[0]
    assert g_launches[2] == 2 * e_launches[2]


@pytest.mark.parametrize("c", [2, 9], ids=["onehot", "index"])
def test_traced_graphed_sampler_keeps_its_bits_and_its_marks_time_a_replay(deterministic, c):
    """With tracing on, the captured step holds its marks as graph nodes:
    the maps are the untraced graphs' bit for bit, and the drawing step's
    four parts sum to an event-timed replay of its graph within 3%."""
    from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
    from ccdm_tpu_torch.utils import trace

    model = _sampler_model(c, seed=20 + c)
    images = _sampler_images(4)
    ref, _ = _sampled(make_prob_sampler(model, 4), model.unet, images)
    trace.clear()
    trace.enable()
    try:
        run = make_prob_sampler(model, 4)
        first, _ = _sampled(run, model.unet, images)   # 2 eager steps, the captures
        second, _ = _sampled(run, model.unet, images)  # all replays
        assert torch.equal(first, ref) and torch.equal(second, ref)
        steps = [r for r in trace.records() if r.name == "sampler.steps"]
        assert len(steps) == 2 and any(r.name == "sampler.capture" for r in trace.records())
        assert set(steps[-1].attached) == {"graph.drawing", "graph.last"}
        drawing = steps[-1].attached["graph.drawing"]
        parts = drawing.ms()
        assert set(parts) == {"unet", "posterior", "noise", "draw"}
        assert all(v > 0 for v in parts.values()) and parts["unet"] > parts["draw"]
        assert set(steps[-1].attached["graph.last"].ms()) == {"unet", "posterior", "draw"}
        entry = next(iter(run.graphed._cache.values()))
        graph, _ = entry.graphs[True, False]
        with torch.inference_mode():  # the sampler's buffers are inference tensors
            entry.body.k.zero_()  # the replay reads t_grid[k]: past the last step, out of range
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        whole, marked = start.elapsed_time(end), sum(drawing.ms().values())
        assert marked <= whole and whole - marked <= 0.03 * whole, (marked, whole)
    finally:
        trace.disable()
        trace.clear()
