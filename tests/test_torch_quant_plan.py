"""The int8 conv kernel's plan (`ops/quant._plan_conv`) at every int8 site of
the flagship sampler (batch 32 and 128) and of the Cityscapes one (batch 2),
in bf16 and fp32: the path each site takes, and each plan within what the
kernel accepts (its constants read from `csrc/quant_conv.cu`) and the H100
holds. The kernel runs only on the card (`tests/test_torch_kernels_gpu.py`,
chip_smoke phase 21); its plan is plain Python and is held here. The sites
come from hooks on a batch-1 forward of each config's UNet on the CPU; the
Cityscapes UNet runs at 32x64, an eighth of its 256x512 a side, and its
sites are scaled back (the channels do not depend on the size).
"""

import collections
import functools
import math
import re
from pathlib import Path

import pytest
import torch

from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS, FLAGSHIP_PARAMS
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.ops import quant

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
SOURCE = Path(quant.__file__).resolve().parents[1] / "csrc" / "quant_conv.cu"


def _constants() -> dict:
    """The file-scope `constexpr int` constants of the kernel's source."""
    names = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", SOURCE.read_text(),
                                 re.MULTILINE):
        names[name] = int(eval(expr, {}, dict(names)))
    return names


K = _constants()


@functools.lru_cache(maxsize=None)
def sites(config: str):
    """{(C, H, W, kernel, stride, Cout): count} of one UNet call."""
    if config == "flagship":
        params, ncls, ci, hw, scale, feat = FLAGSHIP_PARAMS, 2, 1, (128, 128), 1, None
    else:
        params, ncls, ci, hw, scale = CITYSCAPES_EVAL_PARAMS, 20, 3, (32, 64), 8
        feat = torch.zeros(1, 4, 8, 384)
    model = build_model(dict(params, quantized_inference=True, compute_dtype="float32"), ncls,
                        ci, 128 if config == "flagship" else 256, device="cpu")
    found = collections.Counter()

    def record(mod, args):
        c, h, w = args[0].shape[1:]
        found[(c, h * scale, w * scale, mod.kernel_size[0], mod.stride[0],
               mod.out_channels)] += 1

    hooks = [m.register_forward_pre_hook(record) for _, m in quant.quant_sites(model.unet)]
    args = [torch.zeros(1, *hw, ncls), torch.zeros(1, *hw, ci), torch.full((1,), 5)]
    with torch.inference_mode():
        model.unet(*args, *([feat] if feat is not None else []))
    for h in hooks:
        h.remove()
    return dict(found)


CASES = [("flagship", 32), ("flagship", 128), ("cityscapes", 2)]


def _out(n, k, s):
    return (n + 2 * ((k - 1) // 2) - k) // s + 1


def accepted(plan, shape, cout, k, stride, dtype, aligned=True) -> bool:
    """The C entry point's checks of a plan (`ccdm_quant_conv`), in Python."""
    b, cin, h, w = shape
    cin_pad = -(-cin // 32) * 32
    ho, wo = _out(h, k, stride), _out(w, k, stride)
    if plan.path == "tile":
        chunks = cin_pad // 32
        per = -(-chunks // plan.split)
        tw = 64 if wo > 32 else 32 if wo > 16 else 16 if wo > 8 else 8
        hh, ww = (64 // tw - 1) * stride + k, (tw - 1) * stride + k
        smem = max(hh * ww * K["kRow"] + k * k * (64 if cout > 32 else 32) * K["kRow"],
                   K["kBN"] * K["kStage"] * 4)
        return (1 <= plan.split <= chunks and -(-chunks // per) == plan.split
                and 2 * hh * ww <= K["kSlots"] * K["kThreads"] and smem <= 48 * 1024)
    v = 16 // dtype.itemsize
    vec = aligned and w % v == 0
    twin = (plan.tw - 1) * stride + k
    nv = -(-(twin + (v - 1 if k == 3 else 0)) // v)
    warps = plan.tw // 32 * (plan.bn // 32)
    smem = quant.ring_smem(cin, k, stride, plan.tw, plan.bn)
    return (plan.tw in (32, 64, 128) and plan.bn in (32, 64, 128) and plan.rs > 0
            and 1 <= plan.items <= K["kRingMaxItems"] and not (k == 1 and stride != 1)
            and plan.threads % 32 == 0 and plan.threads >= max(32 * warps, K["kRingMinThreads"])
            and plan.threads <= K["kRingMaxThreads"] and smem <= K["kRingSmemMax"]
            and (not vec or stride * -(-cin // 4) * nv <= plan.items * plan.threads))


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("config,batch", CASES)
def test_every_site_takes_a_plan_the_kernel_accepts(config, batch, dtype):
    for (c, h, w, k, stride, cout) in sites(config):
        shape = (batch, c, h, w)
        for aligned in (True, False):
            plan = quant._plan_conv(shape, cout, k, stride, dtype, aligned)
            assert accepted(plan, shape, cout, k, stride, dtype, aligned), (shape, k, plan)


@pytest.mark.parametrize("config,batch", CASES)
def test_the_ring_takes_every_site_of_wide_output_rows(config, batch):
    """Output rows of 32 pixels and up go to the ring where a block of it
    fits and gets enough work: a 3x3 stride-1 site needs rows of 64 pixels
    and up and 64 output channels a block (or all of them), which leaves
    out the 32x32 levels and the Cityscapes sites of 384 input channels and
    more (the tile was faster there, PERF.md). As many output channels a
    block as its shared memory holds, so few blocks quantize the same
    input; each strip is at least 4 rows (or the whole height)."""
    counts = collections.Counter()
    for (c, h, w, k, stride, cout), n in sites(config).items():
        plan = quant._plan_conv((batch, c, h, w), cout, k, stride, BF16)
        wo, ho = _out(w, k, stride), _out(h, k, stride)
        counts[plan.path] += n
        if wo < 32:
            assert plan.path == "tile"
            continue
        if plan.path == "tile":  # 3x3 s1 on 32-pixel rows, or where no ring block fits
            assert quant._ring_plan((batch, c, h, w), cout, k, stride, 2, True) is None
            assert (k == 3 and stride == 1 and wo < 64) or c >= 384, (c, h, w, k, stride, cout)
            continue
        assert plan.tw <= wo and plan.rs >= min(ho, 4)
        if cout <= 32:
            assert plan.bn == 32 and plan.tw == min(128, 1 << (wo.bit_length() - 1))
    # the sites a UNet call takes on each path
    want = {"flagship": {"ring": 35, "tile": 46}, "cityscapes": {"ring": 58, "tile": 38}}
    assert dict(counts) == want[config]


def test_the_ring_plans_of_the_level_0_sites():
    """The call's largest sites: the flagship's level 0 (one 32-channel tile,
    full rows of 128 pixels, 4 warps) and the Cityscapes level 0 (all 128
    output channels in one block of 8 warps over 64-pixel tiles)."""
    flag = quant._plan_conv((128, 32, 128, 128), 32, 3, 1, BF16)
    assert (flag.path, flag.tw, flag.bn, flag.threads) == ("ring", 128, 32, 128)
    cs = quant._plan_conv((2, 128, 256, 512), 128, 3, 1, BF16)
    assert (cs.path, cs.tw, cs.bn, cs.threads) == ("ring", 64, 128, 256)
    assert quant.ring_smem(128, 3, 1, 64, 128) <= K["kRingSmemMax"]


@pytest.mark.parametrize("config,batch", CASES)
def test_split_k_fills_the_card_at_the_deep_sites(config, batch):
    """A tile site whose 64 x 64 tiles are fewer than two blocks an SM splits
    K until they are (or every range is one chunk of 32 channels)."""
    for (c, h, w, k, stride, cout) in sites(config):
        plan = quant._plan_conv((batch, c, h, w), cout, k, stride, BF16)
        if plan.path != "tile":
            continue
        ho, wo = _out(h, k, stride), _out(w, k, stride)
        tw = 64 if wo > 32 else 32 if wo > 16 else 16 if wo > 8 else 8
        blocks = batch * -(-wo // tw) * -(-ho // (64 // tw)) * -(-cout // 64)
        chunks = -(-c // 32)
        if blocks >= 2 * H100_SMS:
            assert plan.split == 1
        else:
            assert plan.split == chunks or blocks * plan.split >= 2 * H100_SMS, (c, h, w, plan)


def test_the_deep_cityscapes_site_splits_k():
    """[2,512,8,16] 512->512: 32 tiles of 64 x 64 alone, so K splits 16 ways
    (a chunk of 32 channels each) into 512 blocks."""
    plan = quant._plan_conv((2, 512, 8, 16), 512, 3, 1, BF16)
    assert (plan.path, plan.split) == ("tile", 16)


@pytest.mark.parametrize("shape,cout,k,stride,path", [
    ((2, 32, 37, 77), 48, 3, 1, "ring"),    # ragged H and W: element loads (77 % 8)
    ((2, 32, 33, 67), 40, 3, 2, "ring"),    # stride 2 on odd H and W
    ((3, 40, 13, 21), 20, 3, 1, "tile"),    # output rows under 32 pixels
    ((2, 640, 32, 64), 256, 3, 1, "tile"),  # the ring cannot hold 640 channels
    ((1, 64, 32, 32), 96, 1, 1, "ring"),    # a 1x1
])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_plans_of_the_card_tests_shapes(shape, cout, k, stride, path, dtype):
    """The shapes the card's tests give the kernel take the path they test."""
    plan = quant._plan_conv(shape, cout, k, stride, dtype)
    assert plan.path == path
    assert accepted(plan, shape, cout, k, stride, dtype)
    if path == "ring" and shape[3] % (16 // dtype.itemsize):
        assert plan.items == 1  # element loads, no prefetch


def test_ring_smem_counts_the_ring_the_weights_and_the_stage():
    # 3 rows of 130 pixels at a pitch of 48, 9 taps x 32 rows, a 32 x 132 fp32 stage
    assert quant.ring_smem(32, 3, 1, 128, 32) == 3 * 130 * 48 + 9 * 32 * 48 + 32 * 132 * 4
    # stride 2: 129 pixels a ring row for 64 output pixels
    assert quant.ring_smem(32, 3, 2, 64, 32) == 3 * 129 * 48 + 9 * 32 * 48 + 32 * 68 * 4
    assert math.gcd(quant.ring_smem(3, 1, 1, 32, 32), 16) == 16


def test_the_phase_timer_finds_each_phase_it_guards_in_the_kernel():
    """`tools/phase_quant_conv.py` times the ring with its phases skipped by
    guarding them in a copy of the source: each text it replaces is there
    once, so an edit of the kernel that moves one fails here, not on the
    card."""
    from ccdm_tpu_torch.tools import phase_quant_conv

    source = SOURCE.read_text()
    for old, _ in phase_quant_conv.GUARDS:
        assert source.count(old) == 1, old
