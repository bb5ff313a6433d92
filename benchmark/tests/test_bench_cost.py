"""The counts of `benchmark/cost/` against hand counts, and every share that
a metric reads against 100% at the kernel times the repository recorded."""

from __future__ import annotations

import math

import pytest

from benchmark.cost import model as cost
from benchmark.cost.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S

FLAGSHIP = {"num_classes": 2, "image_channels": 1,
            "unet_openai": {"base_channels": 32, "image_size": 128, "channel_mult": None,
                            "attention_resolutions": [32, 16, 8], "num_head_channels": 32}}
CITYSCAPES = {"num_classes": 20, "image_channels": 3,
              "feature_cond_encoder": {"type": "dino", "target_layer": 10, "channels": 384},
              "unet_openai": {"base_channels": 128, "image_size": 256, "channel_mult": None,
                              "attention_resolutions": [32, 16, 8], "num_head_channels": 32}}


def gn_bound_us(shape, itemsize, silu, add, backward=False):
    """A GroupNorm call's least time, written out: forward reads x, weight,
    bias and add and writes y; backward reads x, dy, weight, bias and add
    and writes dx, dweight, dbias and dadd; fp32 work an element."""
    n, c = math.prod(shape), shape[1]
    add_b = shape[0] * c * itemsize if add else 0
    if backward:
        nbytes, ops = 3 * n * itemsize + 16 * c + 2 * add_b, n * (14 + 8 * silu + add)
    else:
        nbytes, ops = 2 * n * itemsize + 8 * c + add_b, n * (6 + 3 * silu + add)
    return 1e6 * max(nbytes / 3.35e12, ops / 67e12)


@pytest.mark.parametrize("shape,itemsize,silu,add,backward,recorded_us", [
    ((128, 64, 128, 128), 2, True, False, False, 160.3),
    ((128, 32, 128, 128), 4, True, False, False, 160.3),
    ((2, 128, 256, 512), 2, True, True, False, 40.1),
    ((2, 640, 32, 64), 2, False, False, False, 3.1),
    ((16, 64, 128, 128), 2, True, False, True, 30.0),
    ((16, 96, 16, 16), 2, True, True, True, 0.7),
])
def test_group_norm_bound_at_the_kernel_table_shapes(shape, itemsize, silu, add, backward,
                                                      recorded_us):
    site = cost.Norm(shape, itemsize, silu, add, False)
    got = 1e6 * cost.group_norm_bound_s(site, backward)
    assert got == pytest.approx(gn_bound_us(shape, itemsize, silu, add, backward), rel=1e-12)
    assert got == pytest.approx(recorded_us, abs=0.06)


def test_site_counts_and_summed_bounds():
    c = cost.unet_cost(FLAGSHIP, 128, 128, 128)
    assert (len(c.norms), len(c.attentions), len(c.convs)) == (66, 11, 81)
    assert 1e6 * sum(map(cost.group_norm_bound_s, c.norms)) == pytest.approx(1702.3, abs=0.1)
    assert 1e6 * sum(map(cost.int8_conv_bound_s, c.convs)) == pytest.approx(2134.3, abs=0.1)
    c16 = cost.unet_cost(FLAGSHIP, 16, 128, 128)
    assert 1e6 * sum(cost.group_norm_bound_s(s, True) for s in c16.norms) == pytest.approx(
        319.2, abs=0.1)
    cs = cost.unet_cost(CITYSCAPES, 2, 256, 512)
    assert (len(cs.norms), len(cs.attentions), len(cs.convs)) == (81, 16, 96)
    assert 1e6 * sum(map(cost.group_norm_bound_s, cs.norms)) == pytest.approx(841.3, abs=0.1)
    assert {(a.bh, a.tokens) for a in cs.attentions} == {(16, 2048), (32, 512), (32, 128)}


def test_attention_and_int8_conv_by_hand():
    a = cost.Attention(bh=2, tokens=4, dh=2, encoder=False)
    assert a.flops == 2 * (2 * 4 * 4 * 2) * 2            # QK^T and PV
    assert cost.attention_bound_s(a) == (4 * 2 * 4 * 2 * 2) / HBM_BYTES_PER_S
    big = cost.Attention(bh=16, tokens=2048, dh=32, encoder=False)
    assert cost.attention_bound_s(big) == pytest.approx(
        4 * 16 * 2048 ** 2 * 32 / PEAK_OPS_PER_S["bfloat16"])
    q = cost.Conv(batch=1, cin=2, height=4, width=4, cout=3, kernel=3, stride=2, encoder=True)
    assert q.flops == 2 * 1 * 2 * 2 * 3 * 2 * 9
    nbytes = 1 * 2 * 16 * 2 + 3 * 2 * 9 + 2 * 3 * 4 + 1 * 3 * 4 * 2
    assert cost.int8_conv_bound_s(q) == nbytes / HBM_BYTES_PER_S


def test_unet_flops_by_hand():
    """One level of two, one ResBlock a level, 8x8, base 4: every conv,
    linear and attention product written out."""
    cfg = {"num_classes": 2, "image_channels": 1,
           "unet_openai": {"base_channels": 4, "image_size": 8, "channel_mult": [1, 2],
                           "attention_resolutions": [], "num_head_channels": 4,
                           "num_res_blocks": 1}}
    conv = lambda hw, cout, cin, k=3: 2 * hw * cout * cin * k * k  # noqa: E731
    encoder = (conv(64, 4, 3)                                       # conv_in
               + conv(64, 4, 4) * 2                                 # level 0 ResBlock
               + conv(16, 4, 4)                                     # downsample to 4x4
               + conv(16, 8, 4) + conv(16, 8, 8) + conv(16, 8, 4, 1))  # level 1 ResBlock
    middle = conv(16, 8, 8) * 4 + 4 * 2 * 16 * 16 * 4 + 2 * 16 * 8 * 32
    decoder = (conv(16, 8, 16) + conv(16, 8, 8) + conv(16, 8, 16, 1)
               + conv(16, 8, 12) + conv(16, 8, 8) + conv(16, 8, 12, 1)
               + conv(64, 8, 8)                                     # upsample's conv
               + conv(64, 4, 12) + conv(64, 4, 4) + conv(64, 4, 12, 1)
               + conv(64, 4, 8) + conv(64, 4, 4) + conv(64, 4, 8, 1)
               + conv(64, 2, 4))                                    # the head
    linears = 2 * (4 * 16 + 16 * 16) + 2 * 16 * (4 + 8 + 8 + 8 + 8 + 8 + 4 + 4)
    c = cost.unet_cost(cfg, 1, 8, 8)
    assert c.flops() == encoder + middle + decoder + linears
    encoder_linears = 2 * 16 * (4 + 8)
    assert c.flops(encoder=False) == middle + decoder + linears - encoder_linears


def test_shares_stay_under_100_percent_at_recorded_times():
    """PERF.md's kernel table: K2 2.251 ms over the 66 flagship sites and
    1.871 ms over the 81 Cityscapes sites a step, K3 11.670 ms a flagship
    call of 128 and 16.375 ms a Cityscapes call, K1 5 x 0.0350 + 6 x
    0.0058 ms a flagship step; the graphed flagship sampler 24.732 ms of
    device time (chip_smoke)."""
    step = cost.sampler_call(FLAGSHIP, 128, 128, 128, 1)
    assert 100 * step["k2_bound_s"] / 2.251e-3 < 100
    assert 100 * step["k3_bound_s"] / 11.670e-3 < 100
    assert 100 * step["k1_bound_s"] / (5 * 0.0350e-3 + 6 * 0.0058e-3) < 100
    assert 100 * step["flops"] / 24.732e-3 / PEAK_OPS_PER_S["bfloat16"] < 100
    cs = cost.sampler_call(CITYSCAPES, 2, 256, 512, 1)
    assert 100 * cs["k2_bound_s"] / 1.871e-3 < 100
    assert 100 * cs["k3_bound_s"] / 16.375e-3 < 100


def test_encoder_reuse_counts_only_what_runs():
    full = cost.sampler_call(FLAGSHIP, 4, 128, 128, 10)
    reuse = cost.sampler_call(FLAGSHIP, 4, 128, 128, 10, encoder_reuse=2)
    c = cost.unet_cost(FLAGSHIP, 4, 128, 128)
    assert full["flops"] == 10 * c.flops()
    assert reuse["flops"] == 5 * c.flops() + 5 * c.flops(encoder=False)
    assert reuse["k2_bound_s"] < full["k2_bound_s"]
