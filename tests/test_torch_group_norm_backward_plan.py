"""The GroupNorm backward kernel's plan (`ops/group_norm._plan_backward`) at
every GroupNorm site of the port's train steps at batch 16, and at the path-L
shapes: the path each site takes, element loads where the inputs are not
16-byte aligned, each block's tiles, shared memory and cluster sizes within
what the kernel (its constants read from its source) and the H100 take, and
enough path-L blocks to fill it. The kernel itself runs only on the card
(`tests/test_torch_kernels_gpu.py`); its plan is plain Python and is held
here. The sites come from hooks on a batch-1 forward of each config's UNet
on the CPU (`tools/time_group_norm_backward.training_sites`), with the batch
set to 16.
"""

import functools
import math
import re
from pathlib import Path

import pytest
import torch

from ccdm_tpu_torch.ops import group_norm as gn
from ccdm_tpu_torch.tools.time_group_norm_backward import CONFIGS, training_sites

BF16, F32 = torch.bfloat16, torch.float32
BATCH = 16
H100_SMS = 132
SMEM_PER_SM = 228 * 1024     # an SM's shared memory, of which each block reserves 1 KB
SMEM_PER_BLOCK = 227 * 1024  # the most one block may hold
SOURCE = Path(gn.__file__).resolve().parents[1] / "csrc" / "group_norm_backward.cu"


def _constants() -> dict:
    """The file-scope `constexpr int` constants of the kernel's source."""
    names = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", SOURCE.read_text(),
                                 re.MULTILINE):
        names[name] = int(eval(expr, {}, dict(names)))
    return names


K = _constants()
# path M's static shared memory (gn_backward_cluster): five float arrays of
# kMaxTiles, the mbarrier, the statistics' partials, the statistics, and
# block_allreduce2's two float arrays of kWarps
M_STATIC_SMEM = 5 * K["kMaxTiles"] * 4 + 8 + 8 + 8 + 2 * K["kWarps"] * 4

# (shape at batch 16, dtype) -> (path, param, chunk) of every training site
SITES = {
    ((16, 32, 128, 128), BF16): ("M", 2, 8192),
    ((16, 32, 128, 128), F32): ("M", 4, 4096),
    ((16, 64, 128, 128), BF16): ("M", 4, 8192),
    ((16, 96, 64, 64), BF16): ("M", 2, 6144),
    ((16, 64, 64, 64), BF16): ("M", 1, 8192),
    ((16, 32, 64, 64), BF16): ("S", 2, 8),
    ((16, 160, 32, 32), BF16): ("M", 1, 5120),
    ((16, 128, 32, 32), BF16): ("S", 2, 8),
    ((16, 96, 32, 32), BF16): ("S", 2, 8),
    ((16, 64, 32, 32), BF16): ("S", 2, 4),
    ((16, 32, 32, 32), BF16): ("S", 2, 2),
    ((16, 224, 16, 16), BF16): ("S", 2, 4),
    ((16, 192, 16, 16), BF16): ("S", 2, 4),
    ((16, 160, 16, 16), BF16): ("S", 2, 4),
    ((16, 96, 16, 16), BF16): ("S", 2, 2),
    ((16, 64, 16, 16), BF16): ("S", 2, 1),
    ((16, 256, 8, 8), BF16): ("S", 2, 1),
    ((16, 224, 8, 8), BF16): ("S", 2, 1),
    ((16, 128, 8, 8), BF16): ("S", 1, 1),
    ((16, 96, 8, 8), BF16): ("S", 1, 1),
    ((16, 96, 256), BF16): ("S", 2, 2),
    ((16, 128, 64), BF16): ("S", 1, 1),
    ((16, 32, 128, 256), BF16): ("M", 4, 8192),
    ((16, 32, 128, 256), F32): ("M", 8, 4096),
    ((16, 64, 128, 256), BF16): ("M", 8, 8192),
    ((16, 96, 64, 128), BF16): ("M", 3, 8192),
    ((16, 64, 64, 128), BF16): ("M", 2, 8192),
    ((16, 32, 64, 128), BF16): ("M", 1, 8192),
    ((16, 128, 32, 64), BF16): ("M", 1, 8192),
    ((16, 96, 32, 64), BF16): ("M", 1, 6144),
    ((16, 64, 32, 64), BF16): ("S", 2, 8),
    ((16, 32, 32, 64), BF16): ("S", 2, 4),
    ((16, 448, 16, 32), BF16): ("M", 1, 7168),
    ((16, 192, 16, 32), BF16): ("S", 2, 8),
    ((16, 128, 16, 32), BF16): ("S", 2, 4),
    ((16, 64, 16, 32), BF16): ("S", 2, 2),
    ((16, 256, 8, 16), BF16): ("S", 2, 2),
    ((16, 192, 8, 16), BF16): ("S", 2, 2),
    ((16, 128, 8, 16), BF16): ("S", 2, 1),
    ((16, 64, 8, 16), BF16): ("S", 1, 1),
    ((16, 256, 4, 8), BF16): ("S", 1, 1),
    ((16, 128, 4, 8), BF16): ("S", 1, 1),
    ((16, 64, 512), BF16): ("S", 2, 2),
    ((16, 128, 128), BF16): ("S", 2, 1),
    ((16, 128, 32), BF16): ("S", 1, 1),
}

# path L: the Cityscapes sampler's torso and head slabs, which no train step
# launches (splits, chunk)
LARGE = {
    ((2, 128, 256, 512), BF16): (32, 16384),
    ((2, 128, 256, 512), F32): (64, 8192),
    ((2, 256, 256, 512), BF16): (64, 16384),
    ((2, 64, 256, 256), BF16): (9, 14568),
}


@functools.lru_cache(maxsize=None)
def _sites(config: str):
    return training_sites(config, BATCH)


def _tiles(begin: int, end: int, hw: int, vec: int) -> int:
    """The tiles of elements [begin, end) of a slab, counted as `Tiles` in
    the kernel counts them: each channel cut from its start into runs of
    kTilePacks * 32 * vec elements, the last one shorter."""
    if end <= begin:
        return 0
    tile = K["kTilePacks"] * 32 * vec
    per = -(-hw // tile)
    tile_id = lambda pos: pos // hw * per + pos % hw // tile  # noqa: E731
    return tile_id(end - 1) - tile_id(begin) + 1


def _check_limits(shape, dtype, plan):
    """The plan fits what the kernel (its constants read from the source)
    and the H100 take: S's vectors a lane, team and channels; each M or L
    block's tiles, counted at every block's chunk, within the kernel's
    arrays; M's shared memory for kClusterBlocksPerSM blocks an SM; enough
    L blocks."""
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    slab = c // 32 * hw
    assert plan.vec in (1, 16 // dtype.itemsize) and hw % plan.vec == 0
    if plan.path == "S":
        assert 1 <= plan.param <= K["kMaxSmallPacks"] and plan.chunk in (1, 2, 4, 8)
        assert plan.param * plan.chunk * 32 * plan.vec >= slab
        assert c // 32 <= K["kMaxSmallChannels"]
        return
    assert plan.chunk % plan.vec == 0 and plan.param * plan.chunk >= slab
    tiles = max(_tiles(i * plan.chunk, min((i + 1) * plan.chunk, slab), hw, plan.vec)
                for i in range(plan.param))
    assert tiles <= gn._tiles_bound(plan.chunk, hw, plan.vec) <= K["kMaxTiles"]
    if plan.path == "M":
        assert 1 <= plan.param <= 8
        smem = 2 * math.ceil(plan.chunk * dtype.itemsize / 16) * 16 + M_STATIC_SMEM
        assert smem <= SMEM_PER_BLOCK
        assert K["kClusterBlocksPerSM"] * (smem + 1024) <= SMEM_PER_SM
    else:
        assert plan.path == "L"
        # about 4 blocks an SM, unless the chunks are already at their least
        blocks = b * 32 * plan.param
        assert blocks >= 4 * H100_SMS or plan.chunk <= gn._THREADS * plan.vec


def test_plan_constants_are_the_kernels():
    """The Python plan's limits are the kernel's."""
    assert (gn._TILE_PACKS, gn._MAX_TILES, gn._SB_MAX_PACKS, gn._SB_MAX_CHANNELS) == (
        K["kTilePacks"], K["kMaxTiles"], K["kMaxSmallPacks"], K["kMaxSmallChannels"])
    assert K["kWarps"] == K["kThreads"] // 32 == gn._SB_MAX_WARPS


@pytest.mark.parametrize("hw,vec", [(hw, vec) for vec in (1, 4, 8) for hw in (
    1, 13, 32, 63, 64, 65, 81, 96, 127, 169, 512, 513, 1521, 4096) if hw % vec == 0])
def test_tiles_bound_holds_wherever_a_chunk_starts(hw, vec):
    """`_tiles_bound` is at least the tiles of any run of its length, at
    every start (a multiple of `vec`, which divides H*W) within two
    channels, and the longest chunk the plan takes fits kMaxTiles."""
    longest = gn._longest_chunk(hw, vec)
    assert gn._tiles_bound(longest, hw, vec) <= K["kMaxTiles"]
    assert gn._tiles_bound(longest + vec, hw, vec) > K["kMaxTiles"]
    tile = K["kTilePacks"] * 32 * vec
    for chunk in sorted({vec, 3 * vec, tile, tile + vec, 5 * tile - vec, longest}):
        worst = max(_tiles(s, s + chunk, hw, vec) for s in range(0, 2 * hw + tile, vec))
        assert worst <= gn._tiles_bound(chunk, hw, vec), chunk


@pytest.mark.parametrize("config", list(CONFIGS))
def test_every_training_site_is_in_the_table(config):
    """Each GroupNorm site of the config's UNet is a row of SITES (32
    groups), with or without the add."""
    sites = _sites(config)
    assert sum(sites.values()) == (66 if config == "flagship" else 81)
    for shape, dtype, groups, _, _ in sites:
        assert groups == 32 and (shape, dtype) in SITES, (shape, dtype)


@pytest.mark.parametrize("shape,dtype", list(SITES))
def test_backward_plan_at_a_training_site(shape, dtype):
    plan = gn._plan_backward(shape, dtype, 32)
    assert (plan.path, plan.param, plan.chunk) == SITES[(shape, dtype)]
    assert plan.vec == 16 // dtype.itemsize
    _check_limits(shape, dtype, plan)
    unaligned = gn._plan_backward(shape, dtype, 32, aligned=False)
    assert unaligned.vec == 1
    _check_limits(shape, dtype, unaligned)


@pytest.mark.parametrize("shape,dtype", list(LARGE))
def test_backward_plan_at_path_l_shapes(shape, dtype):
    plan = gn._plan_backward(shape, dtype, 32)
    assert (plan.path, plan.param, plan.chunk) == ("L", *LARGE[(shape, dtype)])
    _check_limits(shape, dtype, plan)
    unaligned = gn._plan_backward(shape, dtype, 32, aligned=False)
    assert unaligned.path == "L" and unaligned.vec == 1
    _check_limits(shape, dtype, unaligned)


@pytest.mark.parametrize("shape,dtype,path", [((3, 32, 13, 13), F32, "S"),
                                              ((16, 96, 13, 13), BF16, "S"),
                                              ((2, 96, 39, 39), F32, "M"),
                                              ((16, 64, 7, 5), BF16, "S")])
def test_ragged_rows_take_element_loads(shape, dtype, path):
    """H*W not a multiple of the 16-byte vector: element loads, on S and M."""
    plan = gn._plan_backward(shape, dtype, 32)
    assert plan.path == path and plan.vec == 1
    _check_limits(shape, dtype, plan)


# H*W past one tile of element loads (64) and not a multiple of it, so that
# each channel holds two tiles: (shape, dtype, aligned) -> (path, param, chunk)
RAGGED_TILES = {
    ((16, 3840, 5, 13), BF16, True): ("M", 2, 3900),
    ((16, 6368, 9, 9), BF16, True): ("M", 4, 4030),
    ((16, 2688, 96), BF16, False): ("M", 2, 4032),
    ((16, 2688, 96), F32, False): ("M", 2, 4032),
    ((2, 64000, 5, 13), BF16, True): ("L", 32, 4096),
}


@pytest.mark.parametrize("shape,dtype,aligned", list(RAGGED_TILES))
def test_chunks_of_ragged_channels_fit_their_tiles(shape, dtype, aligned):
    """Where a channel is cut into a full tile and a short one, a chunk holds
    about twice the tiles of its length: the plan cuts it short enough."""
    plan = gn._plan_backward(shape, dtype, 32, aligned=aligned)
    assert plan.vec == 1
    assert (plan.path, plan.param, plan.chunk) == RAGGED_TILES[(shape, dtype, aligned)]
    _check_limits(shape, dtype, plan)


def test_scratch_sizes():
    """S needs no scratch; M the per-(sample, channel) sums; L adds each
    chunk's statistics and channel sums."""
    s = gn._plan_backward((16, 128, 4, 8), BF16, 32)
    m = gn._plan_backward((16, 32, 128, 256), BF16, 32)
    big = gn._plan_backward((2, 128, 256, 512), BF16, 32)
    assert gn._scratch_floats(s, 16, 128, 32, 32) == 0
    assert gn._scratch_floats(m, 16, 32, 32, 128 * 256) == 2 * 16 * 32
    chunks = 2 * 32 * big.param
    maxch = math.ceil(big.chunk / (256 * 512)) + 1
    assert gn._scratch_floats(big, 2, 128, 32, 256 * 512) == 2 * 2 * 128 + chunks * (
        2 + 3 * maxch)
