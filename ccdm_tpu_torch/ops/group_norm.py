"""Fused GroupNorm(+SiLU) (port of `ccdm_tpu/ops/group_norm.py`).

Layout: `[B, C, *spatial]`, contiguous (NCHW) or channels-last (NHWC: the
channels innermost in memory, as `torch.channels_last` holds a 4-d tensor
and as the attention block's `[B, C, T]` tokens view it), the output in the
input's layout. The UNet's inference torso is channels-last, its training
forward and its int8 form NCHW (`models/unet.py`). Stats and the normalise
run in fp32; the output has the input's dtype (fp32 or bf16);
`weight`/`bias` are fp32 `[C]`. An optional `add` `[B, C]` in x's
dtype is added to x first and the sum rounded to x's dtype, as the
ResBlock's `h + emb_out` does; the kernel normalises that sum without a
separate pass.

`group_norm` is the wrapper the model calls. On a CPU tensor it runs the
plain PyTorch version, `torch_group_norm`; on a CUDA tensor it launches the
hand-written kernel (`csrc/group_norm.cu`) or raises. `_plan` picks the
kernel's path from the shape alone:

- "S": slabs of at most `_S_MAX_PACKS` vectors per lane, one warp per
  (sample, group) slab, values in registers;
- "M": slabs that fit the shared memory of a thread-block cluster of up to
  `_M_MAX_CLUSTER` blocks, one bulk copy into shared memory per block;
- "L": larger slabs, partial sums to scratch and a second pass.

S and M run one CUDA kernel per call and read x once; L runs two and reads
it twice. A channels-last input takes `_plan_nhwc`'s paths, built for that
layout (`csrc/group_norm.cu`): a unit of work is one sample's pixels over a
tile of `tile` channels (whole groups),

- "M": units that fit a cluster of up to `_MN_MAX_CLUSTER` blocks of
  `_M_CHUNK_BYTES`, their pixel rows copied into shared memory and the
  group sums exchanged between the blocks: one read of x, one launch;
- "L": larger units, clusters of stats blocks that fold their sums into one
  partial each, then apply blocks.

`launches` counts wrapper calls on the card, `path_launches` splits them by
path and `layout_launches` by the input's layout ("nchw", "nhwc").

Training: where autograd needs the result's gradient, `group_norm` goes
through `GroupNormFunction` (NCHW inputs only: a channels-last one
raises), whose backward is `group_norm_backward`: the
hand-written kernel `csrc/group_norm_backward.cu` on the card, the plain
`torch_group_norm_backward` on the CPU. It returns the gradients of x, the
weight, the bias and the add; it saves x as given (not the sum with the add,
which it recomputes) and recomputes the statistics. `_plan_backward` picks
the backward kernel's path as `_plan` does the forward's:

- "S": slabs of at most `_SB_MAX_PACKS` vectors a lane for a team of up to
  `_SB_MAX_WARPS` warps per slab and at most `_SB_MAX_CHANNELS` channels a
  group, x and dy in registers, a cluster per group that adds the weight
  and bias gradients over the batch;
- "M": slabs whose x and dy fit a cluster of up to `_M_MAX_CLUSTER` blocks
  of `_MB_CHUNK_BYTES` of each, bulk copies into shared memory and the
  partial sums exchanged between the blocks;
- "L": larger slabs, partial sums to scratch over three launches.

S and M read x and dy once in one launch. `launches_bwd` counts its calls
on the card, `path_launches_bwd` splits them by path. Without autograd (the
sampler, under `inference_mode`) the forward runs alone, as before.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ccdm_tpu_torch.ops import _build

launches = 0
path_launches = {"S": 0, "M": 0, "L": 0}
layout_launches = {"nchw": 0, "nhwc": 0}
launches_bwd = 0
path_launches_bwd = {"S": 0, "M": 0, "L": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"S": 0, "M": 1, "L": 2}
_THREADS = 256
# Path limits, from timings of every flagship site on the H100 (PERF.md): at
# 16 vectors a lane path S holds 157 registers a thread, one block an SM,
# and ran slower than M; at 128 KB a block, one block an SM, path M ran
# slower than L on 1 MB slabs.
_S_MAX_PACKS = 8                  # vectors per lane that path S keeps in registers
_M_CHUNK_BYTES = 64 * 1024        # shared memory a path-M block holds at most: 3 blocks an SM
_M_MAX_CLUSTER = 8                # the portable cluster size
_LOADS_PER_THREAD = 8             # path L: 16-byte loads each thread makes per block and pass
_MIN_BLOCKS = 4 * 132             # path L: a few blocks per H100 SM when B*G alone is too few
# The backward's limits (csrc/group_norm_backward.cu), from timings of the
# training sites on the H100 (tools/sweep_group_norm_backward.py, PERF.md):
# S holds x and dy in registers, at most 2 vectors a lane for a team of at
# most 8 warps (at 512 vectors S and M ran within 5%) and at most 16
# channels a group; an M block holds at most 16 KB of x and of dy, so 6
# blocks share an SM, and the least cluster that holds the slab ran fastest
# (more, smaller blocks did not pay for their barriers); M and L cut a
# block's chunk into tiles, each within one channel and at most
# `_TILE_PACKS` vectors a lane long, and hold at most `_MAX_TILES` of them
# (`_tiles_bound`).
# The channels-last paths' limits (csrc/group_norm.cu, NHWC), from timings
# of the flagship's and Cityscapes' sites on the H100 (PERF.md): an M block
# holds at most `_M_CHUNK_BYTES` of pixel rows (three blocks an SM), a
# tile's rows run at least `_MN_MIN_RUN_BYTES` where it is not every
# channel (shorter rows ran slower), a tile holds at most `_MN_MAX_TILE`
# channels, and a cluster at most `_MN_MAX_CLUSTER` blocks (16 needs the
# non-portable size); blocks of `_MN_BLOCK_BYTES` in clusters of
# `_MN_CLUSTER` or fewer ran fastest where a unit fits them. Path L: about
# `_LN_STATS_BLOCKS` stats blocks, in clusters of `_LN_CLUSTER` that fold
# their sums into one partial, and apply blocks of at most
# `_LN_APPLY_BYTES`, as many as the stats blocks or more.
_MN_MAX_CLUSTER = 16
_MN_MAX_TILE = 128                # channels an M tile (kMaxTileM), in at most 32 vectors
_MN_CLUSTER = 8
_MN_BLOCK_BYTES = 32 * 1024
_MN_MIN_RUN_BYTES = 64
_LN_CLUSTER = 8
_LN_STATS_BLOCKS = 4 * 132
_LN_APPLY_BYTES = 128 * 1024
_SMS = 132                        # the H100's SMs
_MAX_TILE_GROUPS = 32             # the groups one unit may hold (kMaxTileGroups)
_SB_MAX_PACKS = 2
_SB_MAX_WARPS = 8
_SB_MAX_CHANNELS = 16
_MB_CHUNK_BYTES = 16 * 1024
_TILE_PACKS = 2
_MAX_TILES = 128


def torch_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5, silu: bool = False,
                     add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch GroupNorm(+SiLU) with flax's numerics: fp32 stats,
    var = max(E[x²] - mean², 0), y = (x - mean) * (rsqrt(var + eps) * w) + b.
    `add` `[B, C]` is added to x in x's dtype first."""
    like = x
    b, c = x.shape[:2]
    if add is not None:
        x = x + add.reshape(b, c, *([1] * (x.dim() - 2)))
    cpg = c // groups
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    xc = x.float().reshape(b, c, -1)
    mean_c = mean.repeat_interleave(cpg, dim=1)
    mul = rstd.repeat_interleave(cpg, dim=1) * weight.float()[None, :, None]
    y = (xc - mean_c) * mul + bias.float()[None, :, None]
    if silu:
        y = torch.nn.functional.silu(y)
    return _laid_out_like(y.reshape(x.shape).to(x.dtype), like)


def _laid_out_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Contiguous `y` in x's layout: the strides `torch.empty_like(x)` gives."""
    return y if x.is_contiguous() else torch.empty_like(x).copy_(y)


def channels_last(x: torch.Tensor) -> bool:
    """Whether `[B, C, *spatial]` x holds its channels innermost in memory
    and is dense otherwise (`torch.channels_last` for 4-d x), and is not
    also contiguous (one channel, or one pixel)."""
    return x.dim() >= 3 and not x.is_contiguous() and x.movedim(1, -1).is_contiguous()


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a kernel runs one call: `path` "S", "M" or "L"; `vec` elements
    per load (16 bytes, or 1 where H·W or the address does not allow it);
    `param` packs per lane (S), cluster size (M) or splits per slab (L);
    `chunk` elements per block (M, L), or warps per slab (the backward's
    S). A channels-last input's plan (`layout` "nhwc") counts in pixels and
    channels: `tile` channels a unit; M: `param` blocks a unit, `chunk`
    pixels a block; L: `splits` stats blocks a unit in clusters of
    `param`, `chunk` pixels a stats block, `apply` pixels an apply block."""

    path: str
    vec: int
    param: int
    chunk: int = 0
    layout: str = "nchw"
    tile: int = 0
    splits: int = 0
    apply: int = 0


def _splits(batch_groups: int, slab: int, itemsize: int) -> int:
    """Path L's chunks per (sample, group) slab: enough that one block reads
    about `_THREADS * _LOADS_PER_THREAD` vectors, and enough blocks to fill
    the card."""
    vec = 16 // itemsize
    splits = math.ceil(slab / (_THREADS * vec * _LOADS_PER_THREAD))
    wanted = math.ceil(_MIN_BLOCKS / batch_groups)
    return max(1, splits, min(wanted, math.ceil(slab / (_THREADS * vec))))


def _plan(shape: Sequence[int], dtype: torch.dtype, groups: int,
          aligned: bool = True, nhwc: bool = False) -> Plan:
    """The kernel's path for a `[B, C, *spatial]` input of `dtype`,
    contiguous or (`nhwc`) channels-last (`aligned`: its address is a
    multiple of 16 bytes)."""
    if nhwc:
        return _plan_nhwc(shape, dtype, groups, aligned)
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    slab = c // groups * hw
    itemsize = dtype.itemsize
    full = 16 // itemsize
    vec = full if aligned and hw % full == 0 else 1
    packs = math.ceil(slab / (32 * vec))
    if packs <= _S_MAX_PACKS:
        return Plan("S", vec, 1 << (packs - 1).bit_length())
    cluster = math.ceil(slab * itemsize / _M_CHUNK_BYTES)
    if cluster <= _M_MAX_CLUSTER:
        return Plan("M", vec, cluster, math.ceil(math.ceil(slab / cluster) / vec) * vec)
    splits = _splits(b * groups, slab, itemsize)
    return Plan("L", vec, splits, math.ceil(math.ceil(slab / splits) / vec) * vec)


def _plan_nhwc(shape: Sequence[int], dtype: torch.dtype, groups: int,
               aligned: bool = True) -> Plan:
    """`_plan` for a channels-last input (see `Plan`): a tile is whole
    groups and vectors; path M where a unit of at most 32 vectors a row
    (a warp's row) and rows of `_MN_MIN_RUN_BYTES` or more fits a cluster
    (see below); else path L over the widest tile."""
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    cpg = c // groups
    itemsize = dtype.itemsize
    full = 16 // itemsize
    vec = full if aligned and c % full == 0 else 1
    base = math.lcm(cpg, vec)
    tiles = [t for t in range(c, 0, -1) if c % t == 0 and t % base == 0
             and t // vec <= _THREADS and t // cpg <= _MAX_TILE_GROUPS]
    if not tiles:
        raise ValueError(f"group_norm: no channel tile of {c} channels in {groups} groups "
                         f"fits a block ({_THREADS} vectors, {_MAX_TILE_GROUPS} groups)")

    def blocks(tile, size):  # the fewest blocks of `size` bytes that hold a unit
        return math.ceil(hw / max(1, size // (tile * itemsize)))

    # rows of at least `_MN_MIN_RUN_BYTES` (or whole pixels); the widest tile
    # whose unit fits one block of `_M_CHUNK_BYTES`, with narrower tiles while
    # the card would hold less than a block an SM, one block a unit however
    # few the units (spread over a cluster, such a unit ran slower at every
    # such site of the samplers but one); else the widest whose
    # unit fits `_MN_CLUSTER` blocks of `_MN_BLOCK_BYTES`; else the least
    # cluster of `_M_CHUNK_BYTES` blocks, with rows of half that length if
    # no other fits (they beat path L's two reads)
    def rows_of(run):
        return [t for t in tiles if (t == c or t * itemsize >= run)
                and t <= _MN_MAX_TILE and t // vec <= 32]

    fits = rows_of(_MN_MIN_RUN_BYTES)
    one = [t for t in fits if blocks(t, _M_CHUNK_BYTES) == 1]
    near = [t for t in fits if blocks(t, _MN_BLOCK_BYTES) <= _MN_CLUSTER]
    far = ([t for t in fits if blocks(t, _M_CHUNK_BYTES) <= _MN_MAX_CLUSTER]
           or [t for t in rows_of(_MN_MIN_RUN_BYTES // 2)
               if blocks(t, _M_CHUNK_BYTES) <= _MN_MAX_CLUSTER])
    if one:
        tile = one.pop(0)
        while b * (c // tile) < _SMS and one:
            tile = one.pop(0)
        cluster = 1
    elif near:
        tile, cluster = near[0], blocks(near[0], _MN_BLOCK_BYTES)
    elif far:
        tile = min(far, key=lambda t: (blocks(t, _M_CHUNK_BYTES), -t))
        cluster = blocks(tile, _M_CHUNK_BYTES)
    if one or near or far:
        chunk = math.ceil(hw / min(cluster, hw))
        return Plan("M", vec, math.ceil(hw / chunk), chunk, "nhwc", tile)
    tile = tiles[0]
    row = tile * itemsize
    units = b * (c // tile)
    cluster = min(_LN_CLUSTER, hw)
    splits = max(cluster, math.ceil(_LN_STATS_BLOCKS / units / cluster) * cluster)
    apply = min(math.ceil(_LN_APPLY_BYTES / row), math.ceil(hw * units / _LN_STATS_BLOCKS))
    return Plan("L", vec, cluster, math.ceil(hw / splits), "nhwc", tile, splits, apply)


def _nhwc_partial_floats(plan: Plan, batch: int, channels: int, groups: int) -> int:
    """fp32 scratch of a channels-last path-L call: two sums a tile group,
    a cluster of stats blocks and a unit."""
    units = batch * (channels // plan.tile)
    return units * (plan.splits // plan.param) * 2 * (plan.tile // (channels // groups))


def _pow2(n: int) -> int:
    """The least power of 2 >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def _tiles_bound(chunk: int, hw: int, vec: int) -> int:
    """The most tiles a run of `chunk` elements of a slab can hold, wherever
    it starts (`tiles_bound` in csrc/group_norm_backward.cu). Each channel
    of `hw` elements is cut into tiles of `_TILE_PACKS * 32 * vec` from its
    start, the last one shorter, so a run holds at most `channels` times
    the tiles of a channel, and at most one tile more than its pieces in
    each channel hold at their length."""
    tile = _TILE_PACKS * 32 * vec
    channels = 1 + (chunk - 1 + hw - 1) // hw  # a run may start at a channel's last element
    return min(channels * -(-hw // tile), (chunk + channels * (tile - 1)) // tile + 1)


def _longest_chunk(hw: int, vec: int) -> int:
    """The longest chunk, a multiple of `vec`, whose tiles fit `_MAX_TILES`."""
    lo, hi = 1, _MAX_TILES * _TILE_PACKS * 32  # in vectors; `hi` never fits
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _tiles_bound(mid * vec, hw, vec) <= _MAX_TILES else (lo, mid)
    return lo * vec


def _plan_backward(shape: Sequence[int], dtype: torch.dtype, groups: int,
                   aligned: bool = True) -> Plan:
    """The backward kernel's path for contiguous `[B, C, *spatial]` x and dy
    of `dtype` (`aligned`: both addresses are multiples of 16 bytes), with
    or without the add: the same kernels take both."""
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    slab = c // groups * hw
    itemsize = dtype.itemsize
    full = 16 // itemsize
    vec = full if aligned and hw % full == 0 else 1
    vectors = math.ceil(slab / vec)
    if c // groups <= _SB_MAX_CHANNELS and vectors <= _SB_MAX_PACKS * 32 * _SB_MAX_WARPS:
        # a team of warps per slab, about 2 vectors a lane
        warps = min(_SB_MAX_WARPS, _pow2(math.ceil(vectors / 64)))
        return Plan("S", vec, _pow2(math.ceil(vectors / (32 * warps))), warps)
    max_chunk = _longest_chunk(hw, vec)
    cluster = max(math.ceil(slab * itemsize / _MB_CHUNK_BYTES), math.ceil(slab / max_chunk))
    if cluster <= _M_MAX_CLUSTER:
        return Plan("M", vec, cluster, math.ceil(math.ceil(slab / cluster) / vec) * vec)
    splits = _splits(b * groups, slab, itemsize)
    chunk = min(math.ceil(math.ceil(slab / splits) / vec) * vec, max_chunk)
    return Plan("L", vec, math.ceil(slab / chunk), chunk)


def _scratch_floats(plan: Plan, batch: int, channels: int, groups: int, hw: int) -> int:
    """fp32 scratch of one backward call: the per-(sample, channel) sums of
    g * xhat and g, and for path L each chunk's statistics, channel sums and
    sums of dv (`Large` in csrc/group_norm_backward.cu)."""
    if plan.path == "S":
        return 0
    floats = 2 * batch * channels
    if plan.path == "L":
        chunks = batch * groups * plan.param
        floats += chunks * (2 + 3 * (math.ceil(plan.chunk / hw) + 1))
    return floats


_counters = {}


def _counter(device: torch.device, stream) -> torch.Tensor:
    """The backward kernel's completion counter for one (device, stream): an
    int32 zeroed once, which each launch leaves at 0.

    Launches that share a counter must not run at the same time; launches
    on one stream never do. A CUDA graph keeps the counter of the stream it
    was captured on: replayed on another stream while that stream runs
    backward kernels of its own, it would race on the counter and give
    wrong weight and bias gradients, unless no launch outside the graph
    uses its capture stream after the capture. So the graphed train step
    (`train/step.GraphedTrainStep`) is captured on a stream of its own."""
    key = (device.index, stream.cuda_stream)
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _counters[key]


def torch_group_norm_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int, eps: float = 1e-5,
                              silu: bool = False, add: Optional[torch.Tensor] = None):
    """Plain PyTorch backward of `torch_group_norm`, by explicit formulas:
    `(dx, dweight, dbias, dadd)` (`dadd` None without an add). Over a
    (sample, group) slab, with v = x + add rounded to x's dtype, its fp32
    mean and rstd as the forward computes them, xhat = (v - mean) * rstd,
    g = dy * silu'(y_pre) (g = dy without SiLU) and u = g * weight:
    dv = rstd * (u - mean(u) - xhat * mean(u * xhat)), dweight = sum g * xhat,
    dbias = sum g (over samples and positions), dadd = sum over positions
    of dv. dx and dadd have x's dtype, dweight and dbias are fp32."""
    b, c = x.shape[:2]
    if add is not None:
        x = x + add.reshape(b, c, *([1] * (x.dim() - 2)))
    cpg = c // groups
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    centred = (xf - mean).reshape(b, c, -1)
    rstd_c = rstd.repeat_interleave(cpg, dim=1)
    xhat = centred * rstd_c
    w = weight.float()[None, :, None]
    g = dy.float().reshape(b, c, -1)
    if silu:
        y = centred * (rstd_c * w) + bias.float()[None, :, None]
        s = torch.sigmoid(y)
        g = g * s * (1 + y * (1 - s))
    dweight = (g * xhat).sum(dim=(0, 2))
    dbias = g.sum(dim=(0, 2))
    u = (g * w).reshape(b, groups, -1)
    xh = xhat.reshape(b, groups, -1)
    dv = rstd * (u - u.mean(dim=-1, keepdim=True) - xh * (u * xh).mean(dim=-1, keepdim=True))
    dadd = None if add is None else dv.reshape(b, c, -1).sum(dim=-1).to(x.dtype)
    return dv.reshape(x.shape).to(x.dtype), dweight, dbias, dadd


def _check_args(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                groups: int, add: Optional[torch.Tensor], nhwc: bool = False) -> None:
    """What both kernels take: x fp32 or bf16 `[B, C, ...]` on the card,
    contiguous (or channels-last, where `nhwc`), fp32 `[C]` weight and
    bias, and an add `[B, C]` in x's dtype."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0 or not (x.is_contiguous() or nhwc and channels_last(x)):
        raise ValueError(f"{name}: x must be a non-empty contiguous [B, C, ...] tensor"
                         f"{' or a channels-last one' if nhwc else ''}, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, c = x.shape[:2]
    if groups <= 0 or c % groups:
        raise ValueError(f"{name}: {c} channels do not split into {groups} groups")
    for what, p in (("weight", weight), ("bias", bias)):
        if (p.device != x.device or p.dtype != torch.float32 or p.shape != (c,)
                or not p.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous float32 [{c}] on "
                             f"{x.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")
    if add is not None and (add.device != x.device or add.dtype != x.dtype
                            or add.shape != (b, c) or not add.is_contiguous()):
        raise ValueError(f"{name}: add must be contiguous {x.dtype} [{b}, {c}] on "
                         f"{x.device}, got {add.dtype} {tuple(add.shape)} on {add.device}")


def group_norm_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, groups: int, eps: float = 1e-5,
                        silu: bool = False, add: Optional[torch.Tensor] = None):
    """`(dx, dweight, dbias, dadd)` of `group_norm(x, weight, bias, groups,
    eps, silu, add)` for the output gradient `dy`: the plain version on CPU
    tensors, the kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return torch_group_norm_backward(dy, x, weight, bias, groups, eps, silu, add)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_backward: unsupported device {x.device}")
    _check_args("group_norm_backward", x, weight, bias, groups, add)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"group_norm_backward: dy must be {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    plan = _plan_backward(x.shape, x.dtype, groups,
                          aligned=x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
    return _launch_backward(plan, dy, x, weight, bias, groups, eps, silu, add)


def _launch_backward(plan: Plan, dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float, silu: bool,
                     add: Optional[torch.Tensor]):
    """The backward kernel under `plan` on checked CUDA inputs (dy
    contiguous): `(dx, dweight, dbias, dadd)`. The C entry point refuses a
    plan that does not fit the shape, and the call raises."""
    global launches_bwd
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    dx = torch.empty_like(x)
    dadd = None if add is None else torch.empty_like(add)
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    scratch = torch.empty(_scratch_floats(plan, b, c, groups, hw), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device)
    # the C entry point reads the current device's attributes and launches
    # there: make it x's
    with torch.cuda.device(x.device):
        status = _build.library().ccdm_group_norm_backward(
            x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if add is None else add.data_ptr(), dx.data_ptr(),
            None if dadd is None else dadd.data_ptr(), scratch.data_ptr(),
            _counter(x.device, stream).data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
            _DTYPE_CODES[x.dtype], b, c, hw, groups, _PATH_CODES[plan.path], plan.vec,
            plan.param, plan.chunk, float(eps), int(silu), stream.cuda_stream)
    _build.check(status, "group_norm_backward")
    launches_bwd += 1
    path_launches_bwd[plan.path] += 1
    return dx, dweight, dbias, dadd


class GroupNormFunction(torch.autograd.Function):
    """`group_norm` under autograd: the forward kernel (or plain version),
    then `group_norm_backward` for the gradients of x, weight, bias and add."""

    @staticmethod
    def forward(ctx, x, weight, bias, add, groups, eps, silu):
        ctx.save_for_backward(x, weight, bias, add)
        ctx.config = (groups, eps, silu)
        return _group_norm_forward(x, weight, bias, groups, eps, silu, add)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, add = ctx.saved_tensors
        dx, dweight, dbias, dadd = group_norm_backward(dy, x, weight, bias, *ctx.config,
                                                       add=add)
        return dx, dweight, dbias, dadd, None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5, silu: bool = False,
               add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over `[B, C, *spatial]` with an optional fused SiLU and an
    optional `[B, C]` add in front of it; differentiable through
    `GroupNormFunction` where autograd records. While `torch.export` traces,
    the registered op `ccdm::group_norm` stands in its place."""
    if torch.compiler.is_exporting():
        return torch.ops.ccdm.group_norm(x, weight, bias, add, groups, eps, silu)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, add)):
        if channels_last(x):
            raise ValueError(
                f"group_norm: the autograd path takes contiguous (NCHW) x only, as its "
                f"backward kernel does; got a channels-last x of shape {tuple(x.shape)} "
                f"strides {x.stride()} (a UNet trains with contiguous weights: "
                f"`UNetModel.lay_out_weights(False)`)")
        return GroupNormFunction.apply(x, weight, bias, add, groups, eps, silu)
    return _group_norm_forward(x, weight, bias, groups, eps, silu, add)


def _group_norm_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        groups: int, eps: float, silu: bool,
                        add: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward alone: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    if x.device.type == "cpu":
        return torch_group_norm(x, weight, bias, groups, eps, silu, add)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    nhwc = channels_last(x)
    _check_args("group_norm", x, weight, bias, groups, add, nhwc)
    plan = _plan(x.shape, x.dtype, groups, aligned=x.data_ptr() % 16 == 0, nhwc=nhwc)
    return _launch_forward(plan, x, weight, bias, groups, eps, silu, add)


def _launch_forward(plan: Plan, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float, silu: bool,
                    add: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward kernel under `plan` on checked CUDA inputs, its output
    in x's layout. The C entry point refuses a plan that does not fit the
    shape, and the call raises."""
    global launches
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    add_ptr = None if add is None else add.data_ptr()
    lib = _build.library()
    with torch.cuda.device(x.device):  # the launch and the attributes it reads
        if plan.layout == "nhwc":
            partial = (torch.empty(_nhwc_partial_floats(plan, b, c, groups),
                                   dtype=torch.float32, device=x.device)
                       if plan.path == "L" else None)
            status = lib.ccdm_group_norm_nhwc(
                x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), add_ptr,
                None if partial is None else partial.data_ptr(), _DTYPE_CODES[x.dtype], b,
                c, hw, groups, _PATH_CODES[plan.path], plan.vec, plan.tile, plan.param,
                plan.splits, plan.chunk, plan.apply, float(eps), int(silu), stream)
        else:
            partial = (torch.empty(b * groups * plan.param * 2, dtype=torch.float32,
                                   device=x.device) if plan.path == "L" else None)
            status = lib.ccdm_group_norm(
                x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), add_ptr,
                None if partial is None else partial.data_ptr(), _DTYPE_CODES[x.dtype], b,
                c, hw, groups, _PATH_CODES[plan.path], plan.vec, plan.param, plan.chunk,
                float(eps), int(silu), stream)
    _build.check(status, "group_norm")
    launches += 1
    path_launches[plan.path] += 1
    layout_launches[plan.layout] += 1
    return y


# The forward as a registered op, so that `torch.export` (utils/serving.py)
# records one node a call: the dispatcher takes the plain version for CPU
# tensors and the kernel for CUDA tensors; the fake gives the output's
# metadata while an export traces (the launch plan reads pointers and stays
# in the real implementation).
@torch.library.custom_op("ccdm::group_norm", mutates_args=(), device_types="cpu")
def _group_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   add: Optional[torch.Tensor], groups: int, eps: float,
                   silu: bool) -> torch.Tensor:
    return torch_group_norm(x, weight, bias, groups, eps, silu, add)


@_group_norm_op.register_kernel("cuda")
def _group_norm_op_cuda(x, weight, bias, add, groups, eps, silu):
    return _group_norm_forward(x, weight, bias, groups, eps, silu, add)


@_group_norm_op.register_fake
def _group_norm_op_fake(x, weight, bias, add, groups, eps, silu):
    return torch.empty_like(x)  # x's layout, as both implementations give it
