"""Int8 quantized convolution for inference (port of `ccdm_tpu/ops/quant.py`).

The JAX package's `quantized_inference` mode: symmetric int8 codes for the
activations (one scale per tensor) and the weights (one scale per output
channel), an integer convolution with int32 sums, and the dequantisation
plus an fp32 bias in its epilogue:

    x_q = clip(round(x / s_x), -127, 127)        (fp32 division, half to even)
    w_q = clip(round(W / s_w), -127, 127),  s_w = max(max|W| over (Cin,kh,kw) / 127, 1e-12)
    out = float(conv(x_q, w_q)) * (s_x * s_w) + bias, cast once to x's dtype

The activation scale is dynamic, `max(max|x| / 127, 1e-8)` computed on the
device for every call (`quantized_inference: yes`), or static, `max(absmax,
1e-8) / 127` from a per-site absmax that `calibrate_sampler` records on a
short float rollout (`quantized_inference: static`). The two formulas are
the JAX package's and both are kept.

- `quant_conv` is the wrapper the model calls: on a CPU tensor it runs the
  plain PyTorch version, `quant_conv_plain` (the integer convolution as a
  float64 `F.conv2d` of the codes, exact since every sum stays far below
  2^53); on a CUDA tensor it launches the hand-written kernel
  (`csrc/quant_conv.cu`) or raises. `_plan_conv` picks the kernel's path
  from the shape: "ring" (a block walks a strip of output rows with a ring
  of quantized input rows in shared memory; output rows of 32 pixels and
  up, 64 for a 3x3 of stride 1) or "tile" (64-pixel tiles, K split over
  blocks where the tiles alone are too few for the card). `launches` counts the wrapper's calls
  on the card, `path_launches` splits them by path.
- `QuantConv2d` is the model's conv: an `nn.Conv2d` whose weight and bias
  stay fp32 whatever the torso's dtype, so the codes come from the fp32
  masters, as the JAX package quantizes its fp32 parameters. Its state
  dict is `nn.Conv2d`'s, so float checkpoints load unchanged. The codes
  are derived once, and again whenever the weight changes (a
  `load_state_dict`, an in-place write).
- The scales travel with the model, never with the weights:
  `DenoisingModel.with_quant_scales` holds a table of device fp32 absmax
  scalars keyed by the sites' module names and applies it around each
  UNet call (`static_scales`); a model without a table runs every site
  dynamically. Apart from the knob below, nothing here is process-global.

`STATIC_ACTIVATION_SCALE` is the JAX package's experiment knob, and it is
process-global: when set, a site with no static scale of its own
quantizes its input with this one fixed scale (the scale itself, not an
absmax) instead of the dynamic one. It is read at each call, as the JAX
package reads it at each trace, and made into a device scalar once for each
value and device. No caller in the port sets it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops.precision import fp32_precision

LOGGER = logging.getLogger(__name__)

# The fixed activation scale of every site without a static one (None:
# dynamic); see the module docstring
STATIC_ACTIVATION_SCALE: Optional[float] = None

launches = 0
path_launches = {"ring": 0, "tile": 0}


@functools.lru_cache(maxsize=None)
def _fixed_scale(value: float, device: torch.device) -> torch.Tensor:
    """`STATIC_ACTIVATION_SCALE`'s value as an fp32 scalar on `device`."""
    return torch.tensor(value, dtype=torch.float32, device=device)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"tile": 0, "ring": 1}
_CHUNK = 32  # the kernel's input channels a step: a tap's channels are padded to it
# The kernel's limits (csrc/quant_conv.cu). Ring: a block of at most 512
# threads (a warp per 32 pixels x 32 channels, at least 4 warps), tiles of
# 128, 64 or 32 output pixels and channels, at most 4 prefetched 16-byte
# items a thread per output row, and the ring, weights and stage within the
# 227 KB a block may have. Tile: 64 pixels x 64 channels a block.
_RING_TILES = (128, 64, 32)
_RING_MAX_THREADS = 512
_RING_MIN_THREADS = 128
_RING_MAX_ITEMS = 4
_RING_SMEM_MAX = 232448
_SM_SMEM = 233472          # shared memory of one H100 SM, less 1 KB a block for the system
_SMS = 132                 # H100 SXM
_RING_REGS = 128           # registers a ring thread holds (ptxas, every instance)
_RING_WARM_ROWS = 3        # a strip's start costs about its first window's rows
_RING_MIN_ROWS = 4         # rows a strip at least, so the ring's first rows pay off
_TILE_MIN_BLOCKS = 2 * _SMS  # fewer tiles than this: split K


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How the kernel runs one call. "ring": `tw` output pixels, `bn` output
    channels and `rs` output rows a block of `threads`, `items` prefetched
    16-byte loads a thread; "tile": K in `split` ranges of chunks (int32
    atomics and a second launch where split > 1)."""
    path: str
    tw: int = 0
    bn: int = 0
    rs: int = 0
    items: int = 1
    threads: int = 0
    split: int = 1

    def args(self):
        """The C entry point's p0..p4."""
        if self.path == "ring":
            return self.tw, self.bn, self.rs, self.items, self.threads
        return self.split, 0, 0, 0, 0


def _out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * ((k - 1) // 2) - k) // stride + 1


def ring_smem(cin: int, k: int, stride: int, tw: int, bn: int) -> int:
    """Shared bytes of a ring block: k ring rows of `twin` pixels and all
    taps' weights for `bn` channels, each at a pitch of cin_pad + 16, and the
    fp32 stage [bn][tw + 4]."""
    pitch = -(-cin // _CHUNK) * _CHUNK + 16
    twin = (tw - 1) * stride + k
    return k * twin * pitch + k * k * bn * pitch + bn * (tw + 4) * 4


def _ring_plan(shape: Sequence[int], cout: int, k: int, stride: int, itemsize: int,
               vec: bool) -> Optional[ConvPlan]:
    b, cin, h, w = shape
    ho, wo = _out_size(h, k, stride), _out_size(w, k, stride)
    if wo < 32 or (k == 1 and stride != 1):
        return None
    v = 16 // itemsize
    widest = 1 << (wo.bit_length() - 1)  # the largest power of 2 <= wo
    cout_pad = -(-cout // 32) * 32
    cands = []
    for tw in _RING_TILES:
        if tw > widest:
            continue
        for bn in _RING_TILES:
            if bn > cout_pad:
                continue
            # 3x3 stride 1 on 32-pixel rows, or 32 of more than 32 output
            # channels a block, lost to the tile (PERF.md §6): too little
            # work a block for its weights and ring rows
            if k == 3 and stride == 1 and (tw < 64 or bn < min(64, cout_pad)):
                continue
            smem = ring_smem(cin, k, stride, tw, bn)
            twin = (tw - 1) * stride + k
            nv = -(-(twin + (v - 1 if k == 3 else 0)) // v)
            loads = stride * -(-cin // 4) * nv  # 16-byte items of a step's new rows
            # a warp per 32 x 32 tile; more threads where the loads need them
            threads = max(32 * (tw // 32) * (bn // 32), _RING_MIN_THREADS,
                          32 * -(-loads // (32 * _RING_MAX_ITEMS)) if vec else 0)
            items = -(-loads // threads) if vec else 1
            if threads > _RING_MAX_THREADS or smem > _RING_SMEM_MAX:
                continue
            # fewest output-channel tiles first (each re-reads the input), then
            # the widest tile (its edge columns are read twice)
            cands.append((-(-cout // bn), -tw, tw, bn, threads, smem, items))
    if not cands:
        return None
    ntiles, _, tw, bn, threads, smem, items = min(cands)
    resident = _SMS * max(1, min(_SM_SMEM // (smem + 1024), 2048 // threads,
                                 65536 // (threads * _RING_REGS)))
    per_row = b * -(-wo // tw) * ntiles
    # strips: the fewest waves of resident blocks times the rows each block
    # walks (its first window included); on the H100 one full wave of long
    # strips beat four of short ones at the sites measured (PERF.md §6)
    strips = min(range(1, ho + 1), key=lambda n: (
        -(-per_row * n // resident) * (-(-ho // n) + _RING_WARM_ROWS), -n))
    rs = max(-(-ho // strips), min(ho, _RING_MIN_ROWS))
    return ConvPlan("ring", tw=tw, bn=bn, rs=rs, items=items, threads=threads)


@functools.lru_cache(maxsize=None)
def _plan_conv(shape: Sequence[int], cout: int, k: int, stride: int, dtype: torch.dtype,
               aligned: bool = True) -> ConvPlan:
    """The kernel's path for NCHW `shape` (a tuple) of `dtype` into `cout`
    channels (`aligned`: x and the output start on 16 bytes): the ring where
    its output rows are long enough and a block of it fits, else the tile,
    with K split where its blocks alone are too few for the card. Cached: a
    model's sites repeat on every UNet call."""
    itemsize = dtype.itemsize
    vec = aligned and shape[3] % (16 // itemsize) == 0
    plan = _ring_plan(shape, cout, k, stride, itemsize, vec)
    if plan is not None:
        return plan
    b, cin, h, w = shape
    ho, wo = _out_size(h, k, stride), _out_size(w, k, stride)
    tw = 64 if wo > 32 else 32 if wo > 16 else 16 if wo > 8 else 8
    blocks = b * -(-wo // tw) * -(-ho // (64 // tw)) * -(-cout // 64)
    chunks = -(-cin // _CHUNK)
    split = 1
    if blocks < _TILE_MIN_BLOCKS and chunks > 1:
        per = -(-chunks // min(chunks, math.ceil(2 * _TILE_MIN_BLOCKS / blocks)))
        split = -(-chunks // per)
    return ConvPlan("tile", split=split)


_DIVISORS: Dict[torch.device, torch.Tensor] = {}


def _over_127(x: torch.Tensor) -> torch.Tensor:
    """`x / 127` in fp32, rounded once. PyTorch's CUDA division by a Python
    number (or a CPU scalar) multiplies by its reciprocal instead, which
    moves a scale by an ulp from the JAX package's, so the divisor is an
    fp32 tensor on x's device, made once per device."""
    if torch.compiler.is_exporting():  # a node of the traced graph, not a cached tensor
        return x.float() / torch.full((), 127.0, device=x.device)
    divisor = _DIVISORS.get(x.device)
    if divisor is None:
        with torch.inference_mode(False):  # a plain tensor, usable in any mode
            divisor = _DIVISORS[x.device] = torch.full((), 127.0, device=x.device)
    return x.float() / divisor


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even symmetric int8 codes of `x` with the given scale
    (on x's device, so the division is IEEE there too)."""
    return torch.clamp(torch.round(x.float() / scale.to(x.device)), -127, 127).to(torch.int8)


def dynamic_act_scale(x: torch.Tensor) -> torch.Tensor:
    """`max(max|x| / 127, 1e-8)`, an fp32 device scalar. max|x| is exact in
    x's own dtype, so no fp32 copy of x is made."""
    lo, hi = torch.aminmax(x)
    return _over_127(torch.maximum(hi, -lo)).clamp_min(1e-8)


def static_act_scale(absmax: torch.Tensor) -> torch.Tensor:
    """`max(absmax, 1e-8) / 127` of a calibrated absmax, in fp32."""
    return _over_127(absmax.float().clamp_min(1e-8))


def weight_codes(weight: torch.Tensor):
    """`(w_q, s_w)` of an OIHW weight for the kernel: `s_w` fp32 `[Cout]`, and
    `w_q` int8 `[Cout, kh*kw*cin_pad]`, tap-major with each tap's Cin
    channels zero-padded to `cin_pad`, a multiple of 32 (so the kernel reads
    32 channels of one tap a step, and the padding multiplies zeros)."""
    w = weight.detach().float()
    cout, cin, kh, kw = w.shape
    s_w = _over_127(w.abs().amax(dim=(1, 2, 3))).clamp_min(1e-12)
    codes = quantize_symmetric(w, s_w[:, None, None, None])
    cin_pad = -(-cin // _CHUNK) * _CHUNK
    w_q = torch.zeros(cout, kh, kw, cin_pad, dtype=torch.int8, device=w.device)
    w_q[..., :cin] = codes.permute(0, 2, 3, 1)
    return w_q.reshape(cout, kh * kw * cin_pad), s_w


def unpack_codes(w_q: torch.Tensor, cin: int, kernel_size: int) -> torch.Tensor:
    """The OIHW int8 codes `[Cout, Cin, k, k]` of a `weight_codes` layout."""
    cout = w_q.shape[0]
    taps = kernel_size * kernel_size
    return (w_q.reshape(cout, kernel_size, kernel_size, w_q.shape[1] // taps)[..., :cin]
            .permute(0, 3, 1, 2))


def quant_conv_plain(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                     bias: torch.Tensor, s_x: torch.Tensor, kernel_size: int,
                     stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The plain version: the same codes, an exact integer convolution (a
    float64 `F.conv2d` of the codes), the same fp32 epilogue; the output
    contiguous NCHW, as the kernel writes it."""
    x_q = quantize_symmetric(x, s_x)
    w = unpack_codes(w_q, x.shape[1], kernel_size)
    acc = F.conv2d(x_q.double(), w.double(), stride=stride, padding=padding)
    scale = (s_x * s_w)[:, None, None]  # rounded to fp32 first, as the JAX package does
    out = acc.float() * scale + bias[:, None, None]
    return out.to(x.dtype).contiguous()


def quant_conv(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, bias: torch.Tensor,
               s_x: torch.Tensor, kernel_size: int, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """Int8 conv of NCHW `x` (fp32 or bf16) with `weight_codes`' `(w_q, s_w)`,
    an fp32 `bias` `[Cout]` and the activation scale `s_x` (an fp32 device
    scalar): 3x3 with stride 1 or 2 and padding 1, or 1x1 with padding 0.
    Output NCHW in x's dtype. The plain version on CPU tensors, the kernel on
    CUDA tensors; while `torch.export` traces, the registered op
    `ccdm::quant_conv`."""
    global launches
    if torch.compiler.is_exporting():
        return torch.ops.ccdm.quant_conv(x, w_q, s_w, bias, s_x, kernel_size, stride, padding)
    if x.device.type == "cpu":
        return quant_conv_plain(x, w_q, s_w, bias, s_x, kernel_size, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"quant_conv: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quant_conv: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or 0 in x.shape:
        raise ValueError(f"quant_conv: x must be a non-empty contiguous NCHW tensor, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if (kernel_size, padding) not in ((3, 1), (1, 0)) or stride not in (1, 2):
        raise ValueError(f"quant_conv: kernel {kernel_size}, stride {stride}, padding "
                         f"{padding}: the kernel takes 3x3 with padding 1 or 1x1 with "
                         f"padding 0, stride 1 or 2")
    b, cin, h, w = x.shape
    cout = w_q.shape[0]
    cin_pad = -(-cin // _CHUNK) * _CHUNK
    want = {"w_q": (w_q, torch.int8, (cout, kernel_size * kernel_size * cin_pad)),
            "s_w": (s_w, torch.float32, (cout,)), "bias": (bias, torch.float32, (cout,)),
            "s_x": (s_x, torch.float32, ())}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"quant_conv: {name} must be a contiguous {dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    ho = (h + 2 * padding - kernel_size) // stride + 1
    wo = (w + 2 * padding - kernel_size) // stride + 1
    out = torch.empty(b, cout, ho, wo, dtype=x.dtype, device=x.device)
    plan = _plan_conv(x.shape, cout, kernel_size, stride, x.dtype,
                      aligned=x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    acc32 = (torch.zeros(b, cout, ho, wo, dtype=torch.int32, device=x.device)
             if plan.split > 1 else None)
    with torch.cuda.device(x.device):
        status = _build.library().ccdm_quant_conv(
            x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), bias.data_ptr(), s_x.data_ptr(),
            out.data_ptr(), None if acc32 is None else acc32.data_ptr(),
            _DTYPE_CODES[x.dtype], b, cin, h, w, cout, kernel_size, stride, padding, cin_pad,
            _PATH_CODES[plan.path], *plan.args(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "quant_conv")
    launches += 1
    path_launches[plan.path] += 1
    return out


# The int8 conv as a registered op for `torch.export` (see `ops/group_norm.py`):
# the plain version on CPU tensors, the kernel on CUDA tensors; the plan,
# which reads the addresses, is chosen in the real implementation.
@torch.library.custom_op("ccdm::quant_conv", mutates_args=(), device_types="cpu")
def _quant_conv_op(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                   bias: torch.Tensor, s_x: torch.Tensor, kernel_size: int, stride: int,
                   padding: int) -> torch.Tensor:
    return quant_conv_plain(x, w_q, s_w, bias, s_x, kernel_size, stride, padding)


@_quant_conv_op.register_kernel("cuda")
def _quant_conv_op_cuda(x, w_q, s_w, bias, s_x, kernel_size, stride, padding):
    return quant_conv(x, w_q, s_w, bias, s_x, kernel_size, stride, padding)


@_quant_conv_op.register_fake
def _quant_conv_op_fake(x, w_q, s_w, bias, s_x, kernel_size, stride, padding):
    b, _, h, w = x.shape
    return x.new_empty(b, w_q.shape[0], (h + 2 * padding - kernel_size) // stride + 1,
                       (w + 2 * padding - kernel_size) // stride + 1)


class QuantConv2d(nn.Conv2d):
    """`nn.Conv2d` running the int8 path; fp32 `weight` and `bias`.

    `act_scale` is the static scale of the current UNet call (set by
    `static_scales`; None: dynamic). Under `recording_absmax` the module
    records its input's absmax and runs the float conv in fp32 with the
    fp32 weights instead, so later sites see exact statistics.

    The scale and the codes (`w_q`, `s_w`) are buffers, outside the state
    dict, so that an exported program (`utils/serving.py`) holds them as
    its constants; while an export traces, the codes derived before it
    are used as they are (the traced weight is fake)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, device=device, dtype=torch.float32)
        self.register_buffer("act_scale", None, persistent=False)
        self.register_buffer("w_q", None, persistent=False)
        self.register_buffer("s_w", None, persistent=False)
        self.recording = False
        self.absmax: Optional[torch.Tensor] = None
        self._codes_key = None

    def codes(self):
        """`weight_codes(self.weight)`, derived again only when the weight's
        storage or version counter moved."""
        if torch.compiler.is_exporting():
            if self.w_q is None:
                raise RuntimeError("QuantConv2d: derive the codes (codes()) before an export")
            return self.w_q, self.s_w
        key = (self.weight.data_ptr(), self.weight._version)
        if key != self._codes_key:
            with torch.inference_mode(False), torch.no_grad():
                self.w_q, self.s_w = weight_codes(self.weight)
            self._codes_key = key
        return self.w_q, self.s_w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.recording:
            cur = x.abs().amax().float()
            self.absmax = cur if self.absmax is None else torch.maximum(self.absmax, cur)
            y = F.conv2d(x.float(), self.weight, None, self.stride, self.padding)
            return (y + self.bias[:, None, None]).to(x.dtype)
        s_x = self.act_scale
        if s_x is None and STATIC_ACTIVATION_SCALE is not None:
            s_x = _fixed_scale(STATIC_ACTIVATION_SCALE, x.device)
        elif s_x is None:
            s_x = dynamic_act_scale(x)
        w_q, s_w = self.codes()
        return quant_conv(x, w_q, s_w, self.bias, s_x, self.kernel_size[0], self.stride[0],
                          self.padding[0])


def prepare_capture(net: nn.Module, device: torch.device) -> None:
    """Make, before a CUDA graph captures `net`, what its int8 sites would
    otherwise make inside the capture (where a copy from the host, or a
    buffer made there and kept, breaks or outlives it): every site's codes
    for its current weights, `STATIC_ACTIVATION_SCALE`'s device scalar and
    the divisor of `_over_127`. Recording sites (a calibration) are never
    captured: they raise here."""
    sites = quant_sites(net)
    if not sites:
        return
    if any(m.recording for _, m in sites):
        raise RuntimeError("quant: a net whose sites are recording (a calibration) runs "
                           "eagerly, never in a CUDA graph")
    for _, m in sites:
        m.codes()
    if STATIC_ACTIVATION_SCALE is not None:
        _fixed_scale(STATIC_ACTIVATION_SCALE, device)
    _over_127(torch.ones((), device=device))


def quant_sites(net: nn.Module):
    """`[(name, QuantConv2d)]` of `net`, found once and kept on the net."""
    sites = net.__dict__.get("_quant_sites")
    if sites is None:
        sites = [(name, m) for name, m in net.named_modules() if isinstance(m, QuantConv2d)]
        net.__dict__["_quant_sites"] = sites
    return sites


@contextlib.contextmanager
def static_scales(net: nn.Module, act_scales: Optional[Dict[str, torch.Tensor]]):
    """Every site of `net` uses its static scale from `act_scales` (module
    name -> fp32 device scalar) for the duration; sites without one, or all
    of them when the table is None, run dynamically."""
    sites = quant_sites(net)
    for name, m in sites:
        m.act_scale = act_scales.get(name) if act_scales else None
    try:
        yield
    finally:
        for _, m in sites:
            m.act_scale = None


@contextlib.contextmanager
def recording_absmax(net: nn.Module):
    """Record every site's input absmax over the calls inside the block;
    the yielded dict (module name -> fp32 device scalar) is filled on exit."""
    sites = quant_sites(net)
    for _, m in sites:
        m.recording, m.absmax = True, None
    stats: Dict[str, torch.Tensor] = {}
    try:
        yield stats
    finally:
        for name, m in sites:
            if m.absmax is not None:
                stats[name] = m.absmax
            m.recording, m.absmax = False, None


def calibrate_sampler(model, net: nn.Module, images: torch.Tensor, key: int = 0,
                      num_steps: int = 8, feature_fn=None, feature_net=None, *,
                      prior: Optional[torch.Tensor] = None,
                      gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Per-site input absmax over a short ancestral rollout on `images`
    `[B,H,W,Ci]`: `min(num_steps, T)` subsampled reverse steps with the real
    posterior and one-hot draw (the JAX package's recurrence), each UNet
    call recording its sites while they run the float conv in fp32; the
    elementwise max over the steps. Noise comes from the port's streams of
    `key` (`diffusion/random.py`), or are injected: `prior` `[B,H,W,C]` and
    `gumbel` `[K,B,H,W,C]` (the tests feed the JAX package's draws).
    Returns `{module name: fp32 device scalar}` for
    `DenoisingModel.with_quant_scales`."""
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.diffusion.categorical import sample_onehot, theta_post_prob
    from ccdm_tpu_torch.diffusion.sampling import sample_prior_per_key, subsampled_t_values

    num_steps = min(num_steps, model.time_steps)
    b, h, w, _ = images.shape
    c = model.diffusion.num_classes
    ids = torch.arange(b, device=images.device)
    scales: Optional[Dict[str, torch.Tensor]] = None
    with torch.inference_mode(), fp32_precision():
        fc = feature_fn(feature_net, images) if feature_fn is not None else None
        xt = (sample_prior_per_key(random.element_keys(key, ids, random.PRIOR), h, w, c)
              if prior is None else prior)
        keys = random.element_keys(key, ids, random.CHAIN)
        for i, t_s in enumerate(subsampled_t_values(model.time_steps, num_steps).tolist()):
            t = torch.full((b,), t_s, dtype=torch.int32, device=images.device)
            with recording_absmax(net) as stats:
                p0 = net(xt, images, t, fc)["diffusion_out"].float()
            probs = theta_post_prob(model.diffusion, xt, p0, t).clamp_min(1e-12)
            noise = gumbel[i] if gumbel is not None else random.gumbel(keys, i, probs.shape[1:])
            xt = sample_onehot(probs, gumbel=noise)
            scales = stats if scales is None else {
                k: torch.maximum(scales[k], v) for k, v in stats.items()}
    LOGGER.info("calibrated %d quantized conv sites over %d sampler steps",
                len(scales), num_steps)
    return scales


def calibrate_static_scales(model, net: nn.Module, images: torch.Tensor, feature_fn=None,
                            feature_net=None):
    """Calibrated static scales on `images` -> a model that uses them (build
    the samplers from that model); the scales travel with it."""
    return model.with_quant_scales(calibrate_sampler(
        model, net, images, feature_fn=feature_fn, feature_net=feature_net))
