"""Ancestral sampling for categorical diffusion (port of
`ccdm_tpu/diffusion/sampling.py`).

The JAX package runs the reverse process as one `lax.scan` inside
`jax.jit`: one compilation, weights resident. Here one reverse step is a
`StepBody` that reads its step index `k` and its timestep from device
buffers and writes the next state in place, and it runs two ways:

- `ancestral_sampler`, the plain version: the body called K times from a
  Python loop, each op launched from the host. The CPU runs it, and so
  does the card for injected noise and wherever it is asked for;
- `GraphedSampler`, the counterpart of the scan: the body captured as CUDA
  graphs (a drawing step, the last step, and with encoder reuse a full and
  a reuse variant of the drawing step) and replayed K times back to back,
  with no host sync between the replays. It launches what the loop
  launches, with the same arguments, so its maps are the loop's bit for
  bit where the card repeats its sums (cuDNN's deterministic algorithms).

The state layout follows the class count, as in the JAX sampler:

- **index state** (C >= 8, e.g. Cityscapes' C=20): the loop carries int
  class indices `[B,H,W]`; the one-hot UNet input is rebuilt each step, the
  posterior is the index-specialised `theta_post_prob_from_idx`, and each
  draw is inverse-CDF (one uniform per pixel).
- **one-hot state** (narrow C, e.g. LIDC's C=2): a one-hot float carry and
  Gumbel draws.

Either resolves the final step to the argmax ("majority") or the
probabilities ("confidence"). With `encoder_reuse` R > 1 the UNet encoder
runs only on every R-th step and its skip activations are replayed in
between (`DenoisingModel.denoise_fns_cached`).

Noise comes from per-element streams (`diffusion/random.py`): element b's
draw at step k is a pure function of its key and k, as the JAX sampler's
`element_keys`, so a trajectory does not depend on the batch around it.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccdm_tpu_torch.diffusion import random
from ccdm_tpu_torch.diffusion.categorical import (
    CategoricalDiffusion,
    max_prob_onehot,
    sample_categorical_icdf,
    sample_onehot,
    theta_post_prob,
    theta_post_prob_from_idx,
)
from ccdm_tpu_torch.ops import graphs
from ccdm_tpu_torch.ops.precision import fp32_precision
from ccdm_tpu_torch.utils import trace

LOGGER = logging.getLogger(__name__)
# DenoiseFn: (xt [B,H,W,C] one-hot, t [B] int 1-based) -> p0 probs [B,H,W,C].
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class SamplerConfig(NamedTuple):
    """Sampler options; the same fields as the JAX `SamplerConfig`.

    `step_T_sample`: how the final (t==1) step resolves — "majority" takes
    the argmax one-hot, "confidence" returns the posterior probabilities.
    `encoder_reuse`: R; the full UNet runs on steps with `step % R == 0`,
    the cached encoder activations are replayed on the others (1 = off,
    the reference's semantics). `state`: "auto", "index" or "onehot".
    """

    num_steps: int
    step_T_sample: str = "majority"
    encoder_reuse: int = 1
    state: str = "auto"


# The class count from which "auto" picks the index state
# (`ccdm_tpu/diffusion/sampling.py:_INDEX_STATE_MIN_CLASSES`).
_INDEX_STATE_MIN_CLASSES = 8


def _resolve_state(config: SamplerConfig, num_classes: int) -> str:
    if config.state != "auto":
        return config.state
    return "index" if num_classes >= _INDEX_STATE_MIN_CLASSES else "onehot"


def subsampled_t_values(time_steps: int, num_steps: int) -> np.ndarray:
    """The descending timestep grid of a K-of-T step run: the full range when
    K == T, else `round(linspace(T, 1, K))`."""
    if not 0 < num_steps <= time_steps:
        raise ValueError(f"num_steps must be in (0, {time_steps}], got {num_steps}")
    if num_steps == time_steps:
        return np.arange(time_steps, 0, -1, dtype=np.int32)
    return np.array(
        [round(v) for v in np.linspace(time_steps, 1, num_steps)], dtype=np.int32
    )


class _Denoiser:
    """One UNet call per step: the plain `denoise_fn`, or with encoder reuse
    R > 1 the `(full, reuse)` pair — full on `step % R == 0` (it refreshes
    the cached skips), a replay of the cached skips otherwise (`step_plan`)."""

    def __init__(self, denoise_fn, config: SamplerConfig, denoise_pair):
        self.fn = denoise_fn
        self.r = int(config.encoder_reuse)
        if self.r > 1 and denoise_pair is None:
            raise ValueError("encoder_reuse > 1 needs denoise_pair "
                             "(DenoisingModel.denoise_fns_cached)")
        self.pair = denoise_pair
        self.skips = None

    def __call__(self, full: bool, x: torch.Tensor, t: torch.Tensor,
                 keep: bool = True) -> torch.Tensor:
        """p0 of a full call (its skips kept for the replays that follow,
        unless `keep` is False: the last step's are never read) or of a
        replay of the kept skips; `full` as `step_plan` gives it."""
        if self.r == 1:
            return self.fn(x, t)
        full_fn, reuse_fn = self.pair
        if full:
            p0, skips = full_fn(x, t)
            if keep:
                self.skips = skips
            return p0
        return reuse_fn(x, t, self.skips)


def step_plan(num_steps: int, encoder_reuse: int = 1):
    """`[(full, last)]` of each of the K steps, in order: whether the step
    runs the whole UNet (always without reuse, else on `step % R == 0`) and
    whether it is the last. The graphed sampler enqueues its graphs in this
    order."""
    r = int(encoder_reuse)
    return [(r == 1 or step % r == 0, step == num_steps - 1) for step in range(num_steps)]


def ancestral_sampler(
    d: CategoricalDiffusion,
    denoise_fn: DenoiseFn,
    xt: torch.Tensor,
    config: SamplerConfig,
    *,
    element_keys: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    denoise_pair=None,
) -> torch.Tensor:
    """Run the reverse process from `xt ~ q(x_T)` (one-hot `[B,H,W,C]`)
    down to one-hot (majority) or probability (confidence) maps `[B,H,W,C]`.

    Step k's draw uses element b's stream `element_keys[b]` (`[B, 2]`, from
    `random.element_keys`) at step k, or the injected noise the JAX sampler
    drew (the tests feed it): `gumbel[k]` `[K,B,H,W,C]` in the one-hot
    state, `uniforms[k]` `[K,B,H,W]` in the index state. With
    `config.encoder_reuse > 1`, `denoise_pair` is
    `DenoisingModel.denoise_fns_cached`'s `(full, reuse)`. The UNet calls
    run their fp32 convolutions in fp32 (`ops.precision.fp32_precision`).
    """
    with fp32_precision():
        return _ancestral_sampler(d, denoise_fn, xt, config, element_keys=element_keys,
                                  gumbel=gumbel, uniforms=uniforms, denoise_pair=denoise_pair)


class ReverseStep:
    """The parts of one reverse step in a sampler state ("index" or
    "onehot"), shared by `ancestral_sampler`'s loop and the served
    sampler's programs (`eval/lidc_uncertainty.sampler_programs`):

    - `initial(xt)`: the state of a one-hot prior draw;
    - `unet_input(x)`: the one-hot UNet input of a state;
    - `posterior(x, p0, t)`: the posterior probabilities `[B,H,W,C]`;
    - `draw(step, probs)`: the next state, `sample(probs, noise(step,
      probs))`: the noise of element b's stream `element_keys[b]` at
      `step` (an int or a 0-d tensor), or the injected `gumbel[step]` /
      `uniforms[step]`, and the draw that reads it;
    - `finish(x, probs, drew)`: the sampler's output after the last step,
      the drawn state as one-hot where the last step drew (`t > 1`, only for
      K == 1 < T), else the probabilities resolved by `step_T_sample`.
    """

    def __init__(self, d: CategoricalDiffusion, state: str, step_T_sample: str, *,
                 element_keys: Optional[torch.Tensor] = None,
                 gumbel: Optional[torch.Tensor] = None,
                 uniforms: Optional[torch.Tensor] = None):
        self.d, self.state, self.step_T_sample = d, state, step_T_sample
        self.keys, self.gumbel, self.uniforms = element_keys, gumbel, uniforms

    def initial(self, xt: torch.Tensor) -> torch.Tensor:
        return torch.argmax(xt, dim=-1) if self.state == "index" else xt

    def unet_input(self, x: torch.Tensor) -> torch.Tensor:
        return F.one_hot(x, self.d.num_classes).float() if self.state == "index" else x

    def posterior(self, x: torch.Tensor, p0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.state == "index":
            return theta_post_prob_from_idx(self.d, x, p0.float(), t).clamp_min(1e-12)
        return theta_post_prob(self.d, x, p0.float(), t).clamp_min(1e-12)

    def noise(self, step, probs: torch.Tensor) -> torch.Tensor:
        """Uniforms `[N,H,W]` (index state) or Gumbel noise `[N,H,W,C]`."""
        if self.state == "index":
            return (_at(self.uniforms, step) if self.uniforms is not None
                    else random.uniform(self.keys, step, probs.shape[1:-1]))
        return (_at(self.gumbel, step) if self.gumbel is not None
                else random.gumbel(self.keys, step, probs.shape[1:]))

    def sample(self, probs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if self.state == "index":
            return sample_categorical_icdf(probs, noise)
        return sample_onehot(probs, gumbel=noise)

    def draw(self, step, probs: torch.Tensor) -> torch.Tensor:
        return self.sample(probs, self.noise(step, probs))

    def finish(self, x: torch.Tensor, probs: torch.Tensor, drew: bool) -> torch.Tensor:
        if drew:
            return self.unet_input(x)
        if self.step_T_sample == "confidence":
            return probs
        return max_prob_onehot(probs)  # "majority" (also the reference's default)


def _at(noise: torch.Tensor, step) -> torch.Tensor:
    """`noise[step]`, with `step` an int or a 0-d int64 tensor on noise's
    device (read there, without a host sync)."""
    if isinstance(step, torch.Tensor):
        return noise.index_select(0, step.reshape(1))[0]
    return noise[step]


class StepBody:
    """One reverse step over device buffers, the unit that `ancestral_sampler`
    loops over and `GraphedSampler` captures:

        t = t_grid[k] (for every element), p0 = UNet(x, t),
        probs = posterior(x, p0, t), x <- draw(k, probs), k <- k + 1

    `k` (0-d int64) and `t_grid` (int32 `[K]`) live on x's device, and the
    draw reads its step as a tensor (`random.bits`), so the host passes no
    number into a step: what varies between steps is only which UNet call
    runs (`full`, with encoder reuse) and whether the step is the last.
    The last step draws only where `t_grid[-1] > 1` (K == 1 < T) and
    returns `ReverseStep.finish`'s maps; the others return None. `x`, the
    carried state, is written in place.

    With tracing on (`utils/trace.py`) the step records a device mark at
    its start and after each part, so the gaps are its parts' device ms:
    `unet` (the timestep, the one-hot input, the UNet call), `posterior`,
    `noise` (the Threefry stream; absent where the step does not draw) and
    `draw` (the draw, its copy into the state, k's increment)."""

    def __init__(self, rs: ReverseStep, denoise: _Denoiser, t_grid: np.ndarray,
                 x: torch.Tensor):
        self.rs, self.denoise, self.x = rs, denoise, x
        self.t_grid = torch.as_tensor(np.asarray(t_grid, np.int32)).to(x.device)
        self.k = torch.zeros((), dtype=torch.int64, device=x.device)
        self.drew_last = int(t_grid[-1]) > 1

    def __call__(self, full: bool, last: bool) -> Optional[torch.Tensor]:
        rs, x, k = self.rs, self.x, self.k
        trace.mark("step", x.device)
        t = self.t_grid.index_select(0, k.reshape(1)).repeat(x.shape[0])
        p0 = self.denoise(full, rs.unet_input(x), t, keep=not last)
        trace.mark("unet", x.device)
        probs = rs.posterior(x, p0, t)
        trace.mark("posterior", x.device)
        if not last or self.drew_last:
            noise = rs.noise(k, probs)
            trace.mark("noise", x.device)
            x.copy_(rs.sample(probs, noise))
        k.add_(1)
        trace.mark("draw", x.device)
        return rs.finish(x, probs, self.drew_last) if last else None


def _ancestral_sampler(d: CategoricalDiffusion, denoise_fn: DenoiseFn, xt: torch.Tensor,
                       config: SamplerConfig, *, element_keys, gumbel, uniforms,
                       denoise_pair) -> torch.Tensor:
    t_grid = subsampled_t_values(d.time_steps, config.num_steps)
    k = len(t_grid)
    if gumbel is not None and gumbel.shape != (k, *xt.shape):
        raise ValueError(f"gumbel must be [K,*xt.shape] = {(k, *xt.shape)}, "
                         f"got {tuple(gumbel.shape)}")
    if uniforms is not None and uniforms.shape != (k, *xt.shape[:-1]):
        raise ValueError(f"uniforms must be [K,*xt.shape[:-1]] = {(k, *xt.shape[:-1])}, "
                         f"got {tuple(uniforms.shape)}")
    state = _resolve_state(config, xt.shape[-1])
    if state not in ("index", "onehot"):
        raise ValueError(f"unknown sampler state {config.state!r}")
    denoise = _Denoiser(denoise_fn, config, denoise_pair)
    if element_keys is None and (uniforms if state == "index" else gumbel) is None:
        raise ValueError(f"the {state} state draws its noise from element_keys or from "
                         f"injected {'uniforms' if state == 'index' else 'gumbel'} noise")
    rs = ReverseStep(d, state, config.step_T_sample, element_keys=element_keys,
                     gumbel=gumbel, uniforms=uniforms)
    body = StepBody(rs, denoise, t_grid, rs.initial(xt).clone())
    for full, last in step_plan(k, config.encoder_reuse):
        out = body(full, last)
    return out


def _storage_state(net: torch.nn.Module):
    """`(parameter pointers, their versions, buffers' pointers and versions)`
    of `net`: a graph reads them at the addresses it was captured with, and
    a weight written in place (an EMA written for validation) moves its
    version, which the int8 sites' codes, buffers, follow
    (`ops/quant.QuantConv2d.codes`)."""
    params = list(net.parameters())
    return (tuple(p.data_ptr() for p in params), tuple(p._version for p in params),
            tuple((b.data_ptr(), 0 if b.is_inference() else b._version)
                  for b in net.buffers()))


class _Captured:
    """The graphs of one cache key (see `GraphedSampler`): static buffers for
    the state, the chain keys and the conditioning, the step body over them,
    `graphs[(full, last)] = (graph, launches a replay)`, and, where tracing
    was on at the capture, `marks[(full, last)]`: each graph's step marks."""

    def __init__(self, d: CategoricalDiffusion, config: SamplerConfig, state: str,
                 t_grid: np.ndarray, xt: torch.Tensor, element_keys: torch.Tensor,
                 inputs: Dict[str, torch.Tensor], make_denoise):
        self.stream: Optional[torch.cuda.Stream] = None  # made at the first warm-up
        self.keys = torch.empty_like(element_keys)
        self.inputs = {name: torch.empty_like(v) for name, v in inputs.items()}
        rs = ReverseStep(d, state, config.step_T_sample, element_keys=self.keys)
        fn, pair = make_denoise(self.inputs)
        self.body = StepBody(rs, _Denoiser(fn, config, pair), t_grid,
                             torch.empty_like(rs.initial(xt)))
        self.plan = step_plan(len(t_grid), config.encoder_reuse)
        self.graphs: Dict = {}
        self.marks: Dict = {}
        self.out: Optional[torch.Tensor] = None
        self.warmed = False

    def load(self, xt: torch.Tensor, element_keys: torch.Tensor,
             inputs: Dict[str, torch.Tensor]) -> None:
        """This call's prior, keys and conditioning into the static buffers,
        and k to 0, on the current stream."""
        body = self.body
        body.x.copy_(body.rs.initial(xt))
        self.keys.copy_(element_keys)
        for name, v in inputs.items():
            self.inputs[name].copy_(v)
        body.k.zero_()


def graph_label(full: bool, last: bool) -> str:
    """A step graph's name among the sets of marks a traced call attaches."""
    return "graph.last" if last else "graph.drawing" if full else "graph.reuse"


class GraphedSampler:
    """`ancestral_sampler` on the card as CUDA graphs of its `StepBody`: the
    port of the JAX sampler's `lax.scan` inside `jax.jit`.

    `sampler(net, xt, element_keys, inputs, make_denoise)` runs the reverse
    process from the prior `xt` with chain keys `element_keys`, conditioned
    on `inputs` (name -> tensor: the images repeated S times, the DINO map),
    and returns the maps, as `ancestral_sampler` does.
    `make_denoise(static_inputs)` gives `(denoise_fn, denoise_pair)` over
    static copies of `inputs` (`denoise_pair` None without encoder reuse),
    calling `net`.

    Graphs are cached per key: the device, the state, R, the t-grid, the
    shapes and dtypes of `xt`, the keys and `inputs`, whether tracing is on
    (a traced capture holds the step's marks), and the storage and versions
    of `net`'s parameters and buffers (a weight written in place is a new
    key). The first call of a key runs the first `WARMUP_STEPS` steps
    eagerly on the capture stream (real steps of its trajectory: they build
    the kernels and the cuDNN and cuBLAS handles, and under R > 1 both UNet
    variants), then captures, on that stream and one private memory pool, a
    graph for each `(full, last)` kind of `step_plan`: the drawing step (the
    full one first: its skips are the buffers the reuse graph reads), with
    R > 1 the reuse drawing step, and the last step. It then replays the
    rest; later calls replay all K steps. The replays are enqueued back to
    back on the current stream, with no host sync and no copy from the host
    between them. A key whose weights were written in place is dropped (it
    can never be hit again); past `MAX_KEYS` the oldest is dropped.

    A capture that fails raises (`ops.graphs.capture_graph`). The capture
    runs under `fp32_precision`, as the eager loop: cuDNN reads the TF32
    flags when the graph is recorded. The kernel wrappers' launch counts
    move at the warm-up steps and at each replay, by the sites the graphs
    recorded, never at a capture. `captures` (keys), `capture_s` (seconds
    of each), `graphs_captured` (step bodies a capture ran in Python without
    launching them), `eager_steps` and `replays` count what ran.

    Spans (`utils/trace.py`): `sampler.load`, `sampler.capture` (a first
    call's eager steps and captures) and `sampler.steps` (the replays),
    which a traced call hands the graphs' marks (`graph.drawing`,
    `graph.reuse`, `graph.last`: each graph's last replay). `capture_s`
    stays beside `sampler.capture`: it is kept with tracing off too and
    logged, and times the captures alone, where the span also holds the
    eager warm-up steps, which a call's host time outside its steps leaves
    out with the captures."""

    MAX_KEYS = 3  # a run's full batch, its short last batch, one more

    def __init__(self, d: CategoricalDiffusion, config: SamplerConfig):
        self.d, self.config = d, config
        self.t_grid = subsampled_t_values(d.time_steps, config.num_steps)
        self.captures = self.graphs_captured = self.eager_steps = self.replays = 0
        self.capture_s = []
        self._cache: "collections.OrderedDict[tuple, _Captured]" = collections.OrderedDict()

    def key(self, net: torch.nn.Module, xt: torch.Tensor, element_keys: torch.Tensor,
            inputs: Dict[str, torch.Tensor]) -> tuple:
        """`(shapes, *_storage_state(net))`: the cache key of a call."""
        shapes = (xt.device, _resolve_state(self.config, xt.shape[-1]),
                  int(self.config.encoder_reuse), tuple(self.t_grid.tolist()),
                  tuple(xt.shape), xt.dtype, tuple(element_keys.shape),
                  tuple((name, tuple(v.shape), v.dtype) for name, v in sorted(inputs.items())),
                  trace.enabled())
        return (shapes, *_storage_state(net))

    def __call__(self, net: torch.nn.Module, xt: torch.Tensor, element_keys: torch.Tensor,
                 inputs: Dict[str, torch.Tensor], make_denoise) -> torch.Tensor:
        if xt.device.type != "cuda":
            raise ValueError(f"GraphedSampler: xt is on {xt.device}; CUDA graphs run on the "
                             f"card (the CPU takes ancestral_sampler)")
        key = self.key(net, xt, element_keys, inputs)
        entry = self._cache.get(key)
        if entry is None:
            entry = self._add(key, xt, element_keys, inputs, make_denoise)
        self._cache.move_to_end(key)
        with fp32_precision():
            with trace.span("sampler.load"):
                entry.load(xt, element_keys, inputs)
            start = 0
            if not entry.graphs:
                k = len(self.t_grid)
                # K == 1: the only step is the last, so the first call runs
                # it eagerly and the next call captures
                start = 0 if entry.warmed else k if k == 1 else min(graphs.WARMUP_STEPS, k - 1)
                try:
                    with trace.span("sampler.capture"):
                        out = self._warm_and_capture(entry, start, capture=start < k)
                except BaseException:
                    del self._cache[key]  # a capture that failed leaves no graphs behind
                    raise
                if start == k:
                    return out.clone()
            with trace.span("sampler.steps"):
                for full, last in entry.plan[start:]:
                    graph, launches = entry.graphs[full, last]
                    graph.replay()
                    graphs.count_launches(launches)
                for (full, last), marks in entry.marks.items():
                    trace.attach(graph_label(full, last), marks)
            self.replays += len(entry.plan) - start
            return entry.out.clone()

    def _add(self, key, xt, element_keys, inputs, make_denoise) -> _Captured:
        _, pointers, versions, _ = key
        for old in [k for k in self._cache if k[1] == pointers and k[2] != versions]:
            del self._cache[old]  # weights written in place since: never hit again
        while len(self._cache) >= self.MAX_KEYS:
            self._cache.popitem(last=False)
        entry = self._cache[key] = _Captured(
            self.d, self.config, _resolve_state(self.config, xt.shape[-1]), self.t_grid, xt,
            element_keys, inputs, make_denoise)
        return entry

    def _warm_and_capture(self, entry: _Captured, steps: int, capture: bool):
        """The first `steps` steps eagerly on the capture stream, then (if
        `capture`) the graphs; returns the maps where the eager steps were
        all of them."""
        device = entry.body.x.device
        current = torch.cuda.current_stream(device)
        if entry.stream is None:
            entry.stream = torch.cuda.Stream(device)
        entry.stream.wait_stream(current)
        out = None
        with torch.cuda.stream(entry.stream):
            for full, last in entry.plan[:steps]:
                out = entry.body(full, last)
            self.eager_steps += steps
            entry.warmed = True
            if capture:
                self._capture(entry)
        current.wait_stream(entry.stream)
        return out

    def _capture(self, entry: _Captured) -> None:
        start = time.perf_counter()
        body, denoise = entry.body, entry.body.denoise
        eager_skips = denoise.skips
        pool = torch.cuda.graph_pool_handle()
        # the full drawing step first: the skips it returns are the static
        # buffers the reuse graph is captured reading
        for kind in sorted(set(entry.plan), key=lambda fl: (not fl[0], fl[1])):
            full, last = kind
            before = graphs.launch_counts()
            what = (f"the sampler's {'last' if last else 'drawing'} step"
                    + ("" if denoise.r == 1 else " (full UNet)" if full else " (encoder reuse)"))
            with trace.marking(trace.Marks()) as marks:
                graph, out = graphs.capture_graph(lambda: body(full, last), entry.stream, pool,
                                                  [], what)
            entry.graphs[kind] = (graph, graphs.captured_launches(before))
            if marks.names:
                entry.marks[kind] = marks
            if last:
                entry.out = out
        if eager_skips is not None and denoise.skips is not eager_skips:
            # a reuse step right after the warm-up reads the eager skips
            for static, eager in zip(denoise.skips, eager_skips):
                static.copy_(eager)
        self.captures += 1
        self.graphs_captured += len(entry.graphs)
        self.capture_s.append(time.perf_counter() - start)
        LOGGER.info("sampler: captured %d CUDA graphs (K %d, R %d, state %s, x %s) in %.3f s",
                    len(entry.graphs), len(entry.plan), denoise.r, body.rs.state,
                    tuple(body.x.shape), self.capture_s[-1])


def sample_prior_per_key(keys: torch.Tensor, height: int, width: int,
                         num_classes: int) -> torch.Tensor:
    """`x_T` from the uniform categorical prior, one-hot `[B,H,W,C]`, element
    b drawn from its stream `keys[b]` (step 0 of the `PRIOR` stream's keys
    in the samplers)."""
    return F.one_hot(random.randint(keys, 0, (height, width), num_classes),
                     num_classes).float()
