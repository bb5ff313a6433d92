"""Serving export: the ancestral sampler as a `torch.export` artifact (port
of `ccdm_tpu/utils/serving.py`).

The JAX package serialises its jitted sampler, the T-step `lax.scan`
inside, as one StableHLO program. Exported whole, the port's Python loop
would trace K copies of the UNet, so the artifact holds the sampler cut
into three programs (`eval/lidc_uncertainty.sampler_programs`) and a
manifest, and `load_sampler` walks the t-grid over them:

- `start(images, seed) -> (state, cond[, fc])`: the prior draw, the images
  repeated S times, the DINO map once (the frozen encoder inside);
- `step(state, seed, k, t, cond[, fc]) -> (state, probs)`: one UNet call,
  its posterior and the draw of step k (the UNet's weights, the int8 codes
  and calibrated static scales inside);
- `final(state, probs) -> maps`: the last step's resolution, probabilities
  under `confidence`, the majority one-hot under `majority`.

The weights of each network are stored once: the step holds the UNet's and
the final step's posterior comes out of the step, so no program holds a
second copy. The three hand-written kernels are nodes of the graphs, the
registered ops `ccdm::group_norm`, `ccdm::flash_attention` and
`ccdm::quant_conv`; their launch plans are chosen when they run.

Artifact contract (the JAX package's, `ccdm_tpu/utils/serving.py:10-16`):

    serve(images [B,H,W,Ci] f32, seed int64[2]) -> probs [B,S,H,W,C] f32

`seed` holds the low and high 32-bit words of the run's seed
(`diffusion.random.seed_words`), where JAX's artifact takes a raw
`uint32[2]` key; the maps equal `make_prob_sampler(model, S, K,
feature_fn)(net, images, key=seed)` on the same device. The batch size is
static: one artifact per served batch shape, and one per device: an
artifact exported on the card serves on the card, one exported on the CPU
on the CPU (as a JAX artifact is per platform). A serving process imports
`torch` and `ccdm_tpu_torch.ops`, which registers the kernels, as a JAX
artifact needs the runtime of its custom calls; nothing of the model,
diffusion or config code. Backend flags are not part of a graph, so
`serve` runs every program under `ops.precision.fp32_precision`.
Encoder reuse is not in the artifact (nor in the JAX package's).

The JAX artifact's T steps are one compiled program. Here one step of the
loop is a `StepBody` over device buffers (`t = t_grid[k]`, the `step`
program, the state written back, `k` advanced), which serves two ways:

- an artifact exported on the card replays CUDA graphs of it
  (`_GraphedSteps`): captured once per loaded `serve` (its batch shape is
  fixed), after `ops.graphs.WARMUP_STEPS` eager steps of the first call,
  then all K steps replayed back to back with no host sync between them;
  `start` and `final` run eagerly once a call, their inputs and outputs
  copied in and out of the graph's static buffers. A capture that fails
  raises; nothing falls back to the loop. `serve(..., graphs=False)` walks
  the loop on the card instead;
- an artifact exported on the CPU walks the loop from Python, the plain
  version, calling the same body.

The graphs are made when the artifact is loaded and first served, never
stored: the artifact's format does not change with them.
"""

from __future__ import annotations

import io
import json
import time
import zipfile
from typing import Dict, Optional, Tuple

import torch

FORMAT_VERSION = 1
_PROGRAMS = ("start", "step", "final")


def export_sampler(model, net, image_shape: Tuple[int, int, int], *, num_samples: int,
                   num_steps: Optional[int] = None, batch_size: int = 1, feature_fn=None,
                   feature_net=None) -> bytes:
    """Serialise the ready-to-serve sampler to bytes, on the device `net`'s
    weights lie on. `model`, `net`, `feature_fn` and `feature_net` as for
    `make_prob_sampler` and its call, a calibrated model included
    (`quantized_inference: static` travels inside)."""
    from ccdm_tpu_torch.diffusion import random
    from ccdm_tpu_torch.eval.lidc_uncertainty import sampler_programs
    from ccdm_tpu_torch.ops import quant

    device = next(net.parameters()).device
    start, step, final, t_grid, state = sampler_programs(
        model, net, num_samples, num_steps, feature_fn, feature_net)
    for _, site in quant.quant_sites(net):
        site.codes()  # the int8 codes, derived from the real weights before the trace
    images = torch.zeros(batch_size, *image_shape, device=device)
    seed = random.seed_words(0).to(device)
    k, t = (torch.tensor(v, dtype=torch.int64, device=device) for v in (0, int(t_grid[0])))
    blobs = {}
    # the static scales are the int8 sites' buffers for the duration: the
    # step program holds them as constants
    with torch.no_grad(), quant.static_scales(net, model.act_scales):
        x, *cond = start(images, seed)
        x_next, probs = step(x, seed, k, t, *cond)
        for name, program, args in (("start", start, (images, seed)),
                                    ("step", step, (x, seed, k, t, *cond)),
                                    ("final", final, (x_next, probs))):
            ep = torch.export.export(program, args, strict=False)
            ep.example_inputs = None  # the state of a step is megabytes: keep it out
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            blobs[name] = buf.getvalue()
    manifest = {
        "format": FORMAT_VERSION, "device": device.type, "t_grid": t_grid.tolist(),
        "state": state, "batch": batch_size, "image_shape": list(image_shape),
        "num_samples": num_samples, "num_classes": model.diffusion.num_classes,
        "step_T_sample": model.step_T_sample,
    }
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json", json.dumps(manifest))
        for name, blob in blobs.items():
            z.writestr(f"{name}.pt2", blob)
    return out.getvalue()


def save_sampler(path: str, *args, **kwargs) -> str:
    """`export_sampler` to a file; returns the path."""
    blob = export_sampler(*args, **kwargs)
    with open(path, "wb") as f:
        f.write(blob)
    return path


class StepBody:
    """One served step over device buffers, the unit the CPU's loop calls
    and `_GraphedSteps` captures:

        t = t_grid[k], (x', probs) = step(x, seed, k, t, *cond), x <- x', k <- k + 1

    `x`, `seed`, `k` and `cond` are the body's own buffers (the loop's
    outputs of `start`, or a graph's static copies) and `t_grid` is the
    manifest's on the device, so the host passes no number into a step.
    Returns the step's posterior probabilities."""

    def __init__(self, step, t_grid: torch.Tensor, x: torch.Tensor, seed: torch.Tensor,
                 cond):
        self.step, self.t_grid = step, t_grid
        self.x, self.seed, self.cond = x, seed, tuple(cond)
        self.k = torch.zeros((), dtype=torch.int64, device=x.device)

    def __call__(self) -> torch.Tensor:
        t = self.t_grid.index_select(0, self.k.reshape(1)).reshape(())
        x, probs = self.step(self.x, self.seed, self.k, t, *self.cond)
        self.x.copy_(x)
        self.k.add_(1)
        return probs


class _GraphedSteps:
    """The K steps of a card artifact as replays of one CUDA graph of its
    `StepBody` (see the module docstring). `captures`, `capture_s`,
    `eager_steps` and `replays` count what ran; the kernel wrappers' launch
    counts move at the eager steps and by the captured sites at each
    replay, never at the capture (`ops.graphs`), so they read sites x K.

    The weights, the int8 codes and the static scales are constants of the
    loaded step program, which holds the only reference to them: nothing
    writes them after the load, so unlike `diffusion/sampling.GraphedSampler`
    the graph needs no key over their versions."""

    def __init__(self, step, t_grid: torch.Tensor):
        self.step, self.t_grid = step, t_grid
        self.body: Optional[StepBody] = None
        self.graph = self.probs = self.stream = None
        self.launches: Dict = {}
        self.captures = self.eager_steps = self.replays = 0
        self.capture_s = 0.0

    def __call__(self, x: torch.Tensor, seed: torch.Tensor,
                 cond) -> Tuple[torch.Tensor, torch.Tensor]:
        """The K steps from `start`'s outputs: `(state, last probs)`, the
        graph's static buffers (read them before the next call)."""
        from ccdm_tpu_torch.ops import graphs

        if self.body is None:
            self.body = StepBody(self.step, self.t_grid, torch.empty_like(x),
                                 torch.empty_like(seed), [torch.empty_like(c) for c in cond])
        body = self.body
        body.x.copy_(x)
        body.seed.copy_(seed)
        for static, c in zip(body.cond, cond):
            static.copy_(c)
        body.k.zero_()
        k, done, probs = len(self.t_grid), 0, None
        if self.graph is None:
            done = min(graphs.WARMUP_STEPS, k)
            try:
                probs = self._warm_and_capture(done)
            except BaseException:
                self.graph = self.probs = None  # a failed capture leaves no graph behind
                raise
        for _ in range(k - done):
            self.graph.replay()
            graphs.count_launches(self.launches)
        self.replays += k - done
        return body.x, (probs if done == k else self.probs)

    def _warm_and_capture(self, steps: int) -> torch.Tensor:
        """`steps` eager steps on the capture stream (they build the kernels
        and the cuDNN and cuBLAS handles), then the capture; returns the last
        eager step's probabilities."""
        from ccdm_tpu_torch.ops import graphs

        device = self.body.x.device
        current = torch.cuda.current_stream(device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            for _ in range(steps):
                probs = self.body()
            self.eager_steps += steps
            start = time.perf_counter()
            before = graphs.launch_counts()
            self.graph, self.probs = graphs.capture_graph(
                self.body, self.stream, torch.cuda.graph_pool_handle(), [],
                "the served sampler's step")
            self.launches = graphs.captured_launches(before)
            self.capture_s = time.perf_counter() - start
            self.captures += 1
        current.wait_stream(self.stream)
        return probs


def load_sampler(path_or_bytes):
    """Load an artifact -> `serve(images, seed, *, graphs=True) -> probs
    [B,S,H,W,C]`, on the device it was exported on (a card's artifact raises
    without a card). A card's artifact replays CUDA graphs of its step
    (`serve.graphed`, a `_GraphedSteps`, counts them); `graphs=False` walks
    the loop from Python there, as the CPU does."""
    from ccdm_tpu_torch.ops.precision import fp32_precision  # also registers ccdm::*

    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    with zipfile.ZipFile(src) as z:
        m = json.loads(z.read("manifest.json"))
        if m["format"] != FORMAT_VERSION:
            raise ValueError(f"artifact format {m['format']}, this loader reads {FORMAT_VERSION}")
        if m["device"] == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the artifact was exported on a CUDA card and serves on one")
        start, step, final = (torch.export.load(io.BytesIO(z.read(f"{name}.pt2"))).module()
                              for name in _PROGRAMS)
    device = torch.device(m["device"])
    shape = (m["batch"], *m["image_shape"])
    t_grid = torch.tensor(m["t_grid"], dtype=torch.int64, device=device)
    graphed = _GraphedSteps(step, t_grid) if device.type == "cuda" else None

    def loop(x, seed, cond):
        body = StepBody(step, t_grid, x, seed, cond)
        for _ in range(len(t_grid)):
            probs = body()
        return body.x, probs

    def serve(images: torch.Tensor, seed: torch.Tensor, *, graphs: bool = True) -> torch.Tensor:
        if tuple(images.shape) != shape:
            raise ValueError(f"images {tuple(images.shape)}: this artifact serves {shape}")
        images = images.to(device, torch.float32)
        seed = seed.to(device, torch.int64)
        # the capture too: cuDNN reads the TF32 flags when a graph is recorded
        with torch.inference_mode(), fp32_precision():
            x, *cond = start(images, seed)
            x, probs = (graphed if graphs and graphed else loop)(x, seed, cond)
            maps = final(x, probs)
        return maps.reshape(m["batch"], m["num_samples"], *maps.shape[1:])

    serve.manifest = m
    serve.graphed = graphed
    return serve
