"""The training step (port of `ccdm_tpu/train/step.py`): forward, KL loss,
gradients, update, EMA.

- `t ~ U{1..T}` per sample; `x_t ~ q(x_t | x_0)`, a Gumbel-max draw;
- the UNet predicts an x0 distribution (in fp32 for the loss);
- loss = `KL(theta_post(x_t, x_0, t) ‖ theta_post_prob(x_t, x0pred, t))`
  with the 1e-12 clamp, weighted per pixel by `class_weights[argmax x0]`,
  summed over pixels, divided by the batch;
- `invalid`: a non-finite loss or `min KL < -1e-3` (the reference's
  `_check_loss`), and `kl_min`.

Draws come from the step function's own `torch.Generator`, reseeded from
`(seed, step)` before each step, so a resumed run draws what an
uninterrupted one would (the JAX version folds the step into its key).
`train_loss` also takes injected `t` and `x_t`. The metrics stay on the
device; the trainer reads them two launches later.

Launches (the JAX package's `jax.jit` of the step and `make_multi_step`'s
`lax.scan` of K steps): on the card the trainer runs the step as a replay
of a CUDA graph of it (`GraphedTrainStep`), captured once after warm-up
steps, and `make_multi_step` enqueues K steps back to back, with no host
sync between them. The CPU runs the eager step, the plain version the
tests hold against the JAX package. The graph replays what the eager step
launches, with the same arguments: the draws' seeds and the optimizer's
scalars are device values written before each replay, so replays are bit
for bit the eager steps.

The forward and the backward run under `ops.precision.fp32_precision`:
fp32 convolutions (the output heads) in fp32, not in PyTorch's default TF32.

DINO conditioning, as the JAX step: a frozen encoder (`feature_fn`) maps
the batch's images under `torch.no_grad()` (the JAX `stop_gradient`); a
trainable one (`encoder_apply`) runs under autograd, and its gradients join
the UNet's in one composite update (`train/state.py`).

Data parallel (a process group of P ranks, `parallel/mesh.py`): rank p
holds rows `p::P` of the global batch (`data/loader.py`). It draws `t` and
the Gumbel noise of `x_t` for the whole global batch from the step's
generator and keeps its rows, so the step equals the one-process step on
the global batch example for example. After the backward the fp32
gradients, with the loss, travel as one flat fp32 buffer through one
`all_reduce` and are divided by P, before `grad_norm` and the update; the
minimum KL and the invalid flag are reduced too, so every rank logs the
same loss and raises at the same step. The gradients are reduced in fp32
and outside the module, so `net` is not wrapped in
`DistributedDataParallel` (which would reduce the bf16 copies). Dropout
masks draw from `(seed, step, rank)` on rank > 0, so they are not the
one-process run's. A gloo collective cannot be captured, so the graphed
step is then two graphs, the gradients into the flat buffer and the
update, with the all-reduce run eagerly between them.

Over a `data x model` mesh (`parallel/mesh.py`, `parallel/tensor.py`) the
rows, the draws and the dropout masks follow the data index, not the rank:
every rank of a model group takes the same rows, `t`, noise and masks, as
its activations are whole. A leaf the model axis splits has its gradient
(this rank's share) summed over the data group and divided by the data
count; every other leaf's gradient, and the loss, over all ranks and
divided by the world size, which keeps the whole leaves' masters equal on
every rank even where cuDNN's weight gradients are not deterministic.
`grad_norm` is the global norm: the split leaves' squares summed over the
model group, each whole leaf counted once. The forward of a split layer
holds collectives, so this step runs eagerly (`trainer.py`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ccdm_tpu_torch.diffusion.categorical import (
    categorical_kl,
    gumbel_noise,
    q_xt_given_x0_probs,
    sample_onehot,
    theta_post,
    theta_post_prob,
)
from ccdm_tpu_torch.models.builder import DenoisingModel
from ccdm_tpu_torch.ops import group_norm as gn
# WARMUP_STEPS and capture_graph are re-exported: the tools and tests import them here
from ccdm_tpu_torch.ops.graphs import (  # noqa: F401
    WARMUP_STEPS,
    capture_graph,
    captured_launches,
    count_launches,
    launch_counts,
)
from ccdm_tpu_torch.parallel import mesh
from ccdm_tpu_torch.train.state import ENCODER, UNET, TrainState
from ccdm_tpu_torch.ops.precision import fp32_precision


def step_seed(seed: int, step: int) -> int:
    """A 64-bit generator seed for one step of a run seeded with `seed`."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def train_loss(model: DenoisingModel, net: torch.nn.Module, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], class_weights: torch.Tensor,
               feature_condition: Optional[torch.Tensor] = None, *,
               t: Optional[torch.Tensor] = None, xt: Optional[torch.Tensor] = None,
               rows: slice = slice(None), global_batch: Optional[int] = None):
    """The CCDM loss of one batch (`image` [B,H,W,Ci], `x0` one-hot
    [B,H,W,C]; `feature_condition` [B,h,w,Cf] where the UNet concatenates
    one) -> `(loss, aux)`; `t` and `xt`, when given, replace the draws.
    The draws are made for `global_batch` examples (default B), of which
    the batch is `rows`."""
    image, x0 = batch["image"], batch["x0"]
    b = x0.shape[0]
    d = model.diffusion
    shape = (global_batch or b, *x0.shape[1:])
    if t is None:
        t = torch.randint(1, d.time_steps + 1, shape[:1], generator=generator,
                          device=x0.device)[rows]
    if xt is None:
        gumbel = gumbel_noise(shape, generator, x0.device)[rows]
        xt = sample_onehot(q_xt_given_x0_probs(d, x0, t), gumbel=gumbel)
    x0pred = model.apply(net, xt, image, t, feature_condition)["diffusion_out"].float()
    kl = categorical_kl(theta_post_prob(d, xt, x0pred, t), theta_post(d, xt, x0, t))
    mask = class_weights[x0.argmax(dim=-1)]
    loss = (kl * mask).sum() / b
    kl_min = kl.detach().min()
    invalid = ~torch.isfinite(loss.detach()) | (kl_min < -1e-3)
    return loss, {"kl_min": kl_min, "invalid": invalid}


def _flatten(grads: Dict[str, torch.Tensor], loss: torch.Tensor, aux: Dict[str, torch.Tensor]):
    """What the ranks reduce: `(flat, worst)`, the fp32 gradients and the
    loss in one buffer, and `[-kl_min, invalid]`."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()] + [loss.reshape(1)])
    worst = torch.stack([-aux["kl_min"].float(), aux["invalid"].float()])
    return flat, worst


def _all_reduce(flat: torch.Tensor, worst: torch.Tensor) -> None:
    """The sum of `flat` and the maximum of `worst` over the ranks, in place."""
    import torch.distributed as dist

    dist.all_reduce(flat)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)


def _unflatten(flat: torch.Tensor, worst: torch.Tensor, grads: Dict[str, torch.Tensor],
               count: int):
    """The reduced `(grads, loss, aux)` from the summed buffers: the mean
    gradients (views of `flat`, named and shaped as `grads`) and loss, the
    minimum `kl_min` and any `invalid`."""
    flat /= count
    out, offset = {}, 0
    for name, g in grads.items():
        out[name] = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
    return out, flat[-1], {"kl_min": -worst[0], "invalid": worst[1] > 0}


def _reduce_gradients(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                      aux: Dict[str, torch.Tensor], count: int):
    """The mean over the ranks of `grads` and `loss` (one flat fp32 buffer,
    one sum), the minimum of `kl_min` and the maximum of `invalid`: new
    `(grads, loss, aux)`, the same on every rank."""
    flat, worst = _flatten(grads, loss, aux)
    _all_reduce(flat, worst)
    return _unflatten(flat, worst, grads, count)


def _reduce_split(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                  aux: Dict[str, torch.Tensor], split, layout: mesh.Mesh):
    """`_reduce_gradients` over a mesh with a model axis (see the module
    docstring): the whole leaves and the loss over all ranks, the shares of
    the `split` leaves over the data group."""
    import torch.distributed as dist

    whole = {k: g for k, g in grads.items() if k not in split}
    whole, loss, aux = _reduce_gradients(whole, loss, aux, mesh.process_count())
    shares = {k: g for k, g in grads.items() if k in split}
    if shares and layout.data_count > 1:
        flat = torch.cat([g.reshape(-1) for g in shares.values()])
        dist.all_reduce(flat, group=layout.data_group)
        flat /= layout.data_count
        offset = 0
        for name, g in shares.items():
            shares[name] = flat[offset:offset + g.numel()].view_as(g)
            offset += g.numel()
    return {k: whole[k] if k in whole else shares[k] for k in grads}, loss, aux


class TrainStep:
    """The eager train step that `make_train_step` returns (see there), in
    parts that `GraphedTrainStep` captures: `seeded` (host), `local_gradients`
    and `finish` (device), `_reduce_gradients` between them in a process
    group."""

    def __init__(self, model: DenoisingModel, class_weights: torch.Tensor,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 feature_fn: Optional[Callable] = None,
                 encoder_apply: Optional[Callable] = None, sharding=None):
        self.model, self.class_weights, self.lr_schedule = model, class_weights, lr_schedule
        self.feature_fn, self.encoder_apply = feature_fn, encoder_apply
        self.dropout_on = any(isinstance(m, torch.nn.Dropout) and m.p > 0
                              for m in model.unet.modules())
        self.layout = sharding.layout if sharding is not None else mesh.current()
        # rows and draws by data index: a model group's ranks take the same
        self.rank, self.ranks = self.layout.data_index, self.layout.data_count
        # master names the model axis splits
        self.split = frozenset(sharding.dims if sharding is not None else ())
        self._generators: Dict[torch.device, torch.Generator] = {}

    def generator(self, device: torch.device) -> torch.Generator:
        """The step's generator on `device`, made once: a CUDA graph
        registers it and reads its seed at every replay."""
        device = torch.device(device)
        if device not in self._generators:
            self._generators[device] = torch.Generator(device=device)
        return self._generators[device]

    @contextlib.contextmanager
    def seeded(self, step: int, seed: int, device: torch.device):
        """The draws of step `step`: the step's generator reseeded from
        `(seed, step)`; with dropout, the default generator forked and
        seeded from it (and the data index) for the block."""
        s = step_seed(seed, step)
        self.generator(device).manual_seed(s)
        if not self.dropout_on:
            yield
            return
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(s if self.rank == 0 else step_seed(s, self.rank))
            yield

    def local_gradients(self, net: torch.nn.Module, batch: Dict[str, torch.Tensor],
                        encoder_net: Optional[torch.nn.Module] = None, *,
                        t: Optional[torch.Tensor] = None, xt: Optional[torch.Tensor] = None):
        """The forward and backward of this rank's `batch` with the seeded
        draws: `(grads, loss, aux)`, the fp32 gradients by master name. On
        the device alone (no host sync), so a graph may capture it."""
        modules = ({"": net} if self.encoder_apply is None
                   else {UNET: net, ENCODER: encoder_net})
        device = batch["x0"].device
        net.train()  # dropout where the UNet has any; remat where its keys ask
        for m in modules.values():
            m.zero_grad(set_to_none=True)
        # forward and backward in fp32 where the model computes in fp32 (the
        # output heads): TF32 there cost the LIDC gate its quality
        with fp32_precision():
            fc = None
            if self.encoder_apply is not None:
                fc = self.encoder_apply(encoder_net, batch["image"])
            elif self.feature_fn is not None:
                with torch.no_grad():
                    fc = self.feature_fn(encoder_net, batch["image"])
            b = batch["x0"].shape[0]
            loss, aux = train_loss(self.model, net, batch, self.generator(device),
                                   self.class_weights, fc, t=t, xt=xt,
                                   rows=slice(self.rank, None, self.ranks),
                                   global_batch=b * self.ranks)
            loss.backward()
        grads = {prefix + name: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                 for prefix, m in modules.items() for name, p in m.named_parameters()}
        for m in modules.values():
            m.zero_grad(set_to_none=True)
        return grads, loss.detach(), aux

    def metrics(self, grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                aux: Dict[str, torch.Tensor], num_items: int) -> Dict[str, object]:
        norms = torch.stack(torch._foreach_norm(list(grads.values())))
        if self.split:  # the shares' squares over the model group, whole leaves once
            share = torch.tensor([k in self.split for k in grads], device=norms.device)
            squares = norms.square()
            grad_norm = (mesh.all_reduce_sum(squares[share].sum(), self.layout.model_group)
                         + squares[~share].sum()).sqrt()
        else:
            grad_norm = torch.linalg.vector_norm(norms)
        return {"loss": loss, "invalid": aux["invalid"], "kl_min": aux["kl_min"],
                "grad_norm": grad_norm, "num_items": num_items}

    def write(self, state: TrainState, net: torch.nn.Module,
              encoder_net: Optional[torch.nn.Module]) -> None:
        """The new masters into the modules."""
        state.write_to(net, prefix=UNET if self.encoder_apply is not None else "")
        if self.encoder_apply is not None:
            state.write_to(encoder_net, prefix=ENCODER)

    def gradients(self, state: TrainState, net: torch.nn.Module, batch: Dict[str, torch.Tensor],
                  seed: int, encoder_net: Optional[torch.nn.Module] = None, *,
                  t: Optional[torch.Tensor] = None, xt: Optional[torch.Tensor] = None):
        """`(grads, metrics)` of the step, without updating: the reduced fp32
        gradients by master name."""
        with self.seeded(state.step, seed, batch["x0"].device):
            grads, loss, aux = self.local_gradients(net, batch, encoder_net, t=t, xt=xt)
        if self.layout.model_count > 1:
            grads, loss, aux = _reduce_split(grads, loss, aux, self.split, self.layout)
        elif self.ranks > 1:
            grads, loss, aux = _reduce_gradients(grads, loss, aux, self.ranks)
        return grads, self.metrics(grads, loss, aux, batch["x0"].shape[0] * self.ranks)

    def __call__(self, state: TrainState, net: torch.nn.Module, batch: Dict[str, torch.Tensor],
                 seed: int, encoder_net: Optional[torch.nn.Module] = None, *,
                 t: Optional[torch.Tensor] = None,
                 xt: Optional[torch.Tensor] = None) -> Dict[str, object]:
        grads, metrics = self.gradients(state, net, batch, seed, encoder_net, t=t, xt=xt)
        lr = state.apply_gradients(grads)
        self.write(state, net, encoder_net)
        if self.lr_schedule is not None:
            metrics["lr"] = lr
        return metrics


def make_train_step(model: DenoisingModel, class_weights: torch.Tensor,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    feature_fn: Optional[Callable] = None,
                    encoder_apply: Optional[Callable] = None, sharding=None) -> TrainStep:
    """`step(state, net, batch, seed, encoder_net=None, *, t=None, xt=None)
    -> metrics`: one update of `state` (in place) from the gradients of
    `net`, the module that holds the compute-dtype copy of the state's
    masters; the new masters are then written into `net`. Dropout runs in
    training mode when the UNet has any, drawing from the global generator
    forked and seeded from `(seed, step)`.

    `feature_fn(encoder_net, images)`: a frozen encoder, outside the state.
    `encoder_apply(encoder_net, images)`: a trainable one, whose masters are
    the state's `encoder.` entries (the UNet's are `unet.`); it is updated
    with the UNet and `grad_norm` covers both.

    Inside a process group of P ranks (read when the step is made), `batch`
    is this rank's rows `p::P` of the global batch, injected `t` and `xt`
    are this rank's too, and the gradients are summed over the ranks (see
    the module docstring). `step.gradients(...)`, with the step's arguments,
    returns `(grads, metrics)` without updating: the reduced fp32
    gradients by master name.

    With a `sharding` (`parallel.tensor.Sharding`: the mesh and the masters
    whose shares this rank holds), `batch` is the rows of this rank's data
    index and the reductions are the model axis's (see the module
    docstring); without one, the mesh `parallel.mesh.make_mesh` made last
    (all data unless one was made)."""
    return TrainStep(model, class_weights, lr_schedule, feature_fn, encoder_apply, sharding)


def make_multi_step(step_fn: Callable) -> Callable:
    """`multi(state, net, batches, seed, encoder_net=None) -> metrics`: one
    launch of K = `len(batches)` steps of `step_fn` (port of
    `ccdm_tpu/train/step.py::make_multi_step`). Each step folds its own
    `state.step` into its draws, so one launch of K and K launches of 1 give
    the same trajectory bit for bit. Metrics: the last step's, `loss_mean`
    over the K steps and `invalid` if any step's was. With a
    `GraphedTrainStep` the launch is K replays enqueued back to back with no
    host sync between them; on the CPU, K eager steps."""

    def multi(state: TrainState, net: torch.nn.Module, batches: List[Dict[str, torch.Tensor]],
              seed: int, encoder_net: Optional[torch.nn.Module] = None) -> Dict[str, object]:
        ms = [step_fn(state, net, batch, seed, encoder_net) for batch in batches]
        metrics = dict(ms[-1])
        metrics["invalid"] = torch.stack([m["invalid"] for m in ms]).any()
        metrics["loss_mean"] = torch.stack([m["loss"] for m in ms]).mean()
        return metrics

    return multi


class GraphedTrainStep:
    """`step` (a `TrainStep`) on the card as replays of CUDA graphs of it,
    called as the eager step is (`t` and `xt` are not injected).

    The first `WARMUP_STEPS` calls are eager steps on the step's own stream
    (real steps of the run: they build the kernels, the cuDNN and cuBLAS
    handles and the autograd state). The next call captures the step on
    that stream into one graph (two in a process group: the gradients into
    the flat buffer, then the update, with the all-reduce eager between
    them), with static buffers for the batch and the step's generator
    registered, and then replays it, as every later call does. A capture
    records and runs nothing: the host's counts (`TrainState.advance`) and
    the kernel wrappers' launch counts move only at a replay, by what the
    capture recorded. The GroupNorm backward launches in the graph keep the
    completion counter of the step's stream (`ops/group_norm._counter`),
    which no launch outside the graph uses after the capture: a replay on
    any stream cannot race with eager backward launches.

    A replay, on the current stream: the batch copied into the static
    buffers, the optimizer's scalars filled (`TrainState.prepare_update`),
    the generators reseeded (`TrainStep.seeded`), the graph launched, the
    counts advanced, and the metrics cloned out of the graph's static
    outputs, which the next replay overwrites. `eager_steps`, `captures`,
    `replays` and `capture_s` count what ran."""

    def __init__(self, step: TrainStep):
        self.step = step
        self.eager_steps = self.captures = self.replays = 0
        self.capture_s = 0.0
        self.graphs: List = []
        self.stream: Optional[torch.cuda.Stream] = None
        self._static: Dict[str, torch.Tensor] = {}
        self._outputs: Dict[str, object] = {}
        self._between = None  # the flat buffers the all-reduce sums
        self._launches: Dict = {}  # the wrappers' launches a replay makes

    def __call__(self, state: TrainState, net: torch.nn.Module, batch: Dict[str, torch.Tensor],
                 seed: int, encoder_net: Optional[torch.nn.Module] = None) -> Dict[str, object]:
        device = batch["x0"].device
        if device.type != "cuda":
            raise ValueError(f"GraphedTrainStep: the batch is on {device}; CUDA graphs run on "
                             f"the card (the CPU takes the eager step)")
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        if not self.graphs and self.eager_steps < WARMUP_STEPS:
            current = torch.cuda.current_stream(device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                metrics = self.step(state, net, batch, seed, encoder_net)
            current.wait_stream(self.stream)
            self.eager_steps += 1
            return metrics
        if not self.graphs:
            self._capture(state, net, batch, encoder_net)
        return self._replay(state, batch, seed)

    def _capture(self, state: TrainState, net: torch.nn.Module, batch: Dict[str, torch.Tensor],
                 encoder_net: Optional[torch.nn.Module]) -> None:
        step, device = self.step, batch["x0"].device
        start = time.perf_counter()
        self._static = {k: torch.empty_like(v) for k, v in batch.items()}
        # the scalars and the stream's GroupNorm backward counter exist
        # before the capture (the scalars' values are written at each replay)
        state.prepare_update()
        gn._counter(device, self.stream)
        pool = torch.cuda.graph_pool_handle()
        num_items = batch["x0"].shape[0] * step.ranks

        def finish(grads, loss, aux):
            metrics = step.metrics(grads, loss, aux, num_items)
            state.update(grads)
            step.write(state, net, encoder_net)
            return metrics

        def gradients():
            return step.local_gradients(net, self._static, encoder_net)

        def gathered():
            grads, loss, aux = gradients()
            return grads, _flatten(grads, loss, aux)

        generators = [step.generator(device)]
        before = launch_counts()
        if step.ranks == 1:
            graph, self._outputs = capture_graph(lambda: finish(*gradients()), self.stream,
                                                 pool, generators, "the train step")
            self.graphs = [graph]
        else:
            first, (grads, self._between) = capture_graph(
                gathered, self.stream, pool, generators, "the train step's gradients")
            second, self._outputs = capture_graph(
                lambda: finish(*_unflatten(*self._between, grads, step.ranks)), self.stream,
                pool, [], "the train step's update")
            self.graphs = [first, second]
        self._launches = captured_launches(before)
        torch.cuda.current_stream(device).wait_stream(self.stream)
        self.captures += 1
        self.capture_s = time.perf_counter() - start

    def _replay(self, state: TrainState, batch: Dict[str, torch.Tensor],
                seed: int) -> Dict[str, object]:
        if batch.keys() != self._static.keys() or any(
                batch[k].shape != v.shape or batch[k].dtype != v.dtype
                for k, v in self._static.items()):
            raise ValueError(f"GraphedTrainStep: the graph was captured for batches of "
                             f"{ {k: tuple(v.shape) for k, v in self._static.items()} }, got "
                             f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
        for k, v in self._static.items():
            v.copy_(batch[k])
        lr = state.prepare_update()
        with self.step.seeded(state.step, seed, batch["x0"].device):
            self.graphs[0].replay()
        if len(self.graphs) > 1:
            _all_reduce(*self._between)
            self.graphs[1].replay()
        count_launches(self._launches)
        state.advance()
        self.replays += 1
        metrics = {k: v.clone() if torch.is_tensor(v) else v for k, v in self._outputs.items()}
        if self.step.lr_schedule is not None:
            metrics["lr"] = lr
        return metrics
