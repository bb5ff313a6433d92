"""The training step (port of `ccdm_tpu/train/step.py`): forward, KL loss,
gradients, update, EMA.

- `t ~ U{1..T}` per sample; `x_t ~ q(x_t | x_0)`, a Gumbel-max draw;
- the UNet predicts an x0 distribution (in fp32 for the loss);
- loss = `KL(theta_post(x_t, x_0, t) ‖ theta_post_prob(x_t, x0pred, t))`
  with the 1e-12 clamp, weighted per pixel by `class_weights[argmax x0]`,
  summed over pixels, divided by the batch;
- `invalid`: a non-finite loss or `min KL < -1e-3` (the reference's
  `_check_loss`), and `kl_min`.

Draws come from a `torch.Generator` seeded from `(seed, step)`, so a resumed
run draws what an uninterrupted one would (the JAX version folds the step
into its key). `train_loss` also takes injected `t` and `x_t`. The metrics
stay on the device; the trainer reads them two steps later. Not ported, by
decision: `make_multi_step` (several steps a launch).

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
one-process run's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

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


def _reduce_gradients(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                      aux: Dict[str, torch.Tensor], count: int):
    """The mean over the ranks of `grads` and `loss` (one flat fp32 buffer,
    one sum), the minimum of `kl_min` and the maximum of `invalid`: new
    `(grads, loss, aux)`, the same on every rank."""
    import torch.distributed as dist

    flat = torch.cat([g.reshape(-1) for g in grads.values()] + [loss.detach().reshape(1)])
    dist.all_reduce(flat)
    flat /= count
    out, offset = {}, 0
    for name, g in grads.items():
        out[name] = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
    worst = torch.stack([-aux["kl_min"].float(), aux["invalid"].float()])
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return out, flat[-1], {"kl_min": -worst[0], "invalid": worst[1] > 0}


def make_train_step(model: DenoisingModel, class_weights: torch.Tensor,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    feature_fn: Optional[Callable] = None,
                    encoder_apply: Optional[Callable] = None) -> Callable:
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
    gradients by master name."""
    dropout_on = any(isinstance(m, torch.nn.Dropout) and m.p > 0 for m in model.unet.modules())
    rank, ranks = mesh.process_index(), mesh.process_count()

    def gradients(state: TrainState, net: torch.nn.Module, batch: Dict[str, torch.Tensor],
                  seed: int, encoder_net: Optional[torch.nn.Module] = None, *,
                  t: Optional[torch.Tensor] = None, xt: Optional[torch.Tensor] = None):
        modules = {"": net} if encoder_apply is None else {UNET: net, ENCODER: encoder_net}
        device = batch["x0"].device
        s = step_seed(seed, state.step)
        generator = torch.Generator(device=device).manual_seed(s)
        net.train(dropout_on)
        for m in modules.values():
            m.zero_grad(set_to_none=True)
        fork = contextlib.nullcontext()
        if dropout_on:
            fork = torch.random.fork_rng(devices=[device] if device.type == "cuda" else [])
        # forward and backward in fp32 where the model computes in fp32 (the
        # output heads): TF32 there cost the LIDC gate its quality
        with fork, fp32_precision():
            if dropout_on:
                torch.manual_seed(s if rank == 0 else step_seed(s, rank))
            fc = None
            if encoder_apply is not None:
                fc = encoder_apply(encoder_net, batch["image"])
            elif feature_fn is not None:
                with torch.no_grad():
                    fc = feature_fn(encoder_net, batch["image"])
            b = batch["x0"].shape[0]
            loss, aux = train_loss(model, net, batch, generator, class_weights, fc, t=t, xt=xt,
                                   rows=slice(rank, None, ranks), global_batch=b * ranks)
            loss.backward()
        grads = {prefix + name: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                 for prefix, m in modules.items() for name, p in m.named_parameters()}
        for m in modules.values():
            m.zero_grad(set_to_none=True)
        loss = loss.detach()
        if ranks > 1:
            grads, loss, aux = _reduce_gradients(grads, loss, aux, ranks)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values()))))
        return grads, {"loss": loss, "invalid": aux["invalid"], "kl_min": aux["kl_min"],
                       "grad_norm": grad_norm, "num_items": b * ranks}

    def step(state: TrainState, net: torch.nn.Module, batch: Dict[str, torch.Tensor],
             seed: int, encoder_net: Optional[torch.nn.Module] = None, *,
             t: Optional[torch.Tensor] = None,
             xt: Optional[torch.Tensor] = None) -> Dict[str, object]:
        grads, metrics = gradients(state, net, batch, seed, encoder_net, t=t, xt=xt)
        lr = state.apply_gradients(grads)
        state.write_to(net, prefix=UNET if encoder_apply is not None else "")
        if encoder_apply is not None:
            state.write_to(encoder_net, prefix=ENCODER)
        if lr_schedule is not None:
            metrics["lr"] = lr
        return metrics

    step.gradients = gradients
    return step
