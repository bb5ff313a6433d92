"""Training state (port of `ccdm_tpu/train/state.py`): the step, the fp32
master parameters, their Polyak (EMA) average and the optimizer state.

The JAX package keeps every parameter in fp32 and casts to the compute
dtype inside each op. The port's UNet holds its torso's convs and linears in
the compute dtype itself (bf16 on the card), which is exact for sampling,
but an Adam update of ~1e-4 relative size would vanish in a bf16 weight.
So the state holds fp32 masters keyed by the UNet's state-dict names, the
optimizer updates those, and `write_to` copies them into the module after
each step (a cast where the module is bf16; nothing where it is fp32, whose
parameters are the masters themselves). The update and the EMA run in
place; the JAX version builds new arrays.

A run with a trainable feature encoder keeps one composite state: the
UNet's masters under `unet.<name>`, the encoder's under `encoder.<name>`
(the JAX package's `{"unet", "encoder"}` trees), so Adam and the EMA run
jointly over both. Its checkpoint splits them again into the reference's
keys (`model` and `feature_cond_encoder`, with their `average_*` EMAs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ccdm_tpu_torch.train.optimizer import Optimizer

UNET, ENCODER = "unet.", "encoder."  # name prefixes of a composite state


def prefixed(prefix: str, d: Dict[str, Any]) -> Dict[str, Any]:
    return {prefix + k: v for k, v in d.items()}


def _part(d: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def is_composite(params: Dict[str, Any]) -> bool:
    """Whether `params` holds a UNet and a trainable encoder."""
    return any(k.startswith(ENCODER) for k in params)


def master_params(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The fp32 masters of `net`: its own parameter tensors where they are
    fp32, fp32 copies where they are not."""
    return {name: p.detach() if p.dtype == torch.float32 else p.detach().float()
            for name, p in net.named_parameters()}


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    tx: Optimizer
    polyak_alpha: float = 0.9999

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> float:
        """One optimizer update of the masters, then `ema = a ema + (1 - a)
        p` on the new params; returns the learning rate used. The three
        parts, which a CUDA graph of the step takes apart: `prepare_update`
        (the host's scalars), `update` (the device's work) and `advance`
        (the host's counts)."""
        lr = self.prepare_update()
        self.update(grads)
        self.advance()
        return lr

    def prepare_update(self) -> float:
        """The optimizer's scalars of the next update, written on the
        masters' device; returns its learning rate."""
        return self.tx.prepare(self.opt_state["count"], next(iter(self.params.values())).device)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        """The update with the prepared scalars and the EMA, on the device
        alone (no host value changes)."""
        self.tx.apply(grads, self.opt_state, self.params)
        ema = [self.ema_params[k] for k in self.params]
        torch._foreach_mul_(ema, self.polyak_alpha)
        torch._foreach_add_(ema, list(self.params.values()), alpha=1.0 - self.polyak_alpha)

    def advance(self) -> None:
        """Count the update: the optimizer's count and the step."""
        self.opt_state["count"] += 1
        self.step += 1

    @torch.no_grad()
    def write_to(self, net: nn.Module, ema: bool = False, prefix: str = "") -> None:
        """Copy the masters (or the EMA) named `prefix + <parameter name>`
        into `net`'s parameters, cast to their dtype; parameters that are
        the masters themselves stay."""
        src = self.ema_params if ema else self.params
        dst, vals = [], []
        for name, p in net.named_parameters():
            master = src[prefix + name]
            if p.data_ptr() != master.data_ptr():
                dst.append(p)
                vals.append(master)
        if dst:
            torch._foreach_copy_(dst, vals)

    def tree(self) -> Dict[str, Any]:
        """The checkpoint schema (the reference's `objects_to_save` keys):
        `model`, `average_model`, `opt_state`, `step`, as CPU tensors; a
        composite state stores its encoder under `feature_cond_encoder` and
        `average_feature_cond_encoder` (the optimizer's moments keep the
        prefixed names)."""
        def cpu(d):
            return {k: v.detach().cpu().clone() for k, v in d.items()}

        opt = {k: (cpu(v) if isinstance(v, dict) else v) for k, v in self.opt_state.items()}
        tree = {"opt_state": opt, "step": int(self.step)}
        if is_composite(self.params):
            tree.update(model=cpu(_part(self.params, UNET)),
                        average_model=cpu(_part(self.ema_params, UNET)),
                        feature_cond_encoder=cpu(_part(self.params, ENCODER)),
                        average_feature_cond_encoder=cpu(_part(self.ema_params, ENCODER)))
        else:
            tree.update(model=cpu(self.params), average_model=cpu(self.ema_params))
        return tree

    @torch.no_grad()
    def load_tree(self, tree: Dict[str, Any]) -> "TrainState":
        """Restore from a `tree()` in place, on the state's devices."""
        def copy(dst, src):
            if set(dst) != set(src):
                raise KeyError(f"checkpoint keys differ: {sorted(set(dst) ^ set(src))[:5]}")
            for k, v in dst.items():
                v.copy_(src[k])

        if is_composite(self.params):
            if "feature_cond_encoder" not in tree:
                raise KeyError("the checkpoint holds no feature_cond_encoder for this run's "
                               "trainable encoder")
            copy(self.params, {**prefixed(UNET, tree["model"]),
                               **prefixed(ENCODER, tree["feature_cond_encoder"])})
            copy(self.ema_params, {**prefixed(UNET, tree["average_model"]),
                                   **prefixed(ENCODER, tree["average_feature_cond_encoder"])})
        else:
            copy(self.params, tree["model"])
            copy(self.ema_params, tree["average_model"])
        for key, value in tree["opt_state"].items():
            if isinstance(value, dict):
                copy(self.opt_state[key], value)
            else:
                self.opt_state[key] = int(value)
        self.step = int(tree["step"])
        return self


def create_train_state(params: Dict[str, torch.Tensor], tx: Optimizer,
                       polyak_alpha: float = 0.9999,
                       ema_params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """A state at step 0; the EMA starts as a copy of the params."""
    if ema_params is None:
        ema_params = {k: v.detach().clone() for k, v in params.items()}
    return TrainState(step=0, params=params, ema_params=ema_params,
                      opt_state=tx.init(params), tx=tx, polyak_alpha=polyak_alpha)
