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

Over a mesh's `model` axis (`parallel/tensor.py`) the state holds this
rank's share of each leaf the axis splits, for the masters, the EMA and the
optimizer's moments alike, and the whole of every other leaf. `sharding`
names the split leaves: `write_to` gathers them into a module that holds
them whole (the EMA module of validation), `tree()` gathers them (a
collective every rank of the model group joins), and `load_tree` takes
each rank's share of a whole tree, so a checkpoint is the same file under
any layout.
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
    sharding: Optional[Any] = None  # parallel.tensor.Sharding of a model axis

    @property
    def sharded(self) -> bool:
        """Whether the state holds shares of leaves a model axis splits."""
        return bool(self.sharding is not None and self.sharding.dims)

    def _whole(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`d` with the shares of split leaves gathered whole (collective)."""
        if not self.sharded:
            return d
        whole = self.sharding.gather({k: v for k, v in d.items() if k in self.sharding.dims})
        return {k: whole.get(k, v) for k, v in d.items()}

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
        the masters themselves stay. Where `net` holds a split leaf whole,
        the shares are gathered (a collective every rank of the model group
        joins)."""
        src = self.ema_params if ema else self.params
        named = [(prefix + name, p) for name, p in net.named_parameters()]
        split = [k for k, p in named if p.shape != src[k].shape]
        if split:
            src = {**src, **self.sharding.gather({k: src[k] for k in split})}
        dst, vals = [], []
        for name, p in named:
            master = src[name]
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
        prefixed names). A sharded state gathers its split leaves: every
        rank of the model group calls it."""
        def cpu(d):
            return {k: v.detach().cpu().clone() for k, v in d.items()}

        params, ema = self._whole(self.params), self._whole(self.ema_params)
        opt = {k: (cpu(self._whole(v)) if isinstance(v, dict) else v)
               for k, v in self.opt_state.items()}
        tree = {"opt_state": opt, "step": int(self.step)}
        if is_composite(params):
            tree.update(model=cpu(_part(params, UNET)),
                        average_model=cpu(_part(ema, UNET)),
                        feature_cond_encoder=cpu(_part(params, ENCODER)),
                        average_feature_cond_encoder=cpu(_part(ema, ENCODER)))
        else:
            tree.update(model=cpu(params), average_model=cpu(ema))
        return tree

    @torch.no_grad()
    def load_tree(self, tree: Dict[str, Any]) -> "TrainState":
        """Restore from a `tree()` in place, on the state's devices; a
        sharded state takes its share of each split leaf."""
        def copy(dst, src):
            if set(dst) != set(src):
                raise KeyError(f"checkpoint keys differ: {sorted(set(dst) ^ set(src))[:5]}")
            for k, v in dst.items():
                v.copy_(self.sharding.share(k, src[k]) if self.sharded else src[k])

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
                       ema_params: Optional[Dict[str, torch.Tensor]] = None,
                       sharding=None) -> TrainState:
    """A state at step 0; the EMA starts as a copy of the params. With a
    `sharding`, `params` holds this rank's shares of the split leaves."""
    if ema_params is None:
        ema_params = {k: v.detach().clone() for k, v in params.items()}
    return TrainState(step=0, params=params, ema_params=ema_params,
                      opt_state=tx.init(params), tx=tx, polyak_alpha=polyak_alpha,
                      sharding=sharding)
