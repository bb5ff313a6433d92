"""Tensor parallelism over the mesh's `model` axis (port of the model half
of `ccdm_tpu/parallel/mesh.py`).

The rule is the JAX package's `param_partition_spec`: a leaf of two dims or
more whose trailing flax dim (a conv's or dense layer's output features) is
at least `_TP_MIN_WIDTH` wide and divides by `model` is split over the
model axis on that dim; everything else (biases, norm scales, narrow
layers) stays whole on every rank. `partition_dim` gives the torch dim the
split falls on: `models.convert.flax_trailing_dim`, dim 0 of a conv or
linear weight (HWIO and IO become OIHW and OI) and the last dim of a leaf
the converter carries over as it is (DINO's `pos_embed` and `cls_token`).

`shard_modules` keeps each rank's share of those leaves in a built module:

- a sharded conv or linear becomes column parallel: its forward makes this
  rank's output channels from its weight share, gathers them over the
  model group into the whole, contiguous activation (`[B, C, ...]` or
  `[..., C]`, as XLA's all-gather leaves it) and adds the whole bias. Its
  backward slices the output gradient to this rank's channels, so the
  weight gradient is local, and sums the input gradient's partial sums
  over the model group. The two halves are the autograd functions
  `CopyToModel` (identity forward, all-reduce backward, on the input) and
  `GatherFromModel` (gather forward, slice backward, on the output);
- any other sharded leaf (DINO's `pos_embed` and `cls_token`, or a conv
  weight of a module that is not a plain conv or linear) is gathered
  whenever its module reads it as an attribute, through a `GatherFromModel`,
  and its gradient is sliced back: `shard_modules` gives the module a
  subclass of its own class that does this (`_gathering`), so the model's
  code reads `self.pos_embed` as it does without a model axis.

Every rank of a model group then runs every layer's remaining work over the
same, whole activations: the GroupNorm and attention kernels see what one
process would. `Sharding` maps master names to their dims, so the train
state can hold shards, gather them into whole tensors (a checkpoint is the
same file under any layout) and slice whole ones.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.convert import flax_trailing_dim
from ccdm_tpu_torch.parallel import mesh

# Leaves whose output-feature dim is at least this wide are split over the
# model axis; below it the gather costs more than the split saves
_TP_MIN_WIDTH = 64


def partition_dim(name: str, param: torch.Tensor, model: int) -> Optional[int]:
    """The torch dim of the port's leaf `name` that `model` ranks split, or
    None where it stays whole (`param_partition_spec`'s rule)."""
    if model <= 1 or param.dim() < 2:
        return None
    dim = flax_trailing_dim(name, param.dim())
    width = param.shape[dim]
    if width % model or width < _TP_MIN_WIDTH:
        return None
    return dim


def _share(x: torch.Tensor, dim: int, layout: mesh.Mesh) -> torch.Tensor:
    width = x.shape[dim] // layout.model_count
    return x.narrow(dim, layout.model_index * width, width)


class CopyToModel(torch.autograd.Function):
    """Identity forward; backward: the input gradient, of which each rank
    holds the part its own output channels give, summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return mesh.all_reduce_sum(dx, ctx.group), None


class GatherFromModel(torch.autograd.Function):
    """Forward: the whole tensor from each rank's share of `dim`; backward:
    the gradient sliced to this rank's share (every rank of the group holds
    the same whole gradient)."""

    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.width, ctx.index = dim, y.shape[dim], dist.get_rank(group)
        return mesh.gather_channels(y, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None


def _column_forward(self, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel conv's or linear's forward (see the docstring)."""
    group = self.tp_group
    if torch.is_grad_enabled():
        x = CopyToModel.apply(x, group)
    if isinstance(self, nn.Linear):
        y, dim, bias_shape = F.linear(x, self.weight), -1, (-1,)
    else:
        y, dim = self._conv_forward(x, self.weight, None), 1
        bias_shape = (-1,) + (1,) * (y.dim() - 2)
    y = GatherFromModel.apply(y, dim, group)
    if self.bias is not None:
        y = y + self.bias.view(bias_shape)
    return y


def _gathering(cls: type) -> type:
    """A subclass of `cls` that reads each leaf named in the instance's
    `tp_leaves` (`{name: (dim, group)}`) whole: an attribute read of a
    parameter reaches `nn.Module.__getattr__`, which this wraps in a
    `GatherFromModel`. The parameters themselves, their names and the state
    dict stay the share's."""
    def __getattr__(self, name):
        value = super(sub, self).__getattr__(name)
        spec = self.__dict__["tp_leaves"].get(name)
        return value if spec is None else GatherFromModel.apply(value, *spec)

    sub = type(cls.__name__, (cls,), {"__getattr__": __getattr__, "__module__": cls.__module__,
                                      "__qualname__": cls.__qualname__})
    return sub


def shard_modules(net: nn.Module, layout: mesh.Mesh, prefix: str = "") -> Dict[str, int]:
    """Keep this rank's share of every leaf of `net` the rule splits (see
    the docstring), in place; returns `{prefix + name: dim}` of those
    leaves. Call it on a built module with its weights in, before the
    masters are taken from it and before any copy (an EMA module) that must
    stay whole. Nothing changes at `model == 1`."""
    dims: Dict[str, int] = {}
    if layout.model_count == 1:
        return dims
    group = layout.model_group
    for mod_name, module in net.named_modules():
        for pname, p in list(module.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            dim = partition_dim(name, p, layout.model_count)
            if dim is None:
                continue
            column = (pname == "weight" and dim == 0
                      and type(module) in (nn.Conv1d, nn.Conv2d, nn.Linear))
            module.register_parameter(pname, nn.Parameter(
                _share(p.detach(), dim, layout).clone(), requires_grad=p.requires_grad))
            dims[prefix + name] = dim
            if column:
                module.tp_group = group
                module.forward = types.MethodType(_column_forward, module)
            else:
                if "tp_leaves" not in module.__dict__:
                    module.__dict__["tp_leaves"] = {}
                    module.__class__ = _gathering(type(module))
                module.tp_leaves[pname] = (dim, group)
    return dims


def is_split(net: nn.Module) -> bool:
    """Whether `shard_modules` split any leaf of `net` (its forward then
    holds collectives over the model group)."""
    return any("tp_group" in m.__dict__ or "tp_leaves" in m.__dict__ for m in net.modules())


@dataclasses.dataclass
class Sharding:
    """The model axis's split of a train state: master name -> dim."""

    dims: Dict[str, int]
    layout: mesh.Mesh

    def share(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's share of the whole tensor of master `name` (a copy);
        a leaf that stays whole comes back as it is."""
        dim = self.dims.get(name)
        return whole if dim is None else _share(whole, dim, self.layout).clone()

    def gather(self, shares: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tensors of this rank's `shares` (each a master that the
        axis splits), in one collective over the model group."""
        if not shares:
            return {}
        flat = torch.cat([v.detach().float().reshape(-1) for v in shares.values()])
        rows = mesh.gather_channels(flat[None], 0, self.layout.model_group)
        whole, offset = {}, 0
        for name, v in shares.items():
            parts = rows[:, offset:offset + v.numel()].unflatten(1, v.shape)
            whole[name] = torch.cat(parts.unbind(0), dim=self.dims[name]).to(v.dtype)
            offset += v.numel()
        return whole
