"""Flax UNet and DINO parameters -> the port's `state_dict`s, without jax.

`flax_params_to_state_dict` takes the JAX package's UNet parameter tree as
nested dicts of numpy arrays (e.g. `jax.device_get(params)` saved with
numpy) and returns the port's state dict. It applies the same name map and
layout inversions as `ccdm_tpu/models/torch_convert.py::flax_unet_to_torch`
(Conv2d HWIO -> OIHW; attention qkv/proj Dense [I,O] -> Conv1d [O,I,1];
other Dense [I,O] -> Linear [O,I]; GroupNorm scale/bias -> weight/bias), so
the result loads into `UNetModel` with `strict=True`.
`flax_dino_to_state_dict` does the same for the JAX package's `DinoViT`, and
`flax_train_state_to_tree` carries a JAX `TrainState` (params, EMA, the
optimizer's moments, the step; the encoder's too where it trains) into the
port's checkpoint schema. `flax_spatial_transformer_to_state_dict` maps
the JAX package's `SpatialTransformer` (`models/cross_attention.py`).
`flax_trailing_dim` says where a flax leaf's trailing dim lands in the
port's tensor, which the tensor-parallel rule needs (`parallel/tensor.py`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_FIXED_PREFIXES = {
    "in_conv": "input_blocks.0.0",
    "time_mlp1": "time_embed.0",
    "time_mlp2": "time_embed.2",
    "out_norm": "out.0",
    "out_conv": "out.2",
    "out_ce_norm": "out_ce.0",
    "out_ce_conv": "out_ce.2",
    "mid_res1": "middle_block.0",
    "mid_attn": "middle_block.1",
    "mid_res2": "middle_block.2",
}

_SUBMAP = {
    # ResBlock
    ("in_norm", "GroupNorm_0", "scale"): "in_layers.0.weight",
    ("in_norm", "GroupNorm_0", "bias"): "in_layers.0.bias",
    ("in_conv", "kernel"): "in_layers.2.weight",
    ("in_conv", "bias"): "in_layers.2.bias",
    ("emb_proj", "kernel"): "emb_layers.1.weight",
    ("emb_proj", "bias"): "emb_layers.1.bias",
    ("out_norm", "GroupNorm_0", "scale"): "out_layers.0.weight",
    ("out_norm", "GroupNorm_0", "bias"): "out_layers.0.bias",
    ("out_conv", "kernel"): "out_layers.3.weight",
    ("out_conv", "bias"): "out_layers.3.bias",
    ("skip", "kernel"): "skip_connection.weight",
    ("skip", "bias"): "skip_connection.bias",
    # AttentionBlock
    ("norm", "GroupNorm_0", "scale"): "norm.weight",
    ("norm", "GroupNorm_0", "bias"): "norm.bias",
    ("qkv", "kernel"): "qkv.weight",
    ("qkv", "bias"): "qkv.bias",
    ("proj", "kernel"): "proj_out.weight",
    ("proj", "bias"): "proj_out.bias",
    # Up/Downsample
    ("conv", "kernel"): "conv.weight",
    ("conv", "bias"): "conv.bias",
    ("op", "kernel"): "op.weight",
    ("op", "bias"): "op.bias",
    # bare GroupNorm/conv heads and the time MLP
    ("GroupNorm_0", "scale"): "weight",
    ("GroupNorm_0", "bias"): "bias",
    ("kernel",): "weight",
    ("bias",): "bias",
}


# leaves carried over without a transpose: flax's trailing dim stays last
_UNTRANSPOSED = ("cls_token", "pos_embed")


def flax_trailing_dim(name: str, ndim: int) -> int:
    """The dim of the port's `ndim`-dim tensor `name` that holds the flax
    leaf's trailing (output-feature) dim: the last of a leaf the converters
    carry over as it is, else 0 (every conv and dense kernel is transposed
    to put its outputs first: HWIO -> OIHW, [I,O] -> [O,I] or [O,I,1])."""
    return ndim - 1 if name.rsplit(".", 1)[-1] in _UNTRANSPOSED else 0


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value, dtype=np.float32)


def _prefix(module: str, last_index: Dict[int, int]) -> str:
    if module in _FIXED_PREFIXES:
        return _FIXED_PREFIXES[module]
    m = re.fullmatch(r"down_(\d+)_(res|attn|downsample)", module)
    if m:
        return f"input_blocks.{m.group(1)}.{1 if m.group(2) == 'attn' else 0}"
    m = re.fullmatch(r"up_(\d+)_(res|attn|upsample)", module)
    if m:
        j = int(m.group(1))
        pos = {"res": 0, "attn": 1}.get(m.group(2), last_index.get(j))
        return f"output_blocks.{j}.{pos}"
    raise KeyError(f"no torch mapping for flax module {module!r}")


def flax_params_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a Flax UNet param tree (nested dicts of arrays) to the port's
    state dict (float32 CPU tensors; `load_state_dict` casts to the
    module's dtype and device)."""
    leaves = list(_leaves(tree))
    modules = {parts[0] for parts, _ in leaves}
    # an output block is [ResBlock, AttentionBlock?, Upsample]: the upsample
    # sits at index 2 with attention, 1 without
    last_index = {}
    for module in modules:
        m = re.fullmatch(r"up_(\d+)_upsample", module)
        if m:
            j = int(m.group(1))
            last_index[j] = 2 if f"up_{j}_attn" in modules else 1

    state_dict: Dict[str, torch.Tensor] = {}
    for parts, value in leaves:
        sub = _SUBMAP.get(parts[1:])
        if sub is None:
            raise KeyError(f"no torch mapping for flax path {'/'.join(parts)}")
        if value.ndim == 4:  # HWIO -> OIHW
            value = np.transpose(value, (3, 2, 0, 1))
        elif value.ndim == 2:
            value = np.transpose(value)  # Dense [I,O] -> Linear [O,I]
            if parts[0].endswith("attn") and parts[1] in ("qkv", "proj"):
                value = value[:, :, None]  # -> Conv1d [O,I,1]
        state_dict[f"{_prefix(parts[0], last_index)}.{sub}"] = torch.from_numpy(
            np.array(value, dtype=np.float32))  # a writable, contiguous copy
    return state_dict


_DINO_SUBMAP = {
    ("norm1", "scale"): "norm1.weight",
    ("norm1", "bias"): "norm1.bias",
    ("attn_qkv", "kernel"): "attn.qkv.weight",
    ("attn_qkv", "bias"): "attn.qkv.bias",
    ("attn_proj", "kernel"): "attn.proj.weight",
    ("attn_proj", "bias"): "attn.proj.bias",
    ("norm2", "scale"): "norm2.weight",
    ("norm2", "bias"): "norm2.bias",
    ("mlp_fc1", "kernel"): "mlp.fc1.weight",
    ("mlp_fc1", "bias"): "mlp.fc1.bias",
    ("mlp_fc2", "kernel"): "mlp.fc2.weight",
    ("mlp_fc2", "bias"): "mlp.fc2.bias",
}


def flax_dino_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Convert the JAX package's `DinoViT` param tree (nested dicts of
    arrays) to the port's `DinoViT` state dict: the inverse of `scripts/convert_dino_checkpoint.py`
    (patch conv HWIO -> OIHW, Dense [I,O] -> Linear [O,I], LayerNorm
    `scale` -> `weight`)."""
    state_dict: Dict[str, torch.Tensor] = {}
    for parts, value in _leaves(tree):
        if len(parts) == 1 and parts[0] in _UNTRANSPOSED:
            name = parts[0]
        elif parts[0] == "patch_embed" and parts[1:] in (("kernel",), ("bias",)):
            name = f"patch_embed.proj.{'weight' if parts[1] == 'kernel' else 'bias'}"
            if value.ndim == 4:  # HWIO -> OIHW
                value = np.transpose(value, (3, 2, 0, 1))
        else:
            m = re.fullmatch(r"block_(\d+)", parts[0])
            sub = _DINO_SUBMAP.get(parts[1:]) if m else None
            if sub is None:
                raise KeyError(f"no torch mapping for flax DINO path {'/'.join(parts)}")
            name = f"blocks.{m.group(1)}.{sub}"
            if value.ndim == 2:  # Dense [I,O] -> Linear [O,I]
                value = np.transpose(value)
        state_dict[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state_dict


def flax_spatial_transformer_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Convert the JAX package's `SpatialTransformer` param tree to the
    port's (`models/cross_attention.py`): `block_i` -> `blocks.i`, the
    GroupNorm's `GroupNorm_0` level dropped, `scale` -> `weight`, `kernel`
    -> `weight` (1x1 conv HWIO -> OIHW, Dense [I,O] -> Linear [O,I])."""
    state_dict: Dict[str, torch.Tensor] = {}
    for parts, value in _leaves(tree):
        names = []
        for part in parts:
            m = re.fullmatch(r"block_(\d+)", part)
            if m:
                names += ["blocks", m.group(1)]
            elif part in ("kernel", "scale"):
                names.append("weight")
            elif part != "GroupNorm_0":
                names.append(part)
        if value.ndim == 4:  # HWIO -> OIHW
            value = np.transpose(value, (3, 2, 0, 1))
        elif value.ndim == 2:  # Dense [I,O] -> Linear [O,I]
            value = np.transpose(value)
        state_dict[".".join(names)] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state_dict


def _optax_fields(state, found: Dict[str, Any]) -> Dict[str, Any]:
    """Walk an optax state (nested tuples of named tuples) and collect its
    `count`, `mu`, `nu` and `trace` fields by name."""
    fields = getattr(state, "_fields", None)
    if fields is not None:
        for name in fields:
            value = getattr(state, name)
            if name in ("mu", "nu", "trace"):
                found[name] = value
            elif name == "count":
                found.setdefault("count", int(np.asarray(value)))
            else:
                _optax_fields(value, found)
    elif isinstance(state, (tuple, list)):
        for item in state:
            _optax_fields(item, found)
    return found


def _is_composite(tree) -> bool:
    """A trainable-encoder run's `{"unet", "encoder"}` trees."""
    return isinstance(tree, Mapping) and set(tree) == {"unet", "encoder"}


def _moments_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """An optimizer moment tree -> the port's names; a composite one keeps
    the UNet's under `unet.` and the encoder's under `encoder.`, as the
    port's composite `TrainState` does."""
    if _is_composite(tree):
        return {**{f"unet.{k}": v for k, v in flax_params_to_state_dict(tree["unet"]).items()},
                **{f"encoder.{k}": v for k, v in flax_dino_to_state_dict(tree["encoder"]).items()}}
    return flax_params_to_state_dict(tree)


def flax_train_state_to_tree(params: Mapping, ema_params: Mapping, opt_state,
                             step) -> Dict[str, Any]:
    """A JAX `TrainState`'s parts (numpy trees, e.g. `jax.device_get` of
    each) -> the port's checkpoint tree (`TrainState.tree()`'s schema):
    `model` and `average_model` through `flax_params_to_state_dict`, and
    `opt_state` with the optimizer's count and its moments (`mu` and `nu`
    of Adam and AdamW, `trace` of SGD) through the same key map and layout
    inversions. A trainable-encoder state (`{"unet", "encoder"}` trees)
    also gives `feature_cond_encoder` and `average_feature_cond_encoder`
    through `flax_dino_to_state_dict`; its moments keep the `unet.` and
    `encoder.` prefixes."""
    found = _optax_fields(opt_state, {})
    opt: Dict[str, Any] = {"count": found.get("count", int(np.asarray(step)))}
    for name in ("mu", "nu", "trace"):
        if name in found:
            opt[name] = _moments_to_state_dict(found[name])
    tree = {"opt_state": opt, "step": int(np.asarray(step))}
    if _is_composite(params):
        tree.update(model=flax_params_to_state_dict(params["unet"]),
                    average_model=flax_params_to_state_dict(ema_params["unet"]),
                    feature_cond_encoder=flax_dino_to_state_dict(params["encoder"]),
                    average_feature_cond_encoder=flax_dino_to_state_dict(ema_params["encoder"]))
    else:
        tree.update(model=flax_params_to_state_dict(params),
                    average_model=flax_params_to_state_dict(ema_params))
    return tree
