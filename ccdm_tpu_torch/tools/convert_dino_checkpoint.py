#!/usr/bin/env python3
"""Convert DINO ViT weights (an upstream `.pth` from facebookresearch/dino)
to the `.npz` that a `feature_cond_encoder`'s `weights:` names
(`DinoFeatureEncoder.load_pretrained`): the port's counterpart of
`scripts/convert_dino_checkpoint.py`, array for array the same file.

    python3 -m ccdm_tpu_torch.tools.convert_dino_checkpoint dino_vits8.pth dino_vits8.npz

The `.pth` is read with `torch.load(weights_only=True)` (a plain state
dict, or a checkpoint holding one under `state_dict`). The `.npz` keeps the
JAX package's layout, which both packages read: patch conv OIHW -> HWIO,
Linear [O,I] -> [I,O], LayerNorm `weight` -> `scale`, under `block_N/...`;
the qkv packing needs no reordering. The upstream's final `norm.*` and
`head.*` feed no block the encoder reads, and are left out.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

# upstream block entries -> the .npz's, and whether the array is transposed
_BLOCK = (("norm1.weight", "norm1/scale", False), ("norm1.bias", "norm1/bias", False),
          ("attn.qkv.weight", "attn_qkv/kernel", True), ("attn.qkv.bias", "attn_qkv/bias", False),
          ("attn.proj.weight", "attn_proj/kernel", True),
          ("attn.proj.bias", "attn_proj/bias", False),
          ("norm2.weight", "norm2/scale", False), ("norm2.bias", "norm2/bias", False),
          ("mlp.fc1.weight", "mlp_fc1/kernel", True), ("mlp.fc1.bias", "mlp_fc1/bias", False),
          ("mlp.fc2.weight", "mlp_fc2/kernel", True), ("mlp.fc2.bias", "mlp_fc2/bias", False))


def convert(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An upstream state dict (numpy arrays) -> the `.npz`'s arrays."""
    out = {"cls_token": np.asarray(state["cls_token"]),
           "pos_embed": np.asarray(state["pos_embed"]),
           "patch_embed/kernel": np.transpose(state["patch_embed.proj.weight"], (2, 3, 1, 0)),
           "patch_embed/bias": np.asarray(state["patch_embed.proj.bias"])}
    n = 0
    while f"blocks.{n}.norm1.weight" in state:
        for src, dst, transpose in _BLOCK:
            value = state[f"blocks.{n}.{src}"]
            out[f"block_{n}/{dst}"] = np.transpose(value) if transpose else np.asarray(value)
        n += 1
    if n == 0:
        raise ValueError("no transformer blocks (blocks.N.*) in the state dict")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("torch_pth")
    ap.add_argument("out_npz")
    args = ap.parse_args(argv)

    import torch

    state = torch.load(args.torch_pth, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    state = {k: v.numpy() for k, v in state.items() if torch.is_tensor(v)}
    converted = convert(state)
    np.savez(args.out_npz, **converted)
    print(f"wrote {args.out_npz} ({len(converted)} arrays)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
