#!/usr/bin/env python3
"""DINO ViT descriptors of one image, saved as `.npy`: the port's
counterpart of `scripts/extract_dino_descriptors.py` (the reference's
`python -m ddpm.models.dino` CLI), with its flags and its output.

    python3 -m ccdm_tpu_torch.tools.extract_dino_descriptors --image_path img.png \\
        --output_path desc.npy --weights dino_vits8.npz [--load_size 224] [--stride 4] \\
        [--model_type dino_vits8] [--facet key] [--layer 11] [--bin | --saliency] \\
        [--device cpu]

The image is a PNG (read by `utils/png.py`: the card's machine has no PIL
and no JPEG decoder), converted to RGB, its shorter side resized to
`--load_size` with PIL's LANCZOS (`data/resample.resize_lanczos_uint8`, bit
for bit), scaled to [0, 1] and ImageNet-normalised. The output is the
facet of block `--layer` at stride `--stride`, `[1, H/stride, W/stride, D]`
channels-last; `--bin` log-bins it first (`[..., D * 17]`); `--saliency`
writes the `[1, tokens]` cls-attention saliency map instead (dino_vits8
only). Weights: the `.npz` of `tools/convert_dino_checkpoint.py`; without
`--weights` the extractor is random, with a warning. It runs on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_image(path: str, load_size: int) -> np.ndarray:
    """`[1,H,W,3]` float32, ImageNet-normalised, the shorter side resized to
    `load_size` (0: kept) as the JAX script's `load_image` does."""
    from ccdm_tpu_torch.data.resample import resize_lanczos_uint8
    from ccdm_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from ccdm_tpu_torch.utils.png import read_png

    img = read_png(path, "RGB")
    if load_size:
        h, w = img.shape[:2]
        scale = load_size / min(w, h)
        img = resize_lanczos_uint8(img, (round(h * scale), round(w * scale)))
    x = img.astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN.astype(np.float64)) / IMAGENET_STD.astype(np.float64)
    return x[None].astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ViT descriptor extraction")
    ap.add_argument("--image_path", required=True, help="a PNG image")
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--weights", help=".npz from tools/convert_dino_checkpoint.py "
                                      "(random weights with a warning if absent)")
    ap.add_argument("--load_size", default=224, type=int)
    ap.add_argument("--stride", default=4, type=int)
    ap.add_argument("--model_type", default="dino_vits8",
                    choices=["dino_vits8", "dino_vits16", "dino_vitb8", "dino_vitb16"])
    ap.add_argument("--facet", default="key", choices=["key", "query", "value", "token"])
    ap.add_argument("--layer", default=11, type=int)
    ap.add_argument("--bin", action="store_true",
                    help="log-binned descriptors (1+8*2 bins per location)")
    ap.add_argument("--saliency", action="store_true",
                    help="write the [1, tokens] cls-attention saliency map instead of "
                         "descriptors (dino_vits8 only)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from ccdm_tpu_torch.models.dino import DinoFeatureEncoder

    enc = DinoFeatureEncoder({"model": args.model_type, "output_stride": args.stride,
                              "source_layer": args.layer, "facet": args.facet})
    image = load_image(args.image_path, args.load_size)
    print(f"Image {args.image_path} is preprocessed to tensor of size {image.shape}.")
    vit = enc.init(device=args.device)
    if args.weights:
        enc.load_pretrained(vit, args.weights)
    else:
        print("WARNING: no --weights given — RANDOM extractor weights")
    images = torch.from_numpy(image).to(next(vit.parameters()).device)
    if args.saliency:
        desc = enc.extract_saliency_maps(vit, images)
        print(f"Saliency maps are of size: {tuple(desc.shape)}")
    else:
        desc = enc.extract_descriptors(vit, images, log_bin=args.bin)
        print(f"Descriptors are of size: {tuple(desc.shape)}")
    np.save(args.output_path, desc.cpu().numpy())
    print(f"Saved to: {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
