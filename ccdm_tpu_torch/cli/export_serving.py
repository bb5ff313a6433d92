"""Export a configured sampler as a serving artifact (port of
`scripts/export_serving.py`):

    python -m ccdm_tpu_torch.cli.export_serving params_eval.yml out.ccdm \\
        [--shape 128 128 1] [--classes 2] [--batch 1] [--samples 16] \\
        [--steps K] [--calib-npy calib.npy] [--cpu]

Reads the eval params surface of `cli/eval.py`: `load_from` (the EMA
weights, baked in), `feature_cond_encoder` (the DINO encoder, exported
inside), `quantized_inference: static` (the scales are calibrated on
synthetic images before the export; pass real ones with --calib-npy),
`evaluations`/`max_num_samples`. The artifact's contract:
`ccdm_tpu_torch/utils/serving.py`. It exports on the CUDA card and serves
there; without a card it raises unless --cpu asks for the CPU. The JAX
script's `--platforms` has no counterpart: an artifact holds the kernels
of the device it was exported on.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ccdm_tpu_torch.config import load_params, with_defaults
from ccdm_tpu_torch.utils.logging import setup_logger

LOGGER = logging.getLogger(__name__)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export a CCDM sampler as a serving artifact")
    ap.add_argument("params_file")
    ap.add_argument("output")
    ap.add_argument("--shape", nargs=3, type=int, default=[128, 128, 1],
                    metavar=("H", "W", "C"), help="served image shape")
    ap.add_argument("--classes", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--samples", type=int, default=None,
                    help="samples per image (default: params max_num_samples/evaluations or 16)")
    ap.add_argument("--steps", type=int, default=None,
                    help="reverse steps (default: full schedule)")
    ap.add_argument("--calib-npy", default=None,
                    help="npy of [N,H,W,C] images for int8-static calibration")
    ap.add_argument("--cpu", action="store_true",
                    help="export for the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    setup_logger()
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the artifact exports on the card unless --cpu "
                           "asks for the CPU")
    device = "cpu" if args.cpu else "cuda"

    from ccdm_tpu_torch.eval.lidc_uncertainty import build_eval_feature_fn, load_eval_params
    from ccdm_tpu_torch.models.builder import build_model
    from ccdm_tpu_torch.utils.serving import save_sampler

    params = with_defaults(load_params(args.params_file))
    h, w, ci = args.shape
    default_samples = params.get("max_num_samples", params.get("evaluations", 16))
    if isinstance(default_samples, (list, tuple)):  # evaluations: [1, 16]
        default_samples = max(default_samples)
    num_samples = args.samples or int(default_samples)

    model = build_model(params, args.classes, image_channels=ci, image_size=min(h, w),
                        device=device)
    feature_fn, _, feature_net = build_eval_feature_fn(params, (h, w, ci), device=device)
    load_eval_params(params, model.unet)

    if str(params.get("quantized_inference", "")).lower() == "static":
        from ccdm_tpu_torch.ops import quant

        calib = (np.load(args.calib_npy) if args.calib_npy
                 else np.random.default_rng(0).standard_normal((2, h, w, ci)).astype(np.float32))
        model = quant.calibrate_static_scales(
            model, model.unet, torch.from_numpy(np.asarray(calib, np.float32)).to(device),
            feature_fn=feature_fn, feature_net=feature_net)
        if not args.calib_npy:
            LOGGER.warning("int8-static calibrated on synthetic images; pass --calib-npy "
                           "with real data for production")

    path = save_sampler(args.output, model, model.unet, (h, w, ci), num_samples=num_samples,
                        num_steps=args.steps, batch_size=args.batch, feature_fn=feature_fn,
                        feature_net=feature_net)
    size_mb = os.path.getsize(path) / 1e6
    print(f"exported {path} ({size_mb:.1f} MB): "
          f"serve(images [{args.batch},{h},{w},{ci}] f32, seed int64[2]) -> "
          f"probs [{args.batch},{num_samples},{h},{w},{args.classes}] f32")
    return path


if __name__ == "__main__":
    main()
