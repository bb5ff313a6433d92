"""Evaluation CLI of the port:

    python -m ccdm_tpu_torch.cli.eval params_eval.yml [--device cpu]

The same `params_eval.yml` surface as `ccdm_eval.py`, dispatched as the JAX
CLI dispatches: `_sampling_speed` in `dataset_file` runs the step sweep;
a multi-annotator dataset (LIDC, the synthetic set) runs the uncertainty
harness; anything else runs Cityscapes inference with the official
scoring. The file is read as YAML where PyYAML is installed, else as
`.json`. Evaluation runs on the CUDA card unless `--device` names another
device; it never falls back to the CPU by itself.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np

from ccdm_tpu_torch.config import load_params, with_defaults
from ccdm_tpu_torch.utils.logging import setup_logger


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a CCDM with the PyTorch port")
    parser.add_argument("params_file", nargs="?", default="params_eval.yml")
    parser.add_argument("--device", default=None,
                        help="torch device to evaluate on (default: the CUDA card)")
    args = parser.parse_args(argv)
    os.environ.setdefault("NOW", time.strftime("%Y%m%d_%H%M%S"))
    os.environ.setdefault("SLURM_JOB_ID", "local")
    setup_logger()
    random.seed(0)
    np.random.seed(0)

    params = with_defaults(load_params(args.params_file))
    dataset_file = params["dataset_file"]
    if "_sampling_speed" in dataset_file:
        # the reference encodes the benchmark in the dataset's name
        from ccdm_tpu_torch.eval.lidc_sampling_speed import eval_lidc_sampling_speed

        params = dict(params, dataset_file=dataset_file.replace("_sampling_speed", ""))
        return eval_lidc_sampling_speed(params, device=args.device)

    from ccdm_tpu_torch.data.registry import is_multi_annotator, resolve_dataset_module

    if is_multi_annotator(resolve_dataset_module(dataset_file), dataset_file):
        from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty

        return eval_lidc_uncertainty(params, device=args.device)
    from ccdm_tpu_torch.eval.cityscapes_eval import run_inference

    return run_inference(params, device=args.device)


if __name__ == "__main__":
    main()
