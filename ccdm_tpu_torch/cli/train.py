"""Training CLI of the port:

    python -m ccdm_tpu_torch.cli.train params.yml [--max-steps N] [--device cpu]

The same `params.yml` surface as `ccdm_train.py`. The file is read with
PyYAML where it is installed; without it, a `.json` file of the same dict
works, or a caller passes the dict to `run_train` itself. Training runs on
the CUDA card unless `--device` names another.
"""

from __future__ import annotations

import argparse
import os
import time

from ccdm_tpu_torch.config import load_params


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a CCDM with the PyTorch port")
    parser.add_argument("params_file", nargs="?", default="params.yml")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the CUDA card)")
    args = parser.parse_args(argv)
    os.environ.setdefault("NOW", time.strftime("%Y%m%d_%H%M%S"))
    os.environ.setdefault("SLURM_JOB_ID", "local")

    from ccdm_tpu_torch.train.trainer import run_train

    state = run_train(load_params(args.params_file), max_steps=args.max_steps,
                      device=args.device)
    print(f"trained to step {state.step}", flush=True)


if __name__ == "__main__":
    main()
