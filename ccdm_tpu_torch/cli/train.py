"""Training CLI of the port:

    python -m ccdm_tpu_torch.cli.train params.yml [--max-steps N] [--device cpu]

The same `params.yml` surface as `ccdm_train.py`. The file is read with
PyYAML where it is installed; without it, a `.json` file of the same dict
works, or a caller passes the dict to `run_train` itself. Training runs on
the CUDA card unless `--device` names another.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def load_params(path: str):
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    try:
        import yaml
    except ImportError as e:
        raise SystemExit(f"reading {path} needs PyYAML, which is not installed: pass a "
                         f".json file or call run_train with the dict") from e
    with open(path) as f:
        return yaml.safe_load(f)


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
