"""Training CLI of the port:

    python -m ccdm_tpu_torch.cli.train params.yml [--max-steps N] [--device cpu]
    torchrun --nproc_per_node N -m ccdm_tpu_torch.cli.train params.yml --multihost

The same `params.yml` surface as `ccdm_train.py`. The file is read with
PyYAML where it is installed; without it, a `.json` file of the same dict
works, or a caller passes the dict to `run_train` itself. Training runs on
the CUDA card unless `--device` names another. `--multihost` joins the
process group of a torchrun launch (`parallel.mesh.init_distributed`): one
process per card over `nccl`, or CPU processes over `gloo` with `--device
cpu`, training one model over the config's `mesh: {data: d, model: m}`
(data parallel by default; `--nproc_per_node` must be `d * m`, a model axis
splitting the wide layers over `m` ranks, `parallel/tensor.py`).
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
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group of a torchrun launch (one process per "
                             "card, laid out as the config's mesh)")
    args = parser.parse_args(argv)
    os.environ.setdefault("NOW", time.strftime("%Y%m%d_%H%M%S"))
    os.environ.setdefault("SLURM_JOB_ID", "local")

    from ccdm_tpu_torch.train.trainer import run_train

    device = args.device
    if args.multihost:
        from ccdm_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(device)
        import torch.distributed as dist

        print(f"process group: rank {dist.get_rank()} of {dist.get_world_size()}, "
              f"{dist.get_backend()}, {device}", flush=True)
    try:
        state = run_train(load_params(args.params_file), max_steps=args.max_steps,
                          device=device)
    finally:
        if args.multihost:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"trained to step {state.step}", flush=True)


if __name__ == "__main__":
    main()
