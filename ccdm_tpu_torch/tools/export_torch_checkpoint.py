#!/usr/bin/env python3
"""Write a port training checkpoint in the reference's checkpoint schema:
the counterpart of `scripts/export_torch_checkpoint.py`.

    python3 -m ccdm_tpu_torch.tools.export_torch_checkpoint <run_dir> <out.pt> [--step N]

`run_dir` is anything `train/checkpoint.load_tree` resolves: an experiment
directory (its `model/`), a manager directory (its latest or `--step`
step), a step directory or a `state.pt`. The output is `{"model": ...,
"average_model": ...}`, fp32 CPU state dicts of the UNet in the
reference's key names (`ddpm/trainer.py:357-365`), which the port's UNet
uses itself: the reference's evaluation reads `average_model`, and
`load_from: <out.pt>` loads it back into the port. A trainable DINO
encoder's weights stay out, as the JAX script leaves them out (the
reference loads its encoder from torch hub), and so does the optimizer's
state.
"""

from __future__ import annotations

import argparse
import sys


def export(run_dir: str, output: str, step=None) -> dict:
    """Write `output` from the checkpoint at `run_dir`; returns what it wrote."""
    import torch

    from ccdm_tpu_torch.train.checkpoint import load_tree

    tree = load_tree(run_dir, step=step)
    out = {key: {name: value.detach().to("cpu", torch.float32).contiguous()
                 for name, value in tree[key].items()}
           for key in ("model", "average_model") if tree.get(key) is not None}
    if not out:
        raise SystemExit(f"no model/average_model in the checkpoint at {run_dir!r}")
    torch.save(out, output)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir", help="a port run, manager or step directory, or a state.pt")
    ap.add_argument("output", help="the .pt to write")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv)
    for key, state in export(args.run_dir, args.output, args.step).items():
        print(f"exported {key}: {len(state)} tensors")
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
