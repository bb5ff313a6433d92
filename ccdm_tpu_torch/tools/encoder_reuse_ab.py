#!/usr/bin/env python3
"""Encoder-reuse quality A/B: one checkpoint evaluated under the LIDC
gate's protocol at encoder reuse R in `ER_LEVELS`, in float and on
calibrated static int8 scales, one table row per (mode, R). The port's
counterpart of `scripts/encoder_reuse_ab.py`.

    python3 -m ccdm_tpu_torch.tools.encoder_reuse_ab              # R = 1,2,3, float + int8
    ER_LEVELS=1,2,3,4 ER_CKPT=build/demo_gate/s0/run python3 -m ccdm_tpu_torch.tools.encoder_reuse_ab
    python3 -m ccdm_tpu_torch.tools.encoder_reuse_ab --device cpu

Each row is `eval_lidc_uncertainty` on `DEMO_EVAL_PARAMS`
(`configs/params_demo_eval.yml`: the flagship width, base 32 at 128x128,
T = 250, 16 synthetic test images at batch 2 x 16 samples) with
`encoder_reuse: R` (and `quantized_inference: static` in the int8 mode),
loading `ER_CKPT` (default `build/demo_gate/s0/run`, the gate's
checkpoint). It prints one `[er-ab]` line a row and writes the rows to
`ER_OUT` (default `build/encoder_reuse_ab.json`; each evaluation's own
results JSON goes into the directory of that name without `.json`): `mode,
R, GED_4, GED_16, HMIoU_4, HMIoU_16, mIoU, dice_nodule`, and
`passes_gates`, whether the row passes `tools/demo_gate.py`'s pinned
5000-step gates (`FULL_GATES`). The
ship rule, as the JAX script's: a reuse level may become an eval config's
default only where every row at that level passes the gates R = 1 passes
on the same checkpoint. Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MODES = (("float", {}), ("int8-static", {"quantized_inference": "static"}))
KEYS = ("GED_4", "GED_16", "HMIoU_4", "HMIoU_16", "mIoU")


def ab_rows(eval_params: dict, levels, num_steps=None, device=None):
    """Yield `(row, results)` for each mode and each R in `levels`, in the
    JAX script's order; each evaluation runs when its row is asked for."""
    from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty
    from ccdm_tpu_torch.tools.demo_gate import FULL_GATES, passes

    for mode, extra in MODES:
        for r in levels:
            res = eval_lidc_uncertainty(dict(eval_params, encoder_reuse=r, **extra), num_steps,
                                        device=device)
            row = {"mode": mode, "R": r, **{k: float(res[k]) for k in KEYS},
                   "dice_nodule": float(res["Dice"][1])}
            row["passes_gates"] = all(passes(k, row[k], bound) for k, bound in FULL_GATES.items())
            yield row, res


def format_row(row: dict) -> str:
    return (f"[er-ab] {row['mode']:<11s} R={row['R']} "
            + " ".join(f"{k}={row[k]:.4f}" for k in (*KEYS, "dice_nodule"))
            + f" gates={'pass' if row['passes_gates'] else 'FAIL'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from ccdm_tpu_torch import DEMO_EVAL_PARAMS

    levels = [int(x) for x in os.environ.get("ER_LEVELS", "1,2,3").split(",")]
    out = Path(os.environ.get("ER_OUT", REPO / "build" / "encoder_reuse_ab.json"))
    eval_dir = str(out.with_suffix(""))  # each evaluation's results JSON, beside the table
    eval_params = dict(DEMO_EVAL_PARAMS, output_path=eval_dir, evaluation_path=eval_dir,
                       load_from=os.environ.get("ER_CKPT",
                                                str(REPO / "build" / "demo_gate" / "s0" / "run")))
    rows = []
    for row, _ in ab_rows(eval_params, levels, device=args.device):
        rows.append(row)
        print(format_row(row), flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=2))
    print(f"[er-ab] table -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
