#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--variant program|control|faults]

For each seed, in this one process: the cell's set-up, a window of one
whole call (`--seconds`, default 0: the window ends after its first call),
and the check against the reference, as `benchmark/run.py` makes them.
`--variant control` runs the cell with the traffic keys of its limits
file's `control` (the program's own lower-precision path switched on);
`--variant faults` runs it once for each of the limits file's `faults`,
planted in the program (`benchmark/faults.py`): the checks that have to
fail. One JSON line a run: the numbers compared and the seconds it took.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import common, faults, run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program", choices=("program", "control", "faults"))
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    spec = common.spec()
    work, cfg, traffic = common.cell(args.workload)
    with open(common.ROOT / "limits" / f"{args.workload}.json") as f:
        table = json.load(f)
    if args.variant == "control":
        traffic = dict(traffic, **table["control"]["traffic"])
    planted = table["faults"] if args.variant == "faults" else [None]
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in planted:
            t0 = time.perf_counter()
            with faults.planted(fault) if fault else contextlib.nullcontext():
                res = run.measure(spec, work, cfg, traffic, common.limits(args.workload), seed,
                                  args.seconds, False)
            print(json.dumps({"workload": args.workload, "variant": fault or args.variant,
                              "seed": seed, "correct": res["correct"],
                              "numbers": {k: v["value"] for k, v in res["compared"].items()},
                              "seconds": time.perf_counter() - t0,
                              "metrics": {k: v["value"] for k, v in res["metrics"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
