#!/usr/bin/env python3
"""The benchmark of `ccdm_tpu_torch` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` in this process: builds the program and
its inputs from the seed, warms up every shape the cell uses (set-up), then
measures for `--seconds`: whole calls of the cell's entry point, back to
back. `--trace 0` reports the cell's end-to-end metrics; `--trace 1` runs
`trace_calls` calls under `torch.profiler` instead and reports its
per-layer metrics, with the device's busy time and a breakdown. Either way
the program's state is then freed and the plain reference
(`benchmark/reference/`) follows a sample of what the window produced; the
numbers compared, each beside its limit (`benchmark/limits/<cell>.json`),
are the last lines on standard error and the last key of the result.

Everything a cell is made of is found by name: the configuration file
that `BENCHMARK.json` names, `traffic/<mix>.json` and the driver it names
(`drivers/<driver>.py`), one reader a metric (`metrics/<metric>.py`), and
the limits. The last line on standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace


def _process_start() -> float:
    """When this process started, on the wall clock (Linux's /proc; the
    time of this module's import elsewhere)."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now


START = _process_start()
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
# the kernel and compiler caches stay at fixed paths inside the checkout
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(REPO / "build" / _dir)

from benchmark import common  # noqa: E402


def fail(msg: str, code: int = 3):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def metric_names(spec, work, trace: bool):
    """The metrics this cell reports in a run of this kind: its end-to-end
    metrics, or the per-layer metrics that list it (or, listing no cells,
    move one of its end-to-end metrics)."""
    name = work["name"]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(cell, seconds: float, torch):
    """Whole calls until `seconds` have passed: `(units, seconds, calls)`,
    the time from the window's start to the last call's end. Each call's
    seconds go to standard error."""
    sync(torch, cell.device)
    units, ends = 0, []
    t0 = time.perf_counter()
    while not ends or ends[-1] < seconds:
        units += cell.call(len(ends))
        ends.append(time.perf_counter() - t0)
    print("window: calls of " + " ".join(f"{b - a:.4f}" for a, b in zip([0.0] + ends, ends))
          + " s", file=sys.stderr)
    return units, ends[-1], len(ends)


def traced(cell, torch):
    """`trace_calls` calls under the profiler, inside the window's span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ccdm_tpu_torch.ops import flash_attention

    n = int(cell.traffic["trace_calls"])
    sync(torch, cell.device)
    units, launched = 0, flash_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(common.WINDOW):
            for i in range(n):
                units += cell.call(i)
            sync(torch, cell.device)
    work = {"calls": n, "units": units, "steps": n * cell.steps_per_call, "cost": cell.cost(),
            "kind": cell.kind}
    trace = common.read_profile(prof, torch, work)
    # the attention kernel's records against its wrapper's launch count: a
    # trace that dropped records would read fewer
    kept = sum(1 for name, _, _ in trace.device_ops if "attn_fwd" in name)
    print(f"trace: {len(trace.device_ops)} device records, {kept} of "
          f"{flash_attention.launches - launched} attention launches", file=sys.stderr)
    return trace


def measure(spec, work, cfg, traffic, limits, seed: int, seconds: float, trace: bool,
            device="cuda:0"):
    """Set-up, the window (or the traced calls), the metrics, the check:
    the result dict, and the numbers compared beside their limits under
    its last key. The caller has looked for the card."""
    import importlib

    import torch

    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    cell = driver.Cell(cfg, traffic, seed, torch.device(device))
    cell.warm()
    sync(torch, cell.device)
    run = SimpleNamespace(kind=cell.kind, unit=cell.unit, setup_s=time.time() - START,
                          trace=None, units=0, window_s=0.0, calls=0)
    if trace:
        run.trace = traced(cell, torch)
        busy = common.busy_s(run.trace)
    else:
        run.units, run.window_s, run.calls = window(cell, seconds, torch)
    cuda = cell.device.type == "cuda"
    run.peak_bytes = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    result_device = (common.device_info(torch, int(work["chips"])) if cuda else
                     {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    loaded = common.forbidden_modules()
    if loaded:
        fail(f"modules of the JAX stack or package were loaded: {loaded}", 4)

    metrics = {}
    for m in metric_names(spec, work, trace):
        value = common.load_file(common.ROOT / "metrics" / f"{m['name']}.py",
                                 "metric_" + m["name"].replace(".", "_")).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    cell.free()
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            numbers = cell.check(cell.reference())
            check_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result = {"correct": all(v["value"] <= v["limit"] for v in compared.values()),
              "attempted": run.calls or run.trace.work["calls"], "failed": 0,
              "metrics": metrics, "device": result_device}
    if trace:
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = common.breakdown(run.trace)
    result["compared"] = compared
    print(f"card: {common.power_limit() if cuda else 'none'}; the reference's check took "
          f"{check_s:.1f} s", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        fail(f"--seed must be a whole number >= 0, got {args.seed}", 2)
    spec = common.spec()
    work, cfg, traffic = common.cell(args.workload)
    limits = common.limits(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(work["chips"]):
        fail(f"the cell needs {work['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    result = measure(spec, work, cfg, traffic, limits, args.seed, args.seconds,
                     bool(args.trace))
    for k, v in result["compared"].items():
        print(f"compared {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
