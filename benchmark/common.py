"""What every cell of the benchmark shares: its entries in `BENCHMARK.json`
and their files, the seeds, the device's identity, the check that no JAX
module was loaded, and the reading of a profiler trace into device
intervals."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

ROOT = Path(__file__).resolve().parent          # benchmark/
REPO = ROOT.parent
# top-level module names that must not be loaded: the JAX stack and the JAX
# package the program was ported from (compared whole: the program's own
# name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ccdm_tpu")


def spec() -> Dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str) -> Tuple[Dict, Dict, Dict]:
    """`(workload entry, configuration dict, traffic dict)` of cell `name`."""
    s = spec()
    work = next((w for w in s["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in s["configs"] if c["name"] == work["config"])
    with open(REPO / conf["file"]) as f:
        cfg = json.load(f)
    with open(ROOT / "traffic" / f"{work['traffic']}.json") as f:
        traffic = json.load(f)
    return work, cfg, traffic


def limits(workload: str) -> Dict[str, float]:
    """The limit of each number that decides `correct` in `workload`."""
    with open(ROOT / "limits" / f"{workload}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def load_file(path: Path, name: str):
    """Import the module at `path` (a metric reader's name holds dots)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed from the run's seed and `parts` (a call's index, a
    role), the same on every machine."""
    text = ":".join(str(p) for p in (int(seed), *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is in `FORBIDDEN`."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(torch, chips: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


class Trace(NamedTuple):
    """A traced window: the device's operations as `(name, start_s, end_s)`
    from the start of the window, the host's operations likewise, the
    window's length, and what the cell ran in it (`steps`, `calls` and the
    cell's cost of one call or step)."""
    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    work: Dict


WINDOW = "benchmark_window"  # the host span that marks the traced window


def read_profile(prof, torch, work: Dict) -> Trace:
    """The device and host operations of a `torch.profiler` session, timed
    from the start of the `WINDOW` span and clipped to it."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    marks = [e for e in events if e.name() == WINDOW and e.device_type() != cuda]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} host {WINDOW!r} spans, not one")
    start, window_s = marks[0].start_ns(), marks[0].duration_ns() * 1e-9
    dev, host = [], []
    for e in events:
        if e.name() == WINDOW:  # the span itself, and its annotation on the device
            continue
        t0 = (e.start_ns() - start) * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        if t1 <= 0 or t0 >= window_s:
            continue
        item = (e.name(), max(t0, 0.0), min(t1, window_s))
        (dev if e.device_type() == cuda else host).append(item)
    return Trace(sorted(dev, key=lambda x: x[1]), host, window_s, work)


def busy_intervals(ops: List[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, in order."""
    out: List[List[float]] = []
    for _, a, b in sorted(ops, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace.device_ops))


def family_s(trace: Trace, keys) -> Optional[float]:
    """Seconds of the device operations whose name holds one of `keys`;
    None where there is none."""
    spans = [b - a for name, a, b in trace.device_ops if any(k in name for k in keys)]
    return sum(spans) if spans else None


def breakdown(trace: Trace, top: int = 10) -> Dict:
    """The device operations that took most time, by name, and the longest
    idle gaps of the device, each named by the host operation that was
    running at its middle (the shortest one that covers it)."""
    by_name: Dict[str, float] = {}
    for name, a, b in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace.device_ops)
    gaps = [(0.0, busy[0][0])] if busy else []
    gaps += [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
    if busy:
        gaps.append((busy[-1][1], trace.window_s))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        cover = [(e - s, n) for n, s, e in trace.host_ops if s <= mid <= e]
        named.append([min(cover)[1] if cover else "no host operation", b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
