"""Each cell's control at the CPU's size, the program's own lower-precision
path switched on, fails at least one of the cell's limits, where the
program passes them (`test_bench_run.py`, which plants the faults). The
control and the faults that each limits file lists were read on the card
at each cell's own size, on three seeds or more (PERF.md)."""

from __future__ import annotations

import json

import pytest

from benchmark import common
from benchmark.tests.test_bench_run import measure

CELLS = [w["name"] for w in common.spec()["workloads"]]


def table(workload):
    return json.loads((common.ROOT / "limits" / f"{workload}.json").read_text())


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload):
    res = measure(workload, traffic_update=table(workload)["control"]["traffic"])
    assert res["correct"] is False, res["compared"]

