"""The readers of the program's spans: `call_host_ms.*` on synthetic
traces, and on a traced run of each cell on the CPU, where no operation
ran on a device and every reader of a device trace reads nothing."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import common, run
from benchmark.tests import tiny
from benchmark.tests.test_bench_run import SAMPLING, SEED

READERS = ["call_host_ms.sample", "call_host_ms.eval"]


def read(name: str, trace):
    mod = common.load_file(common.ROOT / "metrics" / f"{name}.py",
                           "metric_" + name.replace(".", "_"))
    return mod.read(SimpleNamespace(trace=trace))


def _trace(host_ops, device_ops=(("kernel", 0.0, 1.0),)):
    return common.Trace(list(device_ops), list(host_ops), 10.0, {"kind": "sample"})


@pytest.mark.parametrize("name", READERS)
def test_call_host_ms_is_each_call_outside_its_steps(name):
    host = [("sampler.call", 0.0, 2.0), ("sampler.conditioning", 0.1, 0.3),
            ("sampler.steps", 0.5, 1.9), ("aten::add", 0.6, 0.7),
            ("sampler.call", 3.0, 4.0), ("sampler.capture", 3.1, 3.3),
            ("sampler.steps", 3.4, 3.9), ("sampler.steps", 5.0, 6.0)]  # outside every call
    # (2.0 - 1.4) and (1.0 - 0.2 - 0.5), in ms, over two calls
    assert read(name, _trace(host)) == pytest.approx((0.6 + 0.3) / 2 * 1e3)


@pytest.mark.parametrize("name", READERS)
def test_call_host_ms_reads_nothing_without_spans_or_device_work(name):
    assert read(name, None) is None
    assert read(name, _trace([("aten::add", 0.0, 1.0)])) is None  # a program without spans
    assert read(name, _trace([("sampler.call", 0.0, 1.0)], device_ops=())) is None


@pytest.mark.parametrize("workload", SAMPLING)
def test_a_traced_cpu_run_reports_no_device_metric(workload):
    work, cfg, traffic = tiny.cut(workload)
    res = run.measure(common.spec(), work, cfg, traffic, common.limits(workload), SEED, 0.0,
                      True, device="cpu")
    assert res["correct"] is True and res["metrics"] == {}
