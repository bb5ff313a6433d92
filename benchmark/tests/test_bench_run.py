"""A run of each cell on the CPU at the tiny size, with the look for a card
skipped: the result's keys, no module of the JAX stack loaded, and
`correct` false under each fault that the cell can have, planted in the
program underneath the run."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from benchmark import common, faults, run
from benchmark.drivers import sampling
from benchmark.tests import tiny

SAMPLING = [w["name"] for w in common.spec()["workloads"]]
SEED = 2 ** 31 + 101


def measure(workload: str, seed: int = SEED, traffic_update=None, time_steps: int = 20):
    work, cfg, traffic = tiny.cut(workload, time_steps=time_steps)
    traffic.update(traffic_update or {})
    return run.measure(common.spec(), work, cfg, traffic, common.limits(workload), seed, 0.0,
                       False, device="cpu")


@pytest.mark.parametrize("workload", SAMPLING)
def test_result_keys_and_correct(workload):
    res = measure(workload)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert res["correct"] is True, res["compared"]
    assert set(res["compared"]) == set(common.limits(workload))
    names = {m["name"] for m in run.metric_names(common.spec(), {"name": workload}, False)}
    assert set(res["metrics"]) == names
    json.dumps(res)


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["ccdm_tpu_torch_fake.sub"] = sys.modules["json"]
        assert "ccdm_tpu" not in common.forbidden_modules()
        sys.modules["ccdm_tpu.fake"] = sys.modules["json"]
        assert "ccdm_tpu" in common.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(common.REPO)!r})
        from benchmark.tests import test_bench_run as t
        from benchmark import common
        for w in t.SAMPLING:
            t.measure(w)
        print(common.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=common.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", SAMPLING)
def test_sampling_faults_come_out_not_correct(workload, fault):
    # a posterior read one step off moves the chain's end by about as much
    # as bf16's rounding does over 20 steps, and more only over the cells'
    # own 250
    steps = 250 if fault == "posterior_late" else 20
    with faults.planted(fault):
        assert measure(workload, time_steps=steps)["correct"] is False


def test_check_picks_cover_every_part_of_the_batch():
    """At the cells' own sizes: LIDC's 32 picks among 5 calls of 128 chains
    fall 4 to each eighth of the rows, Cityscapes' 2 among 8 calls of 2
    take both rows; the same seed picks the same chains."""
    picks = sampling.check_picks(7, 5, 128, 32)
    assert len(set(picks)) == 32 and all(0 <= p < 5 * 128 for p in picks)
    assert [sum(p % 128 // 16 == k for p in picks) for k in range(8)] == [4] * 8
    for seed in range(20):
        assert sorted(p % 2 for p in sampling.check_picks(seed, 8, 2, 2)) == [0, 1]
    assert sampling.check_picks(9, 3, 4, 12) == sorted(range(12))
    assert sampling.check_picks(7, 5, 128, 32) == picks
