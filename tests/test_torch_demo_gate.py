"""The port's LIDC quality gate (`ccdm_tpu_torch/tools/demo_gate.py`) and the
eval configs it and the fast LIDC evaluation read: the copies equal their
YAML, the gates equal `scripts/demo_gate.py`'s, and a tiny gate run on the
CPU trains, evaluates all three modes (float, calibrated static int8, static
int8 with encoder reuse 2) and exits 1 on the gates it misses."""

import json
import sys
from pathlib import Path

import pytest

from ccdm_tpu_torch.tools import demo_gate as gate

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))


def test_eval_param_copies_match_the_yaml():
    from ccdm_tpu.config import load_params
    from ccdm_tpu_torch import DEMO_EVAL_PARAMS, EVAL_LIDC_FAST_PARAMS

    assert DEMO_EVAL_PARAMS == load_params(str(REPO / "configs/params_demo_eval.yml"))
    assert EVAL_LIDC_FAST_PARAMS == load_params(str(REPO / "configs/params_eval_lidc_fast.yml"))
    assert EVAL_LIDC_FAST_PARAMS["quantized_inference"] == "static"
    assert EVAL_LIDC_FAST_PARAMS["encoder_reuse"] == 2


def test_gates_and_modes_equal_the_original():
    import demo_gate as original

    assert gate.FULL_GATES == original.FULL_GATES
    assert gate.SHORT_GATES == original.SHORT_GATES
    assert [m for m, _ in gate.MODES] == ["float", "int8-static", "int8+er2"]
    # GED gates from above, the others from below, bounds included
    ok = {"GED_16": 0.16, "HMIoU_16": 0.69, "dice_nodule": 0.80}
    assert gate.gate_failures("float", ok, gate.FULL_GATES, 0) == []
    worse = {"GED_16": 0.1601, "HMIoU_16": 0.6899, "dice_nodule": 0.7999}
    assert gate.gate_failures("int8+er2", worse, gate.FULL_GATES, 3) == [
        "int8+er2:GED_16@seed3", "int8+er2:HMIoU_16@seed3", "int8+er2:dice_nodule@seed3"]


def test_tiny_gate_run_evaluates_three_modes_and_exits_1(tmp_path, monkeypatch, capsys):
    """Two training steps leave a model that misses every gate: the run
    goes through all three modes, writes demo_gate.json and exits 1."""
    monkeypatch.setenv("DEMO_CPU", "1")
    monkeypatch.setenv("DEMO_TINY", "1")
    monkeypatch.setenv("DEMO_STEPS", "2")
    monkeypatch.setenv("DEMO_GATE_ROOT", str(tmp_path))
    stale = tmp_path / "s0" / "run" / "model" / "9999"
    stale.mkdir(parents=True)  # a leftover run: removed before training
    assert gate.main() == 1
    out = capsys.readouterr().out
    assert "QUALITY REGRESSION" in out
    summary = json.loads((tmp_path / "s0" / "run" / "demo_gate.json").read_text())
    assert summary["steps"] == 2 and summary["gates"] == gate.SHORT_GATES
    assert summary["device"] == "cpu" and not stale.exists()
    for mode, _ in gate.MODES:
        assert 0 <= summary[mode]["GED_16"] <= 2 and 0 <= summary[mode]["HMIoU_16"] <= 1
        assert summary[mode]["samples_per_sec"] > 0
        # the int8 modes calibrate their static scales first
        assert (summary[mode]["calibration_seconds"] > 0) == (mode != "float")
    assert summary["failures"] and all(f.endswith("@seed0") for f in summary["failures"])


@pytest.mark.parametrize("failures,rc", [([], 0), (["int8-static:GED_16@seed1"], 1)])
def test_the_verdict_over_seeds(monkeypatch, capsys, failures, rc):
    def fake_run(seed, steps, gates):
        assert steps == 800 and gates == gate.SHORT_GATES
        metrics = {"GED_16": 0.2 + seed / 100, "HMIoU_16": 0.6, "dice_nodule": 0.75}
        return {"failures": failures if seed == 1 else [],
                **{mode: metrics for mode, _ in gate.MODES}}

    monkeypatch.setattr(gate, "run_one_seed", fake_run)
    monkeypatch.setenv("DEMO_STEPS", "800")
    monkeypatch.setenv("DEMO_SEEDS", "0,1")
    assert gate.main() == rc
    out = capsys.readouterr().out
    assert "int8+er2    GED_16       mean=0.2050 min=0.2000 max=0.2100" in out
    assert ("all quality gates passed" in out) == (rc == 0)
