"""The port's encoder-reuse A/B (`ccdm_tpu_torch/tools/encoder_reuse_ab.py`)
against the JAX package's `scripts/encoder_reuse_ab.py`, and at the gate's
tiny CPU size (`tools/demo_gate.py`'s `DEMO_TINY`: base 8, T 3, fp32, 2 test
images of the synthetic set, here at 32x32) against the harness itself.

Against the JAX script: with the harness of each package replaced by the
same stub (results a function of the mode and R), both tools run over R =
1, 2, 3 and their JSON rows are equal key for key and in order, their
`[er-ab]` lines equal up to the port's gate column, and the stub sees the
same evaluation parameters from both; the gate column is the JAX package's
ship rule (`scripts/demo_gate.py`'s `FULL_GATES`, GED at most its bound, the
others at least). Against the harness: each row equals
`eval_lidc_uncertainty` called directly with that mode and R (exact: the
same deterministic CPU run)."""

import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import ccdm_tpu_torch
import ccdm_tpu_torch.data.synthetic as syn
from ccdm_tpu_torch import DEMO_EVAL_PARAMS, DEMO_TRAIN_PARAMS
from ccdm_tpu_torch.tools import demo_gate
from ccdm_tpu_torch.tools import encoder_reuse_ab as ab

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = {"unet_openai": demo_gate.TINY_UNET, "time_steps": 3, "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def tiny_eval_params(tmp_path_factory):
    from ccdm_tpu_torch.train.trainer import run_train

    root = tmp_path_factory.mktemp("ab")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(syn, "training_dataset",
                   lambda: syn.synthetic_training_dataset(n=4, resolution=32))
        run_train(dict(DEMO_TRAIN_PARAMS, **TINY, output_path=str(root / "run"), batch_size=2,
                       validation_freq=10 ** 6, save_freq=10 ** 6), max_steps=1, device="cpu")
    return dict(DEMO_EVAL_PARAMS, **TINY, dataset_val_max_size=2, load_from=str(root / "run"),
                output_path=str(root / "eval"), evaluation_path=str(root / "eval"))


@pytest.fixture(autouse=True)
def small_test_set(monkeypatch):
    monkeypatch.setattr(syn, "test_dataset", lambda max_size=2, indices=None:
                        syn.synthetic_test_dataset(n=2, resolution=32))


def test_rows_equal_the_harness_called_directly(tiny_eval_params):
    from ccdm_tpu_torch.eval.lidc_uncertainty import eval_lidc_uncertainty

    got = list(ab.ab_rows(tiny_eval_params, [1, 3], device="cpu"))
    assert [(row["mode"], row["R"]) for row, _ in got] == [
        ("float", 1), ("float", 3), ("int8-static", 1), ("int8-static", 3)]
    for row, res in got:
        extra = {"quantized_inference": "static"} if row["mode"] == "int8-static" else {}
        ref = eval_lidc_uncertainty(dict(tiny_eval_params, encoder_reuse=row["R"], **extra),
                                    device="cpu")
        assert list(row) == ["mode", "R", "GED_4", "GED_16", "HMIoU_4", "HMIoU_16", "mIoU",
                             "dice_nodule", "passes_gates"]
        for key in ab.KEYS:
            assert row[key] == float(ref[key]) == res[key], (row["mode"], row["R"], key)
        assert row["dice_nodule"] == float(ref["Dice"][1])
        assert row["passes_gates"] == all(demo_gate.passes(k, row[k], bound)
                                          for k, bound in demo_gate.FULL_GATES.items())
        assert (res["calibration_seconds"] > 0) == (row["mode"] == "int8-static")


def test_the_cli_prints_and_writes_the_table(tiny_eval_params, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ccdm_tpu_torch, "DEMO_EVAL_PARAMS", tiny_eval_params)
    monkeypatch.setenv("ER_LEVELS", "2")
    monkeypatch.setenv("ER_CKPT", tiny_eval_params["load_from"])
    monkeypatch.setenv("ER_OUT", str(tmp_path / "ab.json"))
    assert ab.main(["--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[er-ab]")]
    rows = json.loads((tmp_path / "ab.json").read_text())
    assert [(r["mode"], r["R"]) for r in rows] == [("float", 2), ("int8-static", 2)]
    assert lines[:2] == [ab.format_row(r) for r in rows]
    assert lines[0].startswith("[er-ab] float       R=2 GED_4=") and "gates=" in lines[0]
    assert lines[-1] == f"[er-ab] table -> {tmp_path / 'ab.json'}"


def _stub_results(params) -> dict:
    """What the stub harness returns for an evaluation: a function of its
    mode and R alone, GED_16 across the gate's bound as R grows."""
    r = int(params["encoder_reuse"])
    static = str(params.get("quantized_inference", "")).lower() == "static"
    rng = np.random.default_rng(10 * r + static)
    res = {f"GED_{s}": float(rng.uniform(0.1, 0.3)) for s in (1, 4, 8)}
    res.update({f"HMIoU_{s}": float(rng.uniform(0.6, 0.9)) for s in (1, 4, 8, 16)})
    res.update(GED_16=0.12 + 0.02 * r, mIoU=float(rng.uniform(0.5, 0.9)),
               Dice=np.array([0.99, 0.78 + 0.02 * r + 0.01 * static]), samples_per_sec=1.0)
    return res


def test_rows_equal_the_jax_scripts(tmp_path, monkeypatch, capsys):
    import ccdm_tpu.eval.lidc_uncertainty as jax_harness
    import ccdm_tpu_torch.eval.lidc_uncertainty as port_harness

    seen = {"jax": [], "port": []}

    def stub(side):
        def eval_lidc_uncertainty(params, *args, **kwargs):
            seen[side].append(dict(params))
            return _stub_results(params)
        return eval_lidc_uncertainty

    monkeypatch.setattr(jax_harness, "eval_lidc_uncertainty", stub("jax"))
    monkeypatch.setattr(port_harness, "eval_lidc_uncertainty", stub("port"))
    monkeypatch.setenv("ER_LEVELS", "1,2,3")
    monkeypatch.setenv("ER_CKPT", str(tmp_path / "run"))
    monkeypatch.setenv("ER_OUT", str(tmp_path / "jax.json"))
    assert runpy.run_path(str(REPO / "scripts" / "encoder_reuse_ab.py"))["main"]() == 0
    jax_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setenv("ER_OUT", str(tmp_path / "port.json"))
    assert ab.main(["--device", "cpu"]) == 0
    port_lines = capsys.readouterr().out.splitlines()

    jax_rows = json.loads((tmp_path / "jax.json").read_text())
    port_rows = json.loads((tmp_path / "port.json").read_text())
    assert len(port_rows) == 6
    assert [list(r) for r in port_rows] == [[*r, "passes_gates"] for r in jax_rows]
    assert [{k: v for k, v in r.items() if k != "passes_gates"} for r in port_rows] == jax_rows
    gates = runpy.run_path(str(REPO / "scripts" / "demo_gate.py"))["FULL_GATES"]
    assert demo_gate.FULL_GATES == gates
    for row in port_rows:
        ship = all(row[k] <= bound if k.startswith("GED") else row[k] >= bound
                   for k, bound in gates.items())
        assert row["passes_gates"] == ship, row
    assert {r["passes_gates"] for r in port_rows} == {True, False}
    assert [line.rsplit(" gates=", 1)[0] for line in port_lines[:-1]] == jax_lines[:-1]
    assert jax_lines[-1] == f"[er-ab] table -> {tmp_path / 'jax.json'}"
    assert port_lines[-1] == f"[er-ab] table -> {tmp_path / 'port.json'}"

    # the same evaluations asked for, on the JAX YAML's parameters
    with open(REPO / "configs" / "params_demo_eval.yml") as f:
        keys = set(yaml.safe_load(f)) - {"output_path", "evaluation_path"}
    keys |= {"encoder_reuse", "quantized_inference", "load_from"}
    assert len(seen["jax"]) == len(seen["port"]) == 6
    for j, p in zip(seen["jax"], seen["port"]):
        assert {k: j.get(k) for k in keys} == {k: p.get(k) for k in keys}
