"""The port's Cityscapes quality gate (`ccdm_tpu_torch/tools/cityscapes_gate.py`):
its learnable tree equals the JAX script's pixel for pixel, and a tiny run
(train -> `run_inference` -> official scoring) passes end to end on the CPU,
as `tests/test_cityscapes_gate.py` runs the original."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from ccdm_tpu_torch.tools import cityscapes_gate as gate
from ccdm_tpu_torch.utils.png import read_png

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))


def test_learnable_tree_equals_the_original(tmp_path):
    from cityscapes_gate import LEARNABLE_IDS, make_learnable_tree

    assert gate.LEARNABLE_IDS == LEARNABLE_IDS
    ours = Path(gate.make_learnable_tree(str(tmp_path / "ours"), n_train=2, n_val=1,
                                         size=(32, 64), seed=3))
    ref = Path(make_learnable_tree(str(tmp_path / "ref"), n_train=2, n_val=1, size=(32, 64),
                                   seed=3))
    files = sorted(p.relative_to(ref) for p in ref.rglob("*.png"))
    assert len(files) == 6
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*.png"))
    for rel in files:
        np.testing.assert_array_equal(read_png(ours / rel), read_png(ref / rel), err_msg=str(rel))


def test_gate_end_to_end_tiny(tmp_path):
    env = dict(os.environ, CS_CPU="1", CS_TINY="1", CS_STEPS="2", CS_GATE_MIOU="0.0",
               CS_GATE_ROOT=str(tmp_path / "gate"))
    proc = subprocess.run([sys.executable, str(REPO / "ccdm_tpu_torch/tools/cityscapes_gate.py")],
                          env=env, capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "cityscapes quality gate passed" in proc.stdout
    summary = json.loads((tmp_path / "gate" / "cityscapes_gate.json").read_text())
    assert summary["steps"] == 2 and summary["device"] == "cpu"
    assert 0 <= summary["mIoU_official"] <= 1
    assert (tmp_path / "gate" / "run" / "model" / "2" / "state.pt").is_file()
