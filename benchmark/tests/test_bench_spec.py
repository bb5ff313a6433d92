"""`BENCHMARK.json` against the benchmark's contract: every cell and metric
resolves to its files, names and units use only the allowed characters,
and each entry has just its keys."""

from __future__ import annotations

import json
import re

from benchmark import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = common.spec()


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((common.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and SPEC["paths"] == ["benchmark"]
    assert len(SPEC["command"]) <= 32 and SPEC["command"][1] == "benchmark/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60,
    # two compiles a cell, 1200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_text():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + [c["source"] for c in SPEC["configs"]] + SPEC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_resolves_to_its_files():
    for w in SPEC["workloads"]:
        work, cfg, traffic = common.cell(w["name"])
        assert (common.ROOT / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads((common.ROOT / "limits" / f"{w['name']}.json").read_text())
        assert limits["limits"] and all(v > 0 for v in limits["limits"].values())
        assert cfg["reduced"] == [] and "source" in cfg
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/") and (common.REPO / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_every_metric_resolves_and_each_cell_reports_enough():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (common.ROOT / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and SPEC["end_to_end"][-1]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= e2e[m["moves"]]
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert sum(cell in ws for n, ws in e2e.items() if n != "setup_s") >= 1
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
