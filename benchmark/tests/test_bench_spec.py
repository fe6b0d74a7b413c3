"""BENCHMARK.json and the files it names hold together: the keys and limits
of its entries, names and units, the files of each configuration, cell and
per-layer metric, and what every cell reports."""

import dataclasses
import json
import re

import pytest

from harness.spec import BENCH_DIR, ROOT, Cell, load_metric

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells, at 14 runs a cell, fits in 12 hours
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries(spec, group):
    names = [e["name"] for e in spec[group]]
    assert len(names) == len(set(names))
    for e in spec[group]:
        extra = ({"workloads"} if group in ("end_to_end", "per_layer")
                 else set())
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_bounds(spec):
    bounds = {m["name"]: m["bound"] for m in spec["end_to_end"]}
    assert bounds["setup_s"] == 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in spec["end_to_end"])


def test_configurations(spec):
    from doa_tpu_torch.configs import DoaConfig
    fields = {f.name for f in dataclasses.fields(DoaConfig)} - {"overlap"}
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert set(data["doa_config"]) == fields
        assert (BENCH_DIR / "reference" / f"{data['reference']}.py").exists()
        assert c["source"].startswith("https://")


def test_cells(spec):
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(spec["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        cell = Cell(spec, w["name"])
        assert cell.traffic["config"] == w["config"]
        assert cell.traffic["why"] == w["why"] and len(w["why"]) <= 200
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert set(cell.traffic["check"]["limits"]) == {"angle_gap_deg",
                                                        "value_gap"}


def test_per_layer_metric_files(spec):
    layers = {}
    for m in spec["per_layer"]:
        mod = load_metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                    m["moves"])
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and hasattr(mod, "work")
            assert all(":" in e for e in mod.ENTRIES)
        for cell in m.get("workloads", ()):
            assert cell in {w["name"] for w in spec["workloads"]}
    assert {"entry", "device", "covariance", "subspace", "scan"} <= set(
        layers)
